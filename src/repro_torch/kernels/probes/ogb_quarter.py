"""A quarter of the ogb_products cell (its nodes and edges / 4, every width
kept) through ``chip_smoke.check_ogb_products`` on four logical shards of
one card: the step, the memory and the forward's edge and node sides that
one card of the four-card 1 x 4 run carries, roughly, with one thread
driving one card.

This is a measurement, not part of the port. It prints what phase 27 prints
for ogb_products (ms a step, nodes/s, peak GB, a profiled step, the forward
split, the restart and rerun bits) with the card's name and power limit.
Run it from the root of the repository:

    python3 src/repro_torch/kernels/probes/ogb_quarter.py
"""
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402


def main() -> None:
    real = C.get_arch
    spec = real("mace")
    dims = dict(spec.cell("ogb_products").dims)
    dims.update(n_nodes=dims["n_nodes"] // 4, n_edges=dims["n_edges"] // 4)
    spec = dataclasses.replace(spec, cells=tuple(
        dataclasses.replace(c, dims=dims) if c.shape == "ogb_products"
        else c for c in spec.cells))
    C.get_arch = steps_lib.C.get_arch = (
        lambda a: spec if a == "mace" else real(a))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cs.check_ogb_products(spec, [torch.device("cuda:0")], smi + (
        " (a quarter of the graph on four logical shards)"))


if __name__ == "__main__":
    main()
