"""Device time of the dense kernels (``pdist_sq``, ``zen_estimate``,
``jsd_pdist``) and of ``zen_topk`` at the shapes the port launches, for the
``repro_torch`` package under ``--src``: one checkout against another in a
single run on the card (an A/B of two versions of the kernels).

This is a measurement, not part of the port. Inputs are made on the card
from a seed: Gaussian rows for ``pdist_sq`` (f32 and bf16), Gaussian
coordinates with a non-negative last column for ``zen_estimate`` and
``zen_topk``, l1-normalised uniform rows for ``jsd_pdist``. Shapes:
``pdist_sq`` at the evaluation's delta (2,048^2 x 256, f32 and bf16) and
zeta (2,048^2 x 16), the evaluation square (4,096^2 x 256) and the
transform (1,000,000 x 16 x 256); ``jsd_pdist`` at 4,096^2 x 256;
``zen_estimate`` at (4,096 x 16)^2 and 64 x 1,000,000 x 16; ``zen_topk``
at the serving shape (Q = 64, N = 1,000,000, k = 16, n = 64, f32). Each
call is queued behind a spin kernel so that the host's launch gaps are left
out; one JSON line per shape with the card's name and power limit, and
the plan where the package has ``pdist_plan``.

    python3 src/repro_torch/kernels/probes/pdist_timing.py --src src
    python3 src/repro_torch/kernels/probes/pdist_timing.py --src OTHER/src \\
        --label parent

Run the two versions in turns in one call (A, B, B, A) to compare them.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from probe_timing import queued_ms  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory holding the repro_torch package")
    ap.add_argument("--label", default="this")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch.kernels import jsd as jk
    from repro_torch.kernels import zen as zk
    from repro_torch.kernels import zen_topk as zt

    pk = importlib.import_module("repro_torch.kernels.pdist")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def coords(n):
        x = normal(n, 16)
        x[:, -1].abs_()
        return x

    def probs(n):
        p = torch.rand((n, 256), generator=gen, device=dev)
        return p / p.sum(1, keepdim=True)

    rows = normal(1_000_000, 256)
    refs = normal(16, 256)
    a, b = normal(4_096, 256), normal(4_096, 256)
    z = coords(2 * 2_048)
    c = coords(1_000_000)
    p = probs(2 * 4_096)
    q = coords(64)
    shapes = [
        ("pdist_sq", "delta 2,048^2 x 256 f32", pk.pdist_sq,
         (a[:2_048], b[:2_048]), ()),
        ("pdist_sq", "zeta 2,048^2 x 16 f32", pk.pdist_sq,
         (z[:2_048], z[2_048:]), ()),
        ("pdist_sq", "square 4,096^2 x 256 f32", pk.pdist_sq, (a, b), ()),
        ("pdist_sq", "delta 2,048^2 x 256 bf16", pk.pdist_sq,
         (a[:2_048].bfloat16(), b[:2_048].bfloat16()), ()),
        ("pdist_sq", "transform 1,000,000 x 16 x 256 f32", pk.pdist_sq,
         (rows, refs), ()),
        ("jsd_pdist", "4,096^2 x 256", jk.jsd_pdist,
         (p[:4_096], p[4_096:]), ()),
        ("zen_estimate", "(4,096 x 16)^2", zk.zen_estimate,
         (c[:4_096], c[4_096:8_192]), ("zen",)),
        ("zen_estimate", "64 x 1,000,000 x 16", zk.zen_estimate, (q, c),
         ("zen",)),
        ("zen_topk", "Q = 64, N = 1,000,000, k = 16, n = 64 f32",
         zt.zen_topk, (q, c), (64, "zen")),
    ]
    for name, label, fn, (x, y), extra in shapes:
        iters = max(2, args.iters // 4) if name == "jsd_pdist" else args.iters
        ms = queued_ms(lambda: fn(x, y, *extra), iters)
        rec = {"label": args.label, "src": args.src, "kernel": name,
               "shape": label, "ms": ms, "card": smi}
        if name == "pdist_sq" and hasattr(pk, "pdist_plan"):
            plan = pk.pdist_plan(x.shape[0], y.shape[0], x.shape[1], x.dtype,
                                 pk.operands_aligned(x, y))
            rec["plan"] = f"{plan.kernel} {plan.tile} x{plan.grid}"
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
