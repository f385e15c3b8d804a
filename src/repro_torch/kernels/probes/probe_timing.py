"""Device time of ``ivf_probe`` and ``ivf_probe_pq`` at the serving shape
and around it, and the wrappers' host cost, for the ``repro_torch`` package
under ``--src``: one checkout against another in a single run on the card
(an A/B of two versions of the kernels).

This is a measurement, not part of the port. The index is built on the
card from a seed: 1,000,000 rows of k = 16 Gaussian coordinates (the
altitude column |.|) in 4,000 k-means clusters of 128-row tiles, stored
f32, bf16, int8 (per-cluster scales) and PQ (M = 4), and 64 Gaussian
queries probe their nearest clusters. Shapes: the serving shape (Q = 64,
nprobe 8, n = 64) in every storage, then f32 and PQ at n = 512 and 2,048
(list widths 512 and 2,048), at nprobe 64, and at Q = 2. Each call is
queued behind a spin kernel so that the host's launch gaps are left out;
one JSON line per shape with the card's name and power limit. Last, one
line of the host's cost per call at the serving shape (f32): the whole
call as the host issues it back to back, and the parts spent in the
wrapper's ``probe_plan``, its ``_outputs`` and the library's entry point
(the ctypes call and the launches), timed by wrapping each.

    python3 src/repro_torch/kernels/probes/probe_timing.py --src src
    python3 src/repro_torch/kernels/probes/probe_timing.py --src OTHER/src \
        --label parent

Run the two versions in turns in one call (A, B, B, A) to compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def queued_ms(fn, iters: int) -> float:
    """Mean device ms a call of ``fn``, the calls queued behind a spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2e3 * enqueue_s + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_split(ip, fn, iters: int = 400) -> dict:
    """Host microseconds a call of ``fn`` (an ivf_probe call) issued back to
    back, and the parts of it spent in ``ip.probe_plan``, ``ip._outputs``
    and the loaded library's functions."""
    import torch
    from repro_torch.kernels import _build

    spent = {"plan": 0.0, "outputs": 0.0, "library": 0.0}

    def timer(part, f):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                spent[part] += time.perf_counter() - t
        return wrapped

    class Lib:  # the library, each entry point timed
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return timer("library", getattr(self._lib, name))

    saved = {name: getattr(ip, name) for name in ("probe_plan", "_outputs")}
    load = _build.load
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    whole = time.perf_counter() - t
    torch.cuda.synchronize()
    try:
        ip.probe_plan = timer("plan", saved["probe_plan"])
        ip._outputs = timer("outputs", saved["_outputs"])
        _build.load = lambda name: Lib(load(name))
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(ip, name, f)
        _build.load = load
    out = {"whole_us": whole / iters * 1e6}
    out.update({f"{k}_us": v / iters * 1e6 for k, v in spent.items()})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory holding the repro_torch package")
    ap.add_argument("--label", default="this")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch.index import ivf
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import pq
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels.scoring import MODE_IDS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1_000_000, 16), generator=gen, device=dev)
    x[:, -1].abs_()
    q = torch.randn((64, 16), generator=gen, device=dev)
    q[:, -1].abs_()
    base = ivf.IVFZenIndex.build(x, 4_000, tile_rows=128, n_iters=5,
                                 generator=torch.Generator().manual_seed(0))
    C, T, k = base.n_clusters, base.tiles_per_cluster, base.dim
    packed = base.tile_coords.reshape(C, T * 128, k)
    index = {}
    for st in quant.SCALAR_STORAGE_DTYPES:
        values, scales = ivf._encode_packed(packed, st)
        index[st] = (values.reshape(C * T, 128, k), scales)
    pqi = ivf.IVFZenIndex.from_members(*base._live_members(), base.centroids,
                                       C, 128, storage="pq", pq_m=4)

    def call(st, nq, n, n_probe):
        qq = q[:nq]
        if st == "pq":
            probes = pqi.probe_clusters(qq, n_probe)
            luts = pq.build_luts(qq, pqi.centroids, pqi.codebooks, probes,
                                 MODE_IDS["zen"])
            return lambda: ip.ivf_probe_pq(
                pqi.tile_coords, pqi.tile_ids, probes, luts, n,
                tiles_per_cluster=pqi.tiles_per_cluster)
        probes = base.probe_clusters(qq, n_probe)
        tiles, scales = index[st]
        return lambda: ip.ivf_probe(qq, tiles, base.tile_ids, probes, n,
                                    "zen", tiles_per_cluster=T,
                                    tile_scales=scales)

    shapes = [(st, 64, 64, 8) for st in (*quant.SCALAR_STORAGE_DTYPES, "pq")]
    shapes += [(st, 64, n, 8) for n in (512, 2_048) for st in ("float32",
                                                               "pq")]
    shapes += [(st, 64, 64, 64) for st in ("float32", "pq")]
    shapes += [(st, 2, 64, 8) for st in ("float32", "pq")]
    for st, nq, n, n_probe in shapes:
        ms = queued_ms(call(st, nq, n, n_probe), args.iters)
        print(json.dumps({"label": args.label, "src": args.src,
                          "storage": st, "Q": nq, "n": n, "nprobe": n_probe,
                          "T": T, "ms": ms, "card": smi}), flush=True)
    split = host_split(ip, call("float32", 64, 64, 8))
    print(json.dumps({"label": args.label, "src": args.src, "host": split,
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
