"""Device time of ``zen_topk`` at the serving shape and the wide widths,
for the ``repro_torch`` package under ``--src``: one checkout against
another in a single run on the card (an A/B of two versions of the kernel).

This is a measurement, not part of the port. It times what phase 6 of
``chip_smoke.py`` times, on the same inputs (seeded on the card):
Q = 64 queries against N = 1,000,000 rows of k = 16 coordinates, f32, bf16
and int8 (with row scales) at n = 64 and n = 10, and f32 at n = 260, 1,200
and 10,000 (list widths 512, 2,048 and 16,384), each call queued behind a
spin kernel so that the host's launch gaps are left out, and prints one
JSON line per shape with the card's name and power limit.

    python3 src/repro_torch/kernels/probes/topk_timing.py --src src
    python3 src/repro_torch/kernels/probes/topk_timing.py --src OTHER/src \
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
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import zen_topk as zt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((1_000_000, 16), generator=gen, device=dev)
    x32[:, -1].abs_()
    q = torch.randn((64, 16), generator=gen, device=dev)
    q[:, -1].abs_()
    shapes = [(st, n) for st in quant.SCALAR_STORAGE_DTYPES for n in (64, 10)]
    shapes += [("float32", n) for n in (260, 1_200, 10_000)]
    for st, n in shapes:
        x, s = quant.encode_rows(x32, st)
        iters = args.iters if n <= 1_200 else 5
        ms = queued_ms(lambda: zt.zen_topk(q, x, n, "zen", scales=s), iters)
        print(json.dumps({"label": args.label, "src": args.src,
                          "storage": st, "n": n, "ms": ms, "card": smi}),
              flush=True)


if __name__ == "__main__":
    main()
