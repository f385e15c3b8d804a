"""Build seconds and request latency of the full-size servers, for the
``repro_torch`` package under ``--src``: one checkout against another in a
single run on the card (an A/B of the serving path's host and device
cost).

This is a measurement, not part of the port. It builds what phases 4 and 8
of ``chip_smoke.py`` build, on the same inputs (seeded on the card): the
1,000,000 x 256 manifold corpus at k = 16, flat (f32) and IVF (f32,
4,000 clusters of 128-row tiles), and serves 64-row and 1-row batches
through ``ZenServer.query`` at re-rank 0 and 4 (nprobe 8 on IVF). It
prints one JSON line per measure with the card's name and power limit:
the build seconds, the p50 / p99 request latency (wall clock, the device
synchronised), and the transform of 64 queries alone (the query
projection) per call.

    python3 src/repro_torch/kernels/probes/serve_timing.py --src src
    python3 src/repro_torch/kernels/probes/serve_timing.py --src OTHER/src \
        --label parent

Run the two versions in turns in one call (A, B, B, A) to compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory holding the repro_torch package")
    ap.add_argument("--label", default="this")
    ap.add_argument("--batches", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import serve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = syn.manifold_space(1_000_000, 256, 32, generator=gen)
    batches = [syn.manifold_space(64, 256, 32, generator=gen)
               for _ in range(args.batches + 1)]

    def emit(**rec):
        print(json.dumps({"label": args.label, "src": args.src, **rec,
                          "card": smi}), flush=True)

    for kind, kw in (("flat", {}),
                     ("ivf", dict(index="ivf", n_clusters=4_000,
                                  tile_rows=128))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = serve.build_index(corpus, 16, device=dev,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
        torch.cuda.synchronize()
        emit(kind=kind, measure="build_s", value=time.perf_counter() - t)
        for rerank in (0, 4):
            server = serve.ZenServer(index, rerank_factor=rerank, nprobe=8)
            for rows in (64, 1):
                server.query(batches[0][:rows], 10)  # warm-up
                lat = []
                for q in batches[1:]:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    server.query(q[:rows], 10)
                    torch.cuda.synchronize()
                    lat.append(time.perf_counter() - t)
                ms = np.asarray(lat) * 1e3
                emit(kind=kind, measure="request_ms", rerank=rerank,
                     rows=rows, p50=float(np.percentile(ms, 50)),
                     p99=float(np.percentile(ms, 99)))
        tr = index.transform
        tr.transform(batches[0])
        lat = []
        for q in batches[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.transform(q)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        emit(kind=kind, measure="transform_64_ms",
             p50=float(np.percentile(np.asarray(lat) * 1e3, 50)))
        del index


if __name__ == "__main__":
    main()
