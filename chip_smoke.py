"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the Hopper
kernels, holds each against its plain PyTorch version, serves the flat
index end to end at full size, churns it, and times the kernel.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # build + kernel checks at one shape

Phases:
  1. the device, and its name and power limit as nvidia-smi reports them;
  2. build every kernel from src/repro_torch/kernels/csrc (nvcc, sm_90a);
  3. zen_topk against zen_topk_scan on the card: every mode x storage,
     Q in {2, 64}, n in {10, 64, 128}, N = 1,000,000 and 1,000,003, a small
     N with n > N, and an index holding dead (_DEAD_COORD) rows;
  4. serve: build_index on a 1,000,000 x 256 f32 manifold corpus (k = 16,
     flat, re-rank 4), 8 batches of 64 queries through ZenServer.query,
     recall@10 against an exact brute-force top-10, p50/p99 request
     latency; plus the card's answers against the CPU path on a small
     index. The kernel's launch count must advance;
  5. churn: delete and upsert ids, query, compact, query; no deleted id
     may come back;
  6. time the kernel at the serving shape (Q = 64, N = 1e6, k = 16, n = 64)
     with CUDA events beside its bound, the plain version and a library
     composite (matmul-form distances + torch.topk).

Prints one JSON line of kernel records, the nvidia-smi line, and last the
device line. Any failed check exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

#: published H100 SXM peaks (data sheet, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: kernel vs plain tolerance: both evaluate the same f32 norm expansion,
#: in another summation order (per-thread FMA chain vs cuBLAS f32 GEMM)
RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def timed(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_serving(server, batches) -> None:
    """Device time by kernel over a few served batches (torch.profiler),
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for q in batches:
            server.query(q, 10)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"    profile of {len(batches)} batches (profiler on): wall "
        f"{wall_us:.0f} us, device busy {busy:.0f} us "
        f"({busy / wall_us:.1%}); by kernel:")
    for us, count, key in rows[:8]:
        log(f"      {us:9.1f} us  {us / max(busy, 1e-9):6.1%}  x{count:<4d} "
            f"{key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    quick = "--quick" in sys.argv[1:]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}; {smi}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 must be off: the reference accumulates in full f32")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2] built {built} from {_build.CSRC} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for lib_name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {lib_name}: {line.strip()}")

    # -- 3. kernel vs plain ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 16
    corpus = syn.manifold_space(1_000_003, 256, 32, generator=gen)
    small = serve.build_index(corpus[:20_000], k, generator=torch.Generator()
                              .manual_seed(0), device=dev, keep_corpus=False)
    tr = small.transform
    coords = tr.transform(corpus)               # (1,000,003, 16) f32
    queries = tr.transform(syn.manifold_space(64, 256, 32, generator=gen))
    scale = float(coords.norm(dim=1).median())
    atol = RTOL * scale
    log(f"[3] zen_topk vs zen_topk_scan: rtol {RTOL}, atol {atol:.3g} "
        f"(1e-5 x median row norm {scale:.3g})")
    encoded = {s: quant.encode_rows(coords, s)
               for s in quant.SCALAR_STORAGE_DTYPES}
    max_err, n_checked = 0.0, 0

    def compare(q, x, s, n, mode, label):
        nonlocal max_err, n_checked
        got = zt.zen_topk(q, x, n, mode, scales=s)
        want = zt.zen_topk_scan(q, x, n, mode, scales=s)
        torch.cuda.synchronize()
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                            atol=atol)
        if msg is not None:
            fail(f"zen_topk disagrees with its plain version ({label}): "
                 f"{msg}")
        live = torch.isfinite(want[0])
        err = float((got[0] - want[0])[live].abs().max())
        max_err = max(max_err, err)
        n_checked += 1

    cases = [(st, m, nq, n, nrows)
             for st in quant.SCALAR_STORAGE_DTYPES
             for m in ("zen", "lwb", "upb")
             for nq in (2, 64) for n in (10, 64, 128)
             for nrows in (1_000_000, 1_000_003)]
    if quick:
        cases = [c for c in cases if c[2] == 64 and c[3] == 64
                 and c[4] == 1_000_003]
    t0 = time.perf_counter()
    for st, m, nq, n, nrows in cases:
        x, s = encoded[st]
        compare(queries[:nq], x[:nrows], None if s is None else s[:nrows],
                n, m, f"{st} {m} Q={nq} n={n} N={nrows}")
    # n > N, and an index with dead rows (the mutable index's sentinel)
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = encoded[st]
        compare(queries, x[:100], None if s is None else s[:100], 128,
                "zen", f"{st} N=100 n=128")
        dead = serve.ZenIndex(tr, x[:50_000].clone(), None, storage=st,
                              coord_scales=None if s is None
                              else s[:50_000].clone())
        dead = dead.delete(list(range(0, 50_000, 7)))
        compare(queries, dead.coords, dead.coord_scales, 64, "lwb",
                f"{st} N=50000 with {50_000 // 7 + 1} dead rows")
    log(f"    {n_checked} cases agree (ids equal outside near-ties); max "
        f"|d - d_plain| {max_err:.3g}; {time.perf_counter() - t0:.1f} s")
    if quick:
        log("quick run: stopping after the kernel checks")
        sys.exit(2)
    del encoded

    # -- 4. serve end to end --------------------------------------------
    corpus = corpus[:1_000_000]
    t0 = time.perf_counter()
    index = serve.build_index(corpus, k, storage="float32",
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    log(f"[4] build_index: {index.size} x {k} from 256-d, f32, "
        f"{time.perf_counter() - t0:.2f} s; coords "
        f"{index.coords.numel() * 4 / 2**20:.0f} MiB, corpus "
        f"{corpus.numel() * 4 / 2**30:.2f} GiB on {index.device}")
    batches = [syn.manifold_space(64, 256, 32, generator=gen)
               for _ in range(9)]
    serve.ZenServer(index, rerank_factor=4).query(batches[0], 10)  # warm-up
    server = serve.ZenServer(index, rerank_factor=4)
    zt.zen_topk.launches = 0
    lat, recalls = [], []
    for q in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = server.query(q, 10)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if d.shape != (64, 10) or not torch.isfinite(d).all():
            fail(f"served distances not finite of shape (64, 10): {d.shape}")
        if ids.min() < 0 or ids.max() >= corpus.shape[0]:
            fail("served ids out of range")
        recalls.append(serve.recall(ids, serve.exact_topk(q, corpus, 10)))
    serve_launches = zt.zen_topk.launches
    if serve_launches == 0:
        fail("the serving path never launched the zen_topk kernel")
    lat_ms = np.asarray(lat) * 1e3
    log(f"    served {len(lat)} batches x 64 queries: recall@10 "
        f"{np.mean(recalls):.4f} (min batch {np.min(recalls):.4f}); "
        f"request latency p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; zen_topk launches "
        f"{serve_launches}; stats {server.stats()}")
    profile_serving(server, batches[1:5])
    # the card's answers against the CPU path on a small index
    pivots = [int(i) for i in torch.randperm(
        20_000, generator=torch.Generator().manual_seed(1))[:k]]
    for st in quant.SCALAR_STORAGE_DTYPES:
        q = batches[1]
        got = serve.ZenServer(serve.build_index(
            corpus[:20_000], k, storage=st, pivot_ids=pivots, device=dev),
            rerank_factor=4).query(q, 10)
        want = serve.ZenServer(serve.build_index(
            corpus[:20_000].cpu(), k, storage=st, pivot_ids=pivots,
            device="cpu"), rerank_factor=4, chunk=4096).query(q.cpu(), 10)
        # fit on two devices: coordinates differ by f32 noise, which a
        # quantised code can turn into one storage step; the re-rank is
        # exact, so the results agree to 1e-4
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        if msg is not None:
            fail(f"card and CPU serving disagree ({st}): {msg}")
    log("    card vs CPU serving on a 20,000-row index agree "
        "(f32/bf16/int8, re-rank 4)")

    # -- 5. churn --------------------------------------------------------
    zt.zen_topk.launches = 0
    q = batches[1]
    _, ids = server.query(q, 10)
    dead = sorted(set(ids[:, :3].ravel().tolist())
                  | set(range(0, 1_000_000, 997)))
    server.delete(dead)
    fresh = syn.manifold_space(2_000, 256, 32, generator=gen)
    new_ids = list(range(1_000_000, 1_001_000)) + dead[:1_000]
    server.upsert(new_ids, fresh)
    revived = set(dead[:1_000])
    for step in ("after delete + upsert", "after compact"):
        for q in batches[1:4]:
            d, ids = server.query(q, 10)
            back = (set(ids.ravel().tolist()) & set(dead)) - revived
            if back or not torch.isfinite(d).all():
                fail(f"churn {step}: deleted ids came back: {sorted(back)}")
        server.compact()
    log(f"[5] churn: deleted {len(dead)}, upserted {len(new_ids)} "
        f"({len(revived)} revived ids); no deleted id returned after "
        f"delete/upsert or compact; index {server.index.size} live rows; "
        f"zen_topk launches {zt.zen_topk.launches}")

    # -- 6. timing at the serving shape ----------------------------------
    nq, n = 64, 64
    qt = queries[:nq].contiguous()
    x32 = coords[:1_000_000].contiguous()
    records = {}
    log(f"[6] zen_topk at Q={nq}, N=1,000,000, k={k}, n={n}; {smi}")
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = quant.encode_rows(x32, st)
        nbytes = (qt.numel() * 4 + x.numel() * x.element_size()
                  + (0 if s is None else s.numel() * 4) + nq * n * 8)
        flops = 2 * nq * x.shape[0] * k
        bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / PEAK_BYTES_S
                    > flops / PEAK_F32_FLOPS else "operations")
        before = zt.zen_topk.launches
        ms = timed(lambda: zt.zen_topk(qt, x, n, "zen", scales=s), 20)
        ms2 = timed(lambda: zt.zen_topk(qt, x, n, "zen", scales=s), 20)
        zt.zen_topk.launches = before  # timing launches are not the path's
        plain = timed(lambda: zt.zen_topk_scan(qt, x, n, "zen", scales=s),
                      3, warmup=1)

        def library():
            xf = x.float() if s is None else x.float() * s
            z2 = ((qt * qt).sum(1, keepdim=True) + (xf * xf).sum(1)[None]
                  - 2.0 * qt[:, :-1] @ xf[:, :-1].T)
            return torch.topk(torch.sqrt(torch.clamp_min(z2, 0.0)), n,
                              dim=1, largest=False)

        lib = timed(library, 10)
        records[st] = dict(ms=min(ms, ms2), plain_ms=plain, bound_ms=bound,
                           bound_by=bound_by, library_ms=lib)
        log(f"    {st:8s}: kernel {ms:.4f} / {ms2:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {bound / min(ms, ms2):.1%} of "
            f"bound; plain {plain:.3f} ms; library {lib:.4f} ms")
    main_rec = records["float32"]
    print(json.dumps({"kernels": [{
        "name": "zen_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/zen_topk.cu",
        "replaces": "src/repro/kernels/zen_topk.py:92",
        "launches": serve_launches, "max_abs_err": max_err,
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
