"""Build the Hopper kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a plain-C shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

under ``build/`` at the root of the checkout, keyed by a hash of every
``csrc`` file and the flags, so an edited source rebuilds and an unchanged
one is loaded as it is. The build runs at first use, inside the process
that needs the kernel; :func:`build_all` starts one ``nvcc`` per source at
once. Nothing here includes PyTorch's headers (a build takes seconds, not
minutes) and nothing runs at import time: a host without a card usually
has no ``nvcc`` either, and the CPU paths never call in here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ctypes signature of each library's entry points: name -> (argtypes, restype)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES: Dict[str, Dict[str, Tuple[list, object]]] = {
    "zen_topk": {
        # queries, index, scales, dtype, nq, n_index, k, n_out, mode, then
        # the plan (kernel, w, kq, cap, global_lists, smem, n_split,
        # split_rows, n_lists, merge_smem, tile_rows, stages, warps,
        # streams), partial, gscratch, out_d, out_i, stream
        "zen_topk_launch": ([_P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _P,
                             _P, _P, _P, _P], ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "ivf_probe": {
        # queries, tiles, tile_ids, probes, scales, dtype, nq, n_probe,
        # n_clusters, cluster_rows, k, n_out, mode, then the plan (kernel,
        # w, cap, global_lists, smem, group, merge_smem, warps, splits,
        # split_rows, cols, cluster), vec, partial, gscratch,
        # mscratch, out_d, out_i, stream
        "ivf_probe_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                              _I, _I, _I, _P, _P, _P, _P, _P, _P],
                             ctypes.c_int),
        # codes, tile_ids, probes, luts, nq, n_probe, n_clusters,
        # cluster_rows, m, n_out, then the plan (kernel, w, cap,
        # global_lists, smem, m_smem, group, merge_smem, warps, splits,
        # split_rows, cols, cluster), vec, partial, gscratch,
        # mscratch, out_d, out_i, stream
        "ivf_probe_pq_launch": ([_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _I,
                                 _I, _I, _P, _P, _P, _P, _P, _P],
                                ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "pdist": {
        # x, y, dtype, n, k, m, then the plan (kernel, grid, stages,
        # smem), out, stream
        "pdist_sq_launch": ([_P, _P, _I, _L, _L, _I, _I, _I, _I, _I, _P, _P],
                            ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "zen_estimate": {
        # x, y, dtype, n, m, k, mode, out, stream
        "zen_estimate_launch": ([_P, _P, _I, _L, _L, _I, _I, _P, _P],
                                ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "jsd": {
        # x, y, dtype, n, k, m, out, stream
        "jsd_pdist_launch": ([_P, _P, _I, _L, _L, _I, _P, _P], ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "tile_stage": {
        # src (page-locked host), dst, block_bytes, n_blocks, stream
        "tile_stage_launch": ([_P, _P, _L, _L, _P], ctypes.c_int),
        "zen_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the Hopper "
        "kernels are compiled on the machine that has the card")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_logs[name] = log


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> List[str]:
    """Build (in parallel) and load every named library; returns the names
    that were compiled now rather than found built."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo if not _target(n).exists()]
        try:
            for n, out, tmp, proc in started:
                _finish(n, out, tmp, proc)
        finally:
            for *_, proc in started:  # stop whatever a failure left running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in todo:
            _libs[n] = _open(n, _target(n))
        return [s[0] for s in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.zen_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
