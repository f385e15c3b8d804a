"""Versioned, atomic on-disk state for serving indexes.

PyTorch counterpart of ``repro.checkpoint.index_io``, writing the same
bytes: one ``.npy`` per array plus ``manifest.json`` holding ``{format,
version, kind, meta, arrays}``, so a snapshot written by either package
loads in the other.

  save_state(dir, arrays, meta, kind=...)   -> atomic versioned snapshot
  load_state(dir, expect_kind=...)          -> (arrays, meta) or raise

The write goes to a ``tmp.`` sibling directory, every file is fsync'd, and
the directory is ``os.rename``'d into place. When overwriting, the previous
snapshot is first renamed aside to an ``old.`` sibling and only removed
after the new one is published, so a crash at any point leaves either the
old or the new snapshot loadable (a leftover ``old.<name>`` means the crash
hit the window between the two renames; rename it back to recover).

bfloat16: ``.npy`` has no bf16 dtype, so a ``torch.bfloat16`` tensor is
stored as the ``uint16`` view of its bits and the manifest's dtype entry
says ``"bfloat16"``, as the reference does for its ``ml_dtypes`` arrays.
The port has no numpy bf16 dtype: :func:`load_state` returns such an array
as its ``uint16`` bits, and :func:`to_tensor` views them as
``torch.bfloat16`` again.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

#: on-disk format name; never reuse for a different layout
INDEX_FORMAT = "zen-index"
#: v2 added int8/bf16 storage, v3 product-quantised storage (uint8 codes
#: with their ``pq_codebooks``); a reader of an older version must reject
#: a newer snapshot loudly, which the version number guarantees
INDEX_FORMAT_VERSION = 3
#: versions this build can still load; v1/v2 snapshots are strict subsets
#: of v3 (loaders default missing storage meta to "float32")
READABLE_VERSIONS = (1, 2, 3)


class CheckpointFormatError(ValueError):
    """Raised when a snapshot's format/version/kind does not match."""


def _fsync_dir(path: str) -> None:
    """fsync a directory so the rename that published into it is durable
    (best effort where directories cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_json_atomic(path: str, payload: Mapping[str, Any]) -> str:
    """Durably replace a small JSON file (tmp + fsync + rename + dir fsync):
    readers see the previous file or the new one, never a torn write."""
    path = os.path.abspath(path)
    tmp = os.path.join(os.path.dirname(path),
                       f"tmp.{os.path.basename(path)}")
    with open(tmp, "w") as f:
        json.dump(dict(payload), f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX
    _fsync_dir(os.path.dirname(path))
    return path


def to_numpy(arr) -> np.ndarray:
    """A numpy array or tensor as :func:`save_state` writes it: a tensor in
    C order (as a JAX array is), whatever its strides, and a bf16 tensor as
    the uint16 view of its bits."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().view(np.uint16)
        return arr.numpy()
    return np.asarray(arr)


def _host_array(arr) -> Tuple[np.ndarray, str]:
    """(array as written, manifest dtype name)."""
    bf16 = isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16
    arr = to_numpy(arr)
    return arr, "bfloat16" if bf16 else str(arr.dtype)


def save_state(
    directory: str,
    arrays: Mapping[str, Any],
    meta: Mapping[str, Any],
    *,
    kind: str,
) -> str:
    """Atomically write a versioned snapshot.

    Args:
      directory: target snapshot directory (created/replaced as a whole).
      arrays:    name -> numpy array or tensor; each is stored as
                 ``<name>.npy``. Names must be filesystem-safe
                 (``[A-Za-z0-9_.-]``).
      meta:      JSON-serialisable metadata.
      kind:      consumer tag (e.g. ``"ivf-index"``, ``"zen-server"``)
                 checked again at load time.

    Returns the final snapshot directory path.
    """
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"tmp.{os.path.basename(directory)}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {
        "format": INDEX_FORMAT,
        "version": INDEX_FORMAT_VERSION,
        "kind": kind,
        "meta": dict(meta),
        "arrays": {},
    }
    for name, arr in arrays.items():
        if not all(c.isalnum() or c in "_.-" for c in name):
            raise ValueError(f"unsafe array name {name!r}")
        arr, dtype_name = _host_array(arr)
        fname = f"{name}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"][name] = {
            "file": fname, "dtype": dtype_name, "shape": list(arr.shape),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    # publish: move the old snapshot aside (not rmtree) so a crash between
    # the renames still leaves one loadable snapshot on disk
    old = os.path.join(parent, f"old.{os.path.basename(directory)}")
    if os.path.exists(directory):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(directory, old)
    os.rename(tmp, directory)  # atomic publish
    _fsync_dir(parent)  # make the rename itself durable, not just the files
    shutil.rmtree(old, ignore_errors=True)
    return directory


def load_state(
    directory: str,
    *,
    expect_kind: Optional[str] = None,
    mmap: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a snapshot written by :func:`save_state` (of either package).

    Args:
      directory:   snapshot directory.
      expect_kind: when given, the manifest's ``kind`` must match.
      mmap:        memory-map the ``.npy`` files read-only instead of
                   reading them (the tiered tile store serves its host
                   pool straight off the snapshot).

    Returns ``(arrays, meta)`` with host numpy arrays; a bf16 array comes
    back as its ``uint16`` bits (:func:`to_tensor` views it as bf16).

    Raises:
      FileNotFoundError:     no manifest at ``directory``.
      CheckpointFormatError: wrong format name, unreadable version, kind
                             mismatch, or an array whose dtype/shape
                             disagrees with its manifest entry.
    """
    path = os.path.join(directory, "manifest.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no index snapshot at {directory}")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != INDEX_FORMAT:
        raise CheckpointFormatError(
            f"{directory}: format {manifest.get('format')!r}, "
            f"expected {INDEX_FORMAT!r}")
    if manifest.get("version") not in READABLE_VERSIONS:
        raise CheckpointFormatError(
            f"{directory}: format version {manifest.get('version')!r} not "
            f"readable by this build (reads {READABLE_VERSIONS})")
    if expect_kind is not None and manifest.get("kind") != expect_kind:
        raise CheckpointFormatError(
            f"{directory}: snapshot kind {manifest.get('kind')!r}, "
            f"expected {expect_kind!r}")
    arrays: Dict[str, np.ndarray] = {}
    for name, entry in manifest["arrays"].items():
        arr = np.load(os.path.join(directory, entry["file"]),
                      mmap_mode="r" if mmap else None)
        want = "uint16" if entry["dtype"] == "bfloat16" else entry["dtype"]
        if str(arr.dtype) != want or list(arr.shape) != entry["shape"]:
            raise CheckpointFormatError(
                f"{directory}: array {name!r} is {arr.dtype}{arr.shape}, "
                f"manifest says {entry['dtype']}{tuple(entry['shape'])}")
        arrays[name] = arr
    return arrays, manifest["meta"]


def to_tensor(arr: np.ndarray, device, *, bfloat16: bool = False
              ) -> torch.Tensor:
    """A snapshot array as a tensor on ``device`` (a copy: a memory-mapped
    array stays read-only). ``bfloat16`` views its uint16 bits as
    ``torch.bfloat16``."""
    arr = np.array(arr)
    if bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
