"""Training checkpoints: atomic, async, retained (PyTorch counterpart of
``repro.checkpoint.checkpoint``), in the reference's on-disk format, so a
checkpoint either package writes the other restores.

* **atomic** — a step directory is written under ``<dir>/tmp.step_N`` and
  renamed to ``step_N`` only after every leaf and the manifest are
  fsync'd; a crash mid-save never corrupts the latest checkpoint, and a
  ``tmp.`` directory is never listed as a step;
* **async** — ``save_async`` copies every leaf to the host before it
  returns (the step that follows may change the tensors in place) and
  writes in a background thread; ``wait()`` joins it;
* retention — keeps the newest ``keep`` checkpoints.

Format: one ``.npy`` per leaf and a ``manifest.json`` (``step``,
``leaves``: name, file, dtype, shape, spec; ``treedef``). A tree is nested
dicts (flattened in sorted key order), lists and tuples (by index) and
NamedTuples (a field is named ``.field``), as ``jax.tree_util`` flattens
them; a leaf's name is its path joined by ``__`` (``1__.mu__table``).
bf16 leaves are stored as their raw ``u2`` bits with dtype
``"bfloat16"``. The port writes ``"spec": []`` (no sharding) and
``"treedef": null`` (a restore takes ``like=``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_NATIVE_DTYPES = {
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "complex64", "complex128",
}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path component, child) pairs of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def leaf_paths(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) in the reference's flattening order and naming."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("__".join(path) or "leaf", node))
            return
        for comp, child in kids:
            walk(child, path + [comp])

    walk(tree, [])
    return out


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def nest_state(flat: dict) -> dict:
    """A ``state_dict``-style mapping (``bot.0.w``) as the reference's
    nested pytree (``{"bot": [{"w": ...}]}``): numeric components become
    list indices."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def flat_state(tree, prefix: str = "") -> dict:
    """The inverse of ``nest_state``: dotted names to leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), c) for i, c in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, child in items:
        out.update(flat_state(child, f"{prefix}.{k}" if prefix else k))
    return out


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype's name (a copy even of a CPU
    tensor: training changes the tensors in place while a save is being
    written). bf16 comes back as its u2 bits (numpy has no bf16 without
    ml_dtypes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype_name not in _NATIVE_DTYPES:
        raise ValueError(f"leaf dtype {dtype_name} has no torch counterpart "
                         "here")
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any) -> str:
        """Synchronous atomic save of a tree of tensors and arrays."""
        return self._write(step, [(n, *_host(x)) for n, x in leaf_paths(tree)])

    def save_async(self, step: int, tree: Any) -> None:
        """Host copies now; the disk write in a background thread."""
        self.wait()
        host = [(n, *_host(x)) for n, x in leaf_paths(tree)]
        self._thread = threading.Thread(
            target=self._write_in_thread, args=(step, host), daemon=True)
        self._thread.start()

    def _write_in_thread(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_leaves: list) -> str:
        tmp = os.path.join(self.directory, f"tmp.step_{step:010d}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for name, arr, stored_dtype in host_leaves:
            fname = f"{name}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({
                "name": name,
                "file": fname,
                "dtype": stored_dtype,
                "shape": list(arr.shape),
                "spec": [],
            })
        manifest["treedef"] = None
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like: Any = None
                ) -> Tuple[int, Any]:
        """Restore the given (or latest) step.

        With ``like`` (a tree of the same structure, as the reference's
        ``restore(like=)``): the leaves come back in like's structure, each
        a tensor of like's dtype on like's device (a CPU tensor for a
        non-tensor leaf of like); the leaf names must match the
        manifest's. Without it: a dict of name -> CPU tensor.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        entries = manifest["leaves"]

        def load(entry) -> torch.Tensor:
            arr = np.load(os.path.join(d, entry["file"]))
            return _to_tensor(arr, entry["dtype"])

        if like is None:
            return step, {e["name"]: load(e) for e in entries}
        names = leaf_paths(like)
        if [n for n, _ in names] != [e["name"] for e in entries]:
            raise ValueError(
                f"checkpoint step {step} holds leaves "
                f"{[e['name'] for e in entries]}, not like's "
                f"{[n for n, _ in names]}")
        leaves = []
        for (_, ref), entry in zip(names, entries):
            t = load(entry)
            if isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            leaves.append(t)
        return step, _unflatten(like, leaves)
