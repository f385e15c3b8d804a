"""Dry-run: trace every (architecture x cell) plan on the production
meshes and record its per-device terms (PyTorch counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each plan on 256 or 512 placeholder
host devices. The port has no compiler to ask: it runs the plan's own
``fn`` (``launch.steps.build_plan``), the code the card runs, on fake
shards of the production mesh (``launch.mesh.make_production_mesh(
device="meta")``): ``FakeTensorMode`` with a ``ShapeEnv``, tensors with
shapes and no storage, on the host. Every leaf of the plan's arguments is
laid out by its spec, one fake shard a mesh position. The record, keyed
as the reference's so the two read side by side:

* ``memory``: ``argument_bytes`` (a position's parameters, optimizer
  state and inputs, from the shard shapes: every position's are the
  same size), ``output_bytes``
  (the largest position's outputs), ``peak_bytes`` null with the reason;
* ``cost.flops``: the FLOPs over the mesh by ``torch.utils.
  flop_counter.FlopCounterMode``'s formulas, counted in the fake mode
  (``_fake_mode_class``; a real run under ``FlopCounterMode`` counts the
  same), divided by ``n_devices`` (a mean a position), and
  ``cost.flops_total``;
* ``collectives``: per kind ``{count, bytes}`` a position (the mesh's
  totals over ``n_devices``; ``collectives_mesh`` the totals), with
  ``total_bytes`` and ``total_count``, counted by
  ``distributed.partition.recording``: each receiving position and the
  bytes it takes in, the kinds under the reference's HLO names where one
  exists;
* ``model_flops``: ``launch.model_flops.estimate``;
* ``corrected``: how the costs were counted. ``{"method": "counted
  whole"}`` when the whole plan was traced. An LM of more than two layer
  groups is traced at one and at two groups (``n_layers`` overridden, as
  the reference's ``_scan_corrected_cost`` compiles its probes) and every
  count extrapolated, total = c(1) + (G - 1) (c(2) - c(1)); a train step
  of more than three microbatches also at two and three microbatches of
  the cell's size (c(G, k) = a + b k + d G k from three traces). Its
  groups and microbatches are the same work, so this is the whole plan's
  count (the tests hold it to a whole trace) at a few groups' host time
  instead of G x nm.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      [--jobs 8] [--skip-existing]

Records: ``dryrun_out/<arch>__<shape>__<mesh>.json`` (``--artifact-dir``
to change it); the dry-run never writes into ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

#: where records go by default: the checkout's ``dryrun_out/``
ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "dryrun_out"))

#: why a position's peak cannot be read from a fake trace
PEAK_UNKNOWN = ("every position of the fake mesh lies on one placeholder "
                "device, so a position's live activations cannot be told "
                "apart; argument_bytes + output_bytes bound what it holds "
                "before and after the step")


def _parse_variant(variant: str) -> dict:
    """'n_microbatches=4,remat_policy=none' -> typed dict."""
    out = {}
    if not variant:
        return out
    for item in variant.split(","):
        k, v = item.split("=")
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


# -- fake arguments and their bytes ---------------------------------------------


def _leaves(tree, spec):
    """(leaf, spec) pairs of a plan argument and its spec tree."""
    from repro_torch.optim import AdamWState

    if isinstance(tree, AdamWState):
        for name in ("step", "mu", "nu"):
            yield from _leaves(getattr(tree, name), getattr(spec, name))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, spec[k])
    else:
        yield tree, spec


def _shard_shape(shape, spec, mesh, pos: int) -> tuple:
    from repro_torch.distributed import partition

    return tuple(b.stop - b.start
                 for b in partition.block(shape, spec, mesh, pos))


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def argument_bytes(plan, mesh) -> int:
    """A position's bytes of the plan's arguments (parameters, optimizer
    state, inputs), each leaf's shard by its spec: the same at every
    position, as ``partition.block`` cuts equal blocks or raises."""
    return sum(_nbytes(_shard_shape(leaf.shape, sp, mesh, 0), leaf.dtype)
               for arg, spec in zip(plan.args, plan.in_specs)
               for leaf, sp in _leaves(arg, spec))


def fake_arguments(plan, mesh, cache_len: Optional[int] = None) -> tuple:
    """The plan's arguments as fake shards laid out by ``in_specs`` (call
    inside the fake mode): every leaf a ``ShardedTensor`` with one fake
    tensor a position, the parameters of a train plan requiring grad; a
    decode's cache length the Python int ``cache_len`` (the plan takes
    one)."""
    from repro_torch.distributed.partition import ShardedTensor
    from repro_torch.optim import AdamWState

    def lay(tree, spec, grad=False):
        if isinstance(tree, AdamWState):
            return AdamWState(step=lay(tree.step, spec.step),
                              mu=lay(tree.mu, spec.mu),
                              nu=lay(tree.nu, spec.nu))
        if isinstance(tree, dict):
            return {k: lay(v, spec[k], grad) for k, v in tree.items()}
        shards = [torch.empty(_shard_shape(tree.shape, spec, mesh, pos),
                              dtype=tree.dtype, device=mesh.devices.flat[pos]
                              ).requires_grad_(grad)
                  for pos in range(mesh.size)]
        return ShardedTensor(mesh, spec, tree.shape, tree.dtype, shards)

    args = [lay(plan.args[0], plan.in_specs[0], grad=plan.kind == "train")]
    args += [lay(a, s) for a, s in zip(plan.args[1:], plan.in_specs[1:])]
    if plan.kind == "decode":
        args[-1] = int(cache_len)
    return tuple(args)


def output_bytes(out, mesh) -> int:
    """The largest position's bytes of a plan's outputs (``ShardedTensor``
    leaves by position; a whole tensor counts on the mesh's first
    position, where the plans leave them)."""
    from repro_torch.distributed.partition import ShardedTensor
    from repro_torch.optim import AdamWState

    per = [0] * mesh.size

    def walk(x):
        if isinstance(x, ShardedTensor):
            for pos, s in enumerate(x.shards):
                per[pos] += _nbytes(s.shape, s.dtype)
        elif isinstance(x, torch.Tensor):
            per[0] += _nbytes(x.shape, x.dtype)
        elif isinstance(x, AdamWState):
            for v in (x.step, x.mu, x.nu):
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(out)
    return max(per)


# -- the trace ----------------------------------------------------------------------


def decode_cache_len(plan) -> int:
    """The dry-run's decode position: the cache full but for the new
    token (its longest leaf's length - 1)."""
    return max(int(kv.shape[2]) for c in plan.args[1].values()
               for kv in c.values()) - 1


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _key_of(a, out: list) -> bool:
    """Append ``a``'s part of an op's cache key to ``out``: a fake tensor
    by its metadata, a scalar or a list of them by value. False for
    anything else (a symbolic size, a generator, ...)."""
    if isinstance(a, FakeTensor):
        shape = tuple(a.shape)
        if any(type(d) is not int for d in shape):
            return False
        out.append((a.dtype, shape, a.stride(), a.storage_offset(),
                    a.fake_device, a.requires_grad, a.is_conj(), a.is_neg()))
        return True
    if isinstance(a, (list, tuple)):
        out.append((type(a), len(a)))
        return all(_key_of(x, out) for x in a)
    if isinstance(a, _SCALARS):
        out.append((type(a), a))
        return True
    return False


def _mm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    m, k = a_shape
    return 2 * m * k * b_shape[-1]


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


@functools.lru_cache(maxsize=None)
def flop_formulas() -> dict:
    """``torch.utils.flop_counter``'s formulas, keyed by op, with mm's and
    bmm's (the same counts) also taking the mixed-precision overloads
    ``mm.dtype`` / ``bmm.dtype`` (``a, b, out_dtype``) that the card's
    bf16 products call (``layers.matmul_f32``): some torch releases read
    the dtype as the output's shape there. ``FlopCounterMode``'s
    ``custom_mapping`` takes the two; the fake mode counts by all."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper

    aten = torch.ops.aten
    raw = {aten.mm: _mm_flops, aten.bmm: _bmm_flops}
    return {"custom": raw,
            "all": {**flop_registry,
                    **{k: shape_wrapper(v) for k, v in raw.items()}}}


@functools.lru_cache(maxsize=None)
def _fake_mode_class():
    """``FakeTensorMode`` counting FLOPs as it dispatches, by
    ``FlopCounterMode``'s formulas (``flop_formulas``), and answering an op it has seen with the same
    arguments from a key of their metadata alone. (``FlopCounterMode``
    stacked on the fake mode takes every ``.device`` read of the model's
    Python through a second Python dispatch; the fake mode's own cache key
    reads every field of every argument. Together they made MACE's trace
    2.3x slower.) A real run is counted by ``FlopCounterMode`` itself;
    the two agree exactly (tests, ``chip_smoke.py`` phase 30)."""
    from torch._subclasses import fake_tensor as ft

    formulas = flop_formulas()["all"]
    # the cache's internals differ between torch releases: without them
    # the mode counts and dispatches as FakeTensorMode does
    fast = all(hasattr(ft, n) for n in ("_CacheKeyState",
                                        "_DispatchCacheValidEntry")) and all(
        hasattr(ft.FakeTensorMode, n) for n in (
            "_cached_dispatch_impl", "_cache_key", "_output_from_cache_entry"))

    class CountingFakeMode(ft.FakeTensorMode):
        #: key -> (state, key, entry) of the op's first dispatch, or False
        #: (not cacheable): shared by the modes of a process, as the fake
        #: mode's own cache is (an entry names no mode, only metadata)
        _seen: dict = {}
        _fast = fast

        def __init__(self, **kw):
            super().__init__(**kw)
            self.flops = 0

        def dispatch(self, func, types, args=(), kwargs=None):
            out = super().dispatch(func, types, args, kwargs)
            count = formulas.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **(kwargs or {}), out_val=out)
            return out

        def _cached_dispatch_impl(self, func, types, args, kwargs):
            if not CountingFakeMode._fast:
                return super()._cached_dispatch_impl(func, types, args,
                                                     kwargs)
            parts = [func]
            simple = _key_of(args, parts) and all(
                _key_of((k, v), parts) for k, v in sorted(kwargs.items()))
            key = tuple(parts) if simple else None
            hit = self._seen.get(key) if simple else False
            if hit:  # (state, key, entry) of the op's first dispatch
                try:
                    return self._output_from_cache_entry(
                        hit[0], hit[2], hit[1], func, args)
                except TypeError:  # another release's signature
                    CountingFakeMode._fast = False
            out = super()._cached_dispatch_impl(func, types, args, kwargs)
            if hit is None:
                self._seen[key] = False
                state = ft._CacheKeyState(self.shape_env)
                slow = self._cache_key(state, func, args, kwargs)
                entry = ft.FakeTensorMode.cache.get(slow)
                if (not state.cache_on_shape_env()
                        and isinstance(entry, ft._DispatchCacheValidEntry)):
                    self._seen[key] = (state, slow, entry)
            return out

    return CountingFakeMode


def trace(plan, mesh, *, fake: bool = True, args=None,
          keep_output: bool = False) -> dict:
    """Run ``plan.fn`` once on ``mesh`` under a FLOP counter and the
    collective recorder: on fake shards (``fake``: ``FakeTensorMode``
    with a ``ShapeEnv`` counting by ``FlopCounterMode``'s formulas,
    ``_fake_mode_class``; ``args`` made here) or on ``args`` as given (a
    real run, under ``FlopCounterMode``). Returns {"flops": the mesh's
    total, "collectives": kind -> {count, bytes} over the mesh,
    "output_bytes", "seconds"}, and with ``keep_output`` the step's
    "output"."""
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import partition

    # allow_non_fake_inputs: a constant made on a placeholder position
    # (``torch.tensor(x, device="meta")``) is a plain meta tensor
    mode = (_fake_mode_class()(shape_env=ShapeEnv(),
                               allow_non_fake_inputs=True)
            if fake else contextlib.nullcontext())
    counter = mode if fake else FlopCounterMode(
        display=False, custom_mapping=flop_formulas()["custom"])
    t0 = time.perf_counter()
    with mode:
        if args is None:
            args = fake_arguments(plan, mesh, decode_cache_len(plan)
                                  if plan.kind == "decode" else None)
        with (contextlib.nullcontext() if fake else counter), \
                partition.recording() as coll:
            out = plan.fn(*args)
        nbytes = output_bytes(out, mesh)
    flops = counter.flops if fake else counter.get_total_flops()
    got = {"flops": int(flops),
           "collectives": {k: dict(v) for k, v in sorted(coll.items())},
           "output_bytes": nbytes,
           "seconds": time.perf_counter() - t0}
    if keep_output:
        got["output"] = out
    return got


def _combined(fn, traces: list) -> dict:
    """``fn(*counts)`` for every count of ``traces`` (kinds a trace lacks
    count zero)."""
    kinds = sorted(set().union(*(t["collectives"] for t in traces)))
    zero = {"count": 0, "bytes": 0}
    return {
        "flops": fn(*(t["flops"] for t in traces)),
        "collectives": {k: {f: fn(*(t["collectives"].get(k, zero)[f]
                                    for t in traces))
                            for f in ("count", "bytes")} for k in kinds},
        "seconds": sum(t["seconds"] for t in traces),
    }


def _extrapolated(one: dict, two: dict, groups: int) -> dict:
    """c(1) + (G - 1) (c(2) - c(1)) for every count of two traces."""
    def ext(a, b):
        return a + (groups - 1) * (b - a)

    got = _combined(ext, [one, two])
    got["output_bytes"] = ext(one["output_bytes"], two["output_bytes"])
    return got


def _exact_half(x: int) -> int:
    if x % 2:
        raise ValueError(f"a per-microbatch group count {x} / 2 is not whole")
    return x // 2


def _microbatch_extrapolated(c12: dict, c22: dict, c13: dict, groups: int,
                             nm: int) -> dict:
    """An LM train step's counts at G groups and nm microbatches from
    three traces at (groups, microbatches) = (1, 2), (2, 2), (1, 3):
    c(G, k) = a + b k + d G k, every group's work inside a microbatch (the
    optimizer's per-leaf work does not grow with G: no product, its
    collectives scalars), so d = (c(2,2) - c(1,2)) / 2, b = c(1,3) -
    c(1,2) - d, a = c(1,2) - 2 b - 2 d. Output bytes (no microbatch term)
    from the (1, 2), (2, 2) pair."""
    def ext(x12, x22, x13):
        d = _exact_half(x22 - x12)
        b = x13 - x12 - d
        a = x12 - 2 * b - 2 * d
        return a + b * nm + d * groups * nm

    got = _combined(ext, [c12, c22, c13])
    got["output_bytes"] = c12["output_bytes"] + (groups - 1) * (
        c22["output_bytes"] - c12["output_bytes"])
    return got


def _per_device(coll: dict, n: int) -> dict:
    out = {k: {"count": v["count"] / n, "bytes": v["bytes"] / n}
           for k, v in coll.items()}
    out["total_bytes"] = sum(v["bytes"] for v in coll.values()) / n
    out["total_count"] = sum(v["count"] for v in coll.values()) / n
    return out


def _mesh_totals(coll: dict) -> dict:
    out = {k: dict(v) for k, v in coll.items()}
    out["total_bytes"] = sum(v["bytes"] for v in coll.values())
    out["total_count"] = sum(v["count"] for v in coll.values())
    return out


def cell_costs(arch: str, shape: str, multi_pod: bool, mesh, *,
               overrides: Optional[dict] = None, whole: bool = False,
               reduced: bool = False, dims: Optional[dict] = None) -> dict:
    """The plan's traced counts over ``mesh``, with how they were
    counted (``corrected``)."""
    from repro_torch.launch.steps import build_plan

    def plan_at(over=None, dims_over=None):
        return build_plan(arch, shape, multi_pod=multi_pod, reduced=reduced,
                          overrides=dict(overrides or {}, **(over or {})),
                          dims=dict(dims or {}, **(dims_over or {})))

    plan = plan_at()
    cfg = plan.cfg
    G = getattr(cfg, "n_groups", 0)
    nm = cfg.n_microbatches if plan.kind == "train" and G else 1
    if whole or (G <= 2 and nm <= 3):
        got = trace(plan, mesh)
        got["corrected"] = {"method": "counted whole"}
        return got
    if nm > 3:  # whole microbatches of the cell's size, 2 or 3 of them
        rows = plan.args[2]["tokens"].shape[0] // nm

        def probe(groups: int, k: int):
            return trace(plan_at({"n_layers": groups * cfg.pattern_len,
                                  "n_microbatches": k},
                                 {"global_batch": rows * k}), mesh)

        c12, c22, c13 = probe(1, 2), probe(2, 2), probe(1, 3)
        got = _microbatch_extrapolated(c12, c22, c13, G, nm)
        got["corrected"] = {
            "method": "traced (layer groups, microbatches) = (1, 2), (2, 2)"
                      f" and (1, 3), extrapolated to ({G}, {nm}): c(G, k) "
                      "= a + b k + d G k",
            "groups": G, "microbatches": nm,
            "per_group_microbatch_flops": _exact_half(
                c22["flops"] - c12["flops"]),
            "trace_s": [round(c["seconds"], 2) for c in (c12, c22, c13)]}
        return got

    def probe(groups: int):
        return trace(plan_at({"n_layers": groups * cfg.pattern_len}), mesh)

    one, two = probe(1), probe(2)
    got = _extrapolated(one, two, G)
    got["corrected"] = {
        "method": "traced 1 and 2 layer groups, extrapolated to "
                  f"{G}: c(1) + (G - 1) (c(2) - c(1))",
        "groups": G,
        "per_group_flops": two["flops"] - one["flops"],
        "flops_1g": one["flops"], "flops_2g": two["flops"],
        "trace_s_1g": round(one["seconds"], 2),
        "trace_s_2g": round(two["seconds"], 2)}
    return got


# -- a cell ---------------------------------------------------------------------------


def _write(record: dict, artifact_dir: str) -> None:
    os.makedirs(artifact_dir, exist_ok=True)
    fname = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(artifact_dir, fname), "w") as f:
        json.dump(record, f, indent=1)


def run_cell(arch: str, shape: str, mesh_kind: str, artifact_dir: str,
             variant: str = "") -> dict:
    """Trace one cell on the ``pod`` (16 x 16) or ``multipod`` (2 x 16 x
    16) mesh and write its record; returns it."""
    from repro_torch.launch import model_flops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_plan

    multi_pod = mesh_kind == "multipod"
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                    "n_devices": 512 if multi_pod else 256}
    if variant:
        record["variant"] = variant
        record["arch"] = f"{arch}@{variant}"
    overrides = _parse_variant(variant)
    plan = build_plan(arch, shape, multi_pod=multi_pod, overrides=overrides)
    record["kind"] = plan.kind
    if plan.skip:
        record["status"] = "skipped"
        record["skip_reason"] = plan.skip
        _write(record, artifact_dir)
        print(f"SKIP {arch}/{shape}/{mesh_kind}: {plan.skip}")
        return record
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n = mesh.size
    try:
        args_bytes = argument_bytes(plan, mesh)
        got = cell_costs(arch, shape, multi_pod, mesh, overrides=overrides)
    except Exception as e:  # noqa: BLE001  (the record names it)
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()
        _write(record, artifact_dir)
        print(f"ERROR {arch}/{shape}/{mesh_kind}: {record['error']}")
        return record
    record.update({
        "status": "ok",
        "corrected": got["corrected"],
        "trace_s": round(got["seconds"], 2),
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": got["output_bytes"],
            "peak_bytes": None,
            "peak_bytes_reason": PEAK_UNKNOWN,
        },
        "cost": {"flops": got["flops"] / n, "flops_total": got["flops"],
                 "flops_per": "mean a position: the mesh's total by "
                              "FlopCounterMode's formulas / n_devices"},
        "collectives": _per_device(got["collectives"], n),
        "collectives_mesh": _mesh_totals(got["collectives"]),
        "model_flops": model_flops.estimate(arch, shape, plan.cfg),
    })
    _write(record, artifact_dir)
    coll = record["collectives"]
    print(f"OK {arch}/{shape}/{mesh_kind}: trace={record['trace_s']:.1f}s "
          f"flops/dev={record['cost']['flops']:.3e} "
          f"args/dev={args_bytes / 2**30:.2f}GiB "
          f"coll/dev={coll['total_bytes'] / 2**20:.1f}MiB "
          f"({coll['total_count']:.1f} ops)")
    return record


def _trace_cost(cell) -> int:
    """A rank of a cell's host time: recsys, LM decode, LM prefill, the
    GNN, LM train."""
    from repro_torch import configs as C

    spec = C.get_arch(cell[0])
    kind = spec.cell(cell[1]).kind
    if spec.family == "lm":
        return {"decode": 1, "prefill": 2, "train": 4}[kind]
    return {"recsys": 0, "gnn": 3}[spec.family]


def _finished(path: str) -> bool:
    """Whether ``path`` holds an ok or skipped record."""
    try:
        with open(path) as f:
            return json.load(f).get("status") in ("ok", "skipped")
    except (OSError, ValueError):
        return False


def summary(artifact_dir: str) -> str:
    """A markdown table of the records in ``artifact_dir``, a row a cell
    (in ``configs.all_cells()`` order), each column "pod / multipod":
    status, argument GiB a device, GFLOPs a device, collective GiB a
    device, and model FLOPs over the counted FLOPs."""
    from repro_torch import configs as C

    def cols(rec):
        if rec is None or rec["status"] != "ok":
            return ("missing" if rec is None else rec["status"],
                    "—", "—", "—", "—")
        ratio = (rec["model_flops"]["model_flops_global"]
                 / rec["cost"]["flops_total"])
        return ("ok", f"{rec['memory']['argument_bytes'] / 2**30:.4g}",
                f"{rec['cost']['flops'] / 1e9:.4g}",
                f"{rec['collectives']['total_bytes'] / 2**30:.4g}",
                f"{ratio:.3f}")

    lines = ["| cell | status | argument GiB a device | GFLOPs a device | "
             "collective GiB a device | model / counted FLOPs |",
             "| --- | --- | --- | --- | --- | --- |"]
    for arch, shape in C.all_cells():
        recs = []
        for mesh in ("pod", "multipod"):
            path = os.path.join(artifact_dir, f"{arch}__{shape}__{mesh}.json")
            recs.append(json.load(open(path)) if os.path.exists(path)
                        else None)
        pod, multi = (cols(r) for r in recs)
        lines.append(f"| {arch} {shape} | " + " | ".join(
            a if a == b else f"{a} / {b}" for a, b in zip(pod, multi)) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", choices=["pod", "multipod", "both"],
                   default="pod")
    p.add_argument("--all", action="store_true",
                   help="every cell of configs.all_cells(), one subprocess "
                        "a cell")
    p.add_argument("--jobs", type=int, default=1,
                   help="with --all, cells traced at once")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--summary", action="store_true",
                   help="print the records under --artifact-dir as a "
                        "table")
    p.add_argument("--artifact-dir", default=None)
    p.add_argument("--variant", default="",
                   help="config overrides, e.g. n_microbatches=4 (record "
                        "tagged arch@variant)")
    args = p.parse_args(argv)
    artifact_dir = args.artifact_dir or ARTIFACT_DIR
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if args.summary:
        print(summary(artifact_dir))
        return
    if args.all:
        from repro_torch import configs as C

        # a subprocess a cell: one cell's failure leaves the others, and a
        # rerun with --skip-existing picks up where it stopped (an error
        # record is traced again). The cheaper families go first, so a
        # time limit cuts the dearest cells.
        todo = []
        for arch, shape in sorted(C.all_cells(), key=_trace_cost):
            for mesh_kind in meshes:
                fname = os.path.join(artifact_dir,
                                     f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_existing and _finished(fname):
                    print(f"CACHED {arch}/{shape}/{mesh_kind}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh",
                       mesh_kind, "--artifact-dir", artifact_dir]
                todo.append(((arch, shape, mesh_kind), cmd))
        t0 = time.perf_counter()
        failures, running = [], []

        def stop(signum, frame):  # a time limit: end the cells in flight
            for _, proc in running:
                proc.terminate()
            sys.exit(128 + signum)

        signal.signal(signal.SIGTERM, stop)
        while todo or running:
            while todo and len(running) < max(1, args.jobs):
                cell, cmd = todo.pop(0)
                running.append((cell, subprocess.Popen(cmd)))
            time.sleep(0.2)
            for item in list(running):
                cell, proc = item
                if proc.poll() is not None:
                    running.remove(item)
                    if proc.returncode != 0:
                        failures.append(cell)
        print(f"wall {time.perf_counter() - t0:.1f} s")
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all cells green")
        return

    rec = run_cell(args.arch, args.shape, meshes[0], artifact_dir,
                   variant=args.variant)
    if rec["status"] == "error":
        sys.exit(1)


if __name__ == "__main__":
    main()
