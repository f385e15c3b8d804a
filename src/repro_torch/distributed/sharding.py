"""Sharding rules: parameter and input partition specs per architecture
family (PyTorch counterpart of ``repro.distributed.sharding``).

Conventions (the reference's):
  * ``model`` axis: tensor/expert parallel — attention heads and FFN width
    for LMs, the expert dimension for MoE, channels for MACE, embedding
    rows and vocabulary for recsys tables and LM heads;
  * data axes (``data`` alone, or ``("pod", "data")`` on the multi-pod
    mesh): batch / sequence (500k decode) / edges;
  * optimizer moments inherit the parameter specs.

A spec (:class:`P`) has one entry a leading dimension of its leaf: an axis
name, a tuple of axis names, or None (not sharded); trailing dimensions it
does not name are not sharded. The rules match the reference's path form
(``layers/wq``), which is the port's parameter name with ``/`` for ``.``,
and keep the reference's first-match order (``layers/ws_gate_logit``
before its prefix ``layers/ws_gate``) and its rank guard.

``spec_to_json`` / ``spec_from_json`` are the checkpoint manifest's form
(``repro.checkpoint.checkpoint._spec_to_json``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.optim.adamw import AdamWState

Axis = Optional[Union[str, Tuple[str, ...]]]


class P:
    """A partition spec: ``P(None, "model")``, ``P(("data", "model"),
    None)``, ``P()`` (replicated). Not a tuple, so a tree of specs keeps
    each spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Axis):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}" if len(self.entries) != 1 \
            else f"P({self.entries[0]!r})"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dimension ``dim`` is sharded over (none past the
        spec's length)."""
        e = self.entries[dim] if dim < len(self.entries) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)


def spec_to_json(spec: Optional[P]) -> list:
    if spec is None:
        return []
    return [list(ax) if isinstance(ax, tuple) else ax for ax in spec]


def spec_from_json(obj) -> P:
    return P(*[tuple(ax) if isinstance(ax, list) else ax for ax in obj])


def data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def mesh_data_axes(mesh):
    """The data axes of ``mesh``: ("pod", "data") on the multi-pod mesh
    (its ``pod`` axis extends data parallelism), else ``data``."""
    return data_axes("pod" in mesh.axis_names)


def data_replicas(mesh) -> int:
    """How many data replicas ``mesh`` holds: the product of its data
    axes' sizes."""
    axes = mesh_data_axes(mesh)
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= mesh.shape[a]
    return n


def path_of(name: str) -> str:
    """The reference's path form of a port parameter name."""
    return name.replace(".", "/")


def _ndim(leaf) -> int:
    if hasattr(leaf, "dim") and callable(leaf.dim):
        return leaf.dim()
    if hasattr(leaf, "ndim"):
        return int(leaf.ndim)
    return len(tuple(leaf))


def _leaves(params) -> Dict[str, Any]:
    """name -> leaf (a tensor, or a shape) of a module or a mapping."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


# -- LM transformer ------------------------------------------------------------

_LM_RULES = [
    # (path substring, spec builder given leaf ndim)
    ("embed", lambda nd: P("model", None)),
    ("lm_head", lambda nd: P(None, "model")),
    ("final_norm", lambda nd: P(None)),
    ("layers/wq", lambda nd: P(None, None, None, "model")),
    ("layers/wk", lambda nd: P(None, None, None, "model")),
    ("layers/wv", lambda nd: P(None, None, None, "model")),
    ("layers/wo", lambda nd: P(None, None, "model", None)),
    ("layers/bq", lambda nd: P(None, None, "model")),
    ("layers/bk", lambda nd: P(None, None, "model")),
    ("layers/bv", lambda nd: P(None, None, "model")),
    ("layers/w_gate", lambda nd: P(None, None, None, "model")),
    ("layers/w_up", lambda nd: P(None, None, None, "model")),
    ("layers/w_down", lambda nd: P(None, None, "model", None)),
    ("layers/router", lambda nd: P(None, None, None, "model")),
    ("layers/we_gate", lambda nd: P(None, None, "model", None, None)),
    ("layers/we_up", lambda nd: P(None, None, "model", None, None)),
    ("layers/we_down", lambda nd: P(None, None, "model", None, None)),
    ("layers/ws_gate_logit", lambda nd: P()),
    ("layers/ws_gate", lambda nd: P(None, None, None, "model")),
    ("layers/ws_up", lambda nd: P(None, None, None, "model")),
    ("layers/ws_down", lambda nd: P(None, None, "model", None)),
    ("layers/ln", lambda nd: P()),
]


def lm_param_specs(params) -> Dict[str, P]:
    def spec_for(name, leaf):
        s, nd = path_of(name), _ndim(leaf)
        for frag, builder in _LM_RULES:
            if frag in s:
                sp = builder(nd)
                # guard: rule rank must not exceed leaf rank
                if len(sp) <= nd or sp == P():
                    return sp
        return P()

    return {n: spec_for(n, leaf) for n, leaf in _leaves(params).items()}


# -- MACE ------------------------------------------------------------------


def gnn_param_specs(params) -> Dict[str, P]:
    """Channel-mixing linears shard their *output* channels over model; the
    radial MLP output (C * n_paths) also shards over model."""

    def spec_for(name):
        s = path_of(name)
        if "embed" in s:
            return P(None, "model")
        if "rad_w2" in s:
            return P(None, None, "model")
        if "msg" in s:
            return P(None, "model", None)
        if "self" in s:
            return P("model", None)
        if "w_corr" in s:
            return P("model")
        if "ro_w1" in s:
            return P("model", None)
        return P()

    return {n: spec_for(n) for n in _leaves(params)}


# -- RecSys ------------------------------------------------------------------


def recsys_param_specs(params) -> Dict[str, P]:
    def spec_for(name):
        s = path_of(name)
        if s in ("table",) or s.endswith("/table") or "wide" in s \
                or "linear" in s:
            return P("model", None)  # row-sharded embedding tables
        if "deep/0/w" in s or "dnn/0/w" in s:
            return P(None, "model")
        return P()

    return {n: spec_for(n) for n in _leaves(params)}


def param_specs(family: str, params) -> Dict[str, P]:
    return {
        "lm": lm_param_specs,
        "gnn": gnn_param_specs,
        "recsys": recsys_param_specs,
    }[family](params)


def opt_state_specs(param_spec: Mapping[str, P]) -> AdamWState:
    """AdamW moments inherit parameter sharding; step is replicated."""
    return AdamWState(step=P(), mu=dict(param_spec), nu=dict(param_spec))


# -- input shardings per cell ---------------------------------------------------


def lm_input_shardings(cell_kind: str, shape: str, multi_pod: bool,
                       cfg=None) -> dict:
    dp = data_axes(multi_pod)
    if cell_kind == "train":
        return {"batch": {"tokens": P(dp, None)}}
    if cell_kind == "prefill":
        return {"tokens": P(dp, None)}
    if cell_kind == "decode":
        if shape == "long_500k":
            # batch = 1: sequence-parallel cache over the entire mesh
            seq_axes = (("pod", "data", "model") if multi_pod
                        else ("data", "model"))
            cache_spec = P(None, None, seq_axes, None, None)
            token_spec = P(None, None)
        else:
            cache_spec = P(None, dp, "model", None, None)
            token_spec = P(dp, None)
        return {
            "cache": cache_spec,  # broadcast to every cache leaf by caller
            "token": token_spec,
            "cache_len": P(),
        }
    raise ValueError(cell_kind)


def gnn_input_shardings(multi_pod: bool) -> dict:
    dp = data_axes(multi_pod)
    return {
        "batch": {
            "positions": P(),
            "node_feat": P(),
            "senders": P(dp),
            "receivers": P(dp),
            "edge_mask": P(dp),
            "node_mask": P(),
            "node_graph": P(),
            "target_energy": P(),
            "target_nodes": P(),
            "loss_node_mask": P(),
        }
    }


def recsys_input_shardings(cell_kind: str, multi_pod: bool) -> dict:
    dp = data_axes(multi_pod)
    out = {"batch": {"sparse": P(dp, None), "dense": P(dp, None),
                     "labels": P(dp)}}
    if cell_kind == "retrieval":
        # candidates row-sharded over the full mesh
        rows = ("pod", "data", "model") if multi_pod else ("data", "model")
        out["candidates"] = P(rows, None)
        out["batch"] = {"sparse": P(None, None), "dense": P(None, None),
                        "labels": P(None)}
    return out
