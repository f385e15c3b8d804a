"""Turn fitted state of the JAX package, given as numpy arrays, into the port's.

The JAX package's state is a pytree of arrays; ``np.asarray`` of each
field gives what these functions take, so neither package imports the
other. The transform is ``NSimplexTransform`` (``refs``, ``base.chol``,
``base.diag_g``, ``base.d0``, ``k``, ``metric``, ``jitter``); the flat
index is ``launch.serve.ZenIndex`` (``coords``, ``coord_scales``,
``row_ids``, ``n_valid``, ``storage``, ...); the clustered index is
``index.IVFZenIndex`` (``centroids``, ``tile_coords``, ``tile_ids``,
``tile_scales``, ``codebooks``, ...); the tiered store is
``index.ivf.TieredIVFZenIndex`` (``centroids``, ``host_coords``,
``host_ids``, ``host_scales``, ``hot_clusters``, ...); the baselines are
``core.baselines``' ``PCATransform``, ``RandomProjection``,
``MDSTransform`` and ``LMDSTransform`` (their fields by name); the
recsys models are ``models.recsys``' parameter pytrees, the LMs
``models.transformer``'s (bf16 leaves as their 16-bit patterns), the MACE
models ``models.mace``'s, and the optimiser state ``optim.AdamWState``. Feeding
both packages one fitted state lets a test hold the search path, or a
baseline's transform, to the reference without the fit's float noise (or
the k-means and RP draws, or the SVD/eigh sign choices) in between; and
one set of weights lets it hold a model's forward, gradients and training
steps to the reference (``jax.random`` cannot be replayed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import index_io
from repro_torch.checkpoint.checkpoint import flat_state
from repro_torch.core import baselines
from repro_torch.core.projection import NSimplexTransform
from repro_torch.core.simplex import BaseSimplex
from repro_torch.distributed.partition import place
from repro_torch.index.ivf import IVFZenIndex, TieredIVFZenIndex
from repro_torch.kernels import quantize as quant
from repro_torch.launch.serve import ZenIndex
from repro_torch.models import mace, recsys, transformer
from repro_torch.optim import AdamWState


def _tensor(a, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def transform_from_arrays(*, refs: Optional[np.ndarray], chol: np.ndarray,
                          diag_g: np.ndarray, d0: np.ndarray, k: int,
                          metric: str, jitter: float = 0.0,
                          device=None) -> NSimplexTransform:
    """The port's ``NSimplexTransform`` holding exactly these arrays."""
    dev = resolve_device(device)
    f32 = torch.float32
    base = BaseSimplex(chol=_tensor(chol, dev, f32),
                       diag_g=_tensor(diag_g, dev, f32),
                       d0=_tensor(d0, dev, f32))
    return NSimplexTransform(
        k=int(k), metric=metric, jitter=float(jitter),
        refs=None if refs is None else _tensor(refs, dev, f32), base=base)


def _coords(coords: np.ndarray, storage: str, dev) -> torch.Tensor:
    """Storage-dtype coordinates; bf16 travels as its 16-bit pattern (the
    numpy bf16 dtype belongs to ml_dtypes, which the port does not use)."""
    coords = np.asarray(coords)
    if storage == "bfloat16":
        return index_io.to_tensor(coords.view(np.uint16), dev, bfloat16=True)
    return _tensor(coords, dev, quant.torch_dtype(storage))


def index_from_arrays(transform: NSimplexTransform, *, coords: np.ndarray,
                      storage: str = "float32",
                      coord_scales: Optional[np.ndarray] = None,
                      row_ids: Optional[np.ndarray] = None,
                      n_valid: Optional[int] = None, n_deleted: int = 0,
                      corpus: Optional[np.ndarray] = None,
                      generation: int = 0, device=None) -> ZenIndex:
    """The port's flat ``ZenIndex`` holding exactly these arrays."""
    dev = resolve_device(device)
    quant.check_storage(storage)
    return ZenIndex(
        transform=transform,
        coords=_coords(coords, storage, dev),
        corpus=None if corpus is None else _tensor(corpus, dev,
                                                   torch.float32),
        n_valid=None if n_valid is None else int(n_valid),
        row_ids=(None if row_ids is None
                 else _tensor(row_ids, dev, torch.int32)),
        n_deleted=int(n_deleted), storage=storage,
        coord_scales=(None if coord_scales is None
                      else _tensor(coord_scales, dev, torch.float32)),
        generation=int(generation))


def ivf_index_from_arrays(transform: NSimplexTransform, *,
                          centroids: np.ndarray, tile_coords: np.ndarray,
                          tile_ids: np.ndarray, tiles_per_cluster: int,
                          tile_rows: int, n_valid: int, n_deleted: int = 0,
                          storage: str = "float32",
                          tile_scales: Optional[np.ndarray] = None,
                          codebooks: Optional[np.ndarray] = None,
                          generation: int = 0,
                          corpus: Optional[np.ndarray] = None,
                          device=None) -> ZenIndex:
    """The port's ``ZenIndex`` around an ``IVFZenIndex`` holding exactly
    these arrays (a bf16 ``tile_coords`` travels as its 16-bit pattern)."""
    dev = resolve_device(device)
    quant.check_storage(storage)
    f32 = torch.float32
    n_clusters = int(np.asarray(centroids).shape[0])
    ivf = IVFZenIndex(
        centroids=_tensor(centroids, dev, f32),
        tile_coords=_coords(tile_coords, storage, dev),
        tile_ids=_tensor(tile_ids, dev, torch.int32),
        n_clusters=n_clusters, tiles_per_cluster=int(tiles_per_cluster),
        tile_rows=int(tile_rows), n_valid=int(n_valid),
        n_deleted=int(n_deleted), storage=storage,
        tile_scales=(None if tile_scales is None
                     else _tensor(tile_scales, dev, f32)),
        codebooks=None if codebooks is None else _tensor(codebooks, dev, f32),
        generation=int(generation))
    return ZenIndex(
        transform=transform, coords=None,
        corpus=None if corpus is None else _tensor(corpus, dev, f32),
        storage=storage, generation=int(generation), ivf=ivf)


def tiered_index_from_arrays(transform: Optional[NSimplexTransform], *,
                             centroids: np.ndarray, host_coords: np.ndarray,
                             host_ids: np.ndarray, tiles_per_cluster: int,
                             tile_rows: int, n_valid: int,
                             hot_clusters: np.ndarray,
                             storage: str = "float32",
                             host_scales: Optional[np.ndarray] = None,
                             prefetch_cols: int = 2, n_shards: int = 1,
                             generation: int = 0,
                             corpus: Optional[np.ndarray] = None,
                             device=None) -> ZenIndex:
    """The port's ``ZenIndex`` around a ``TieredIVFZenIndex`` serving
    exactly this host pool with this hot set (a bf16 pool travels as its
    16-bit pattern)."""
    dev = resolve_device(device)
    host_coords = np.asarray(host_coords)
    if storage == "bfloat16":
        host_coords = host_coords.view(np.uint16)
    tiered = TieredIVFZenIndex(
        _tensor(centroids, dev, torch.float32), host_coords,
        np.asarray(host_ids, np.int32),
        n_clusters=int(np.asarray(centroids).shape[0]),
        tiles_per_cluster=int(tiles_per_cluster), tile_rows=int(tile_rows),
        n_valid=int(n_valid), storage=storage,
        host_scales=None if host_scales is None else np.asarray(host_scales),
        hot_clusters=np.asarray(hot_clusters, np.int64),
        prefetch_cols=prefetch_cols, n_shards=n_shards,
        generation=int(generation))
    return ZenIndex(
        transform=transform, coords=None,
        corpus=None if corpus is None else _tensor(corpus, dev,
                                                   torch.float32),
        storage=storage, generation=int(generation), ivf=tiered)


_BASELINES = {"pca": baselines.PCATransform,
              "rp": baselines.RandomProjection,
              "mds": baselines.MDSTransform,
              "lmds": baselines.LMDSTransform}


def baseline_from_arrays(kind: str, *, k: int, device=None, **arrays):
    """The port's fitted baseline ``kind`` ("pca", "rp", "mds" or "lmds")
    holding exactly these f32 arrays, passed by the reference's field
    names (``mean``, ``components``, ``matrix``, ``pinv_coords``, ...);
    a field left out or given as ``None`` stays ``None``."""
    cls = _BASELINES[kind]
    fields = {f.name for f in dataclasses.fields(cls)} - {"k"}
    unknown = set(arrays) - fields
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}; "
                         f"it has {sorted(fields)}")
    dev = resolve_device(device)
    return cls(k=int(k), **{
        name: None if a is None else _tensor(a, dev, torch.float32)
        for name, a in arrays.items()})


def _flat_tensors(tree, dev) -> dict:
    """A nested pytree of arrays as dotted name -> tensor (dtype kept)."""
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in flat_state(tree).items()}


def recsys_params_from_arrays(cfg: recsys.RecsysConfig, tree: dict, *,
                              device=None, mesh=None,
                              specs: Optional[dict] = None):
    """The port's model holding exactly this parameter pytree: a
    ``RecsysModel`` from ``init_params``' tree, a ``TwoTowerModel`` from
    ``init_two_tower_params``' (it has ``items``). With ``mesh`` (a (data,
    model) ``distributed.Mesh``): a ``recsys.ShardedRecsys`` of
    ``init_params``' tree, each leaf in its ``RecsysModel`` dtype, laid out
    by ``specs`` (name -> ``sharding.P``; the reference's rules by
    default)."""
    if mesh is not None:
        if "items" in tree:
            raise ValueError("the two-tower model is not laid out on a mesh")
        specs = recsys.param_specs(cfg) if specs is None else specs
        dtypes = {n: p.dtype for n, p in recsys.RecsysModel(
            cfg, device="meta").named_parameters()}
        if set(flat_state(tree)) != set(dtypes):
            raise ValueError(f"the tree holds {sorted(flat_state(tree))}, "
                             f"{cfg.name} {sorted(dtypes)}")
        return recsys.ShardedRecsys(cfg, mesh, _placed(tree, dtypes, mesh,
                                                       specs))
    dev = resolve_device(device)
    model = (recsys.TwoTowerModel(cfg, int(np.asarray(tree["items"])
                                           .shape[0]), device=dev)
             if "items" in tree else recsys.RecsysModel(cfg, device=dev))
    model.load_state_dict(_flat_tensors(tree, dev), strict=True)
    return model


def _leaf_tensor(a, dtype: torch.dtype, dev) -> torch.Tensor:
    """One leaf as a ``dtype`` tensor: a bf16 array (numpy's ``u2`` bits or
    an ``ml_dtypes`` bfloat16 array, read through its bits) keeps its
    bits; any other array is converted."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype == np.uint16
                                      and dtype == torch.bfloat16):
        return index_io.to_tensor(a.view(np.uint16), dev,
                                  bfloat16=True).to(dtype)
    return torch.as_tensor(np.array(a), device=dev).to(dtype)


def _placed(params: dict, dtype, mesh, specs: dict) -> dict:
    """Every leaf of a parameter pytree laid out on ``mesh`` by its spec,
    in ``dtype`` (one, or name -> dtype), each shard a leaf that requires
    a gradient."""
    leaves = {}
    for k, v in flat_state(params).items():
        dt = dtype[k] if isinstance(dtype, dict) else dtype
        leaves[k] = place(_leaf_tensor(v, dt, mesh.local_device),
                          specs[k], mesh)
        for s in leaves[k].shards:
            s.requires_grad_(True)
    return leaves


def transformer_from_arrays(cfg: transformer.TransformerConfig,
                            params: dict, *, device=None, mesh=None,
                            specs: Optional[dict] = None):
    """The port's LM holding exactly this parameter pytree (the
    reference's ``init_params`` layout: ``embed``, ``layers`` of stacked
    (G, PL, ...) leaves, ``final_norm``, ``lm_head``), each leaf in
    ``cfg.dtype``. With ``mesh`` (a (data, model) ``distributed.Mesh``):
    a ``transformer.ShardedTransformer`` whose leaves are laid out by
    ``specs`` (name -> ``sharding.P``; the reference's rules by
    default)."""
    if mesh is not None:
        specs = transformer.param_specs(cfg) if specs is None else specs
        return transformer.ShardedTransformer(
            cfg, mesh, _placed(params, cfg.dtype, mesh, specs))
    dev = resolve_device(device)
    model = transformer.Transformer(cfg, device=dev)
    model.load_state_dict({k: _leaf_tensor(v, cfg.dtype, dev)
                           for k, v in flat_state(params).items()},
                          strict=True)
    return model


def mace_from_arrays(cfg: mace.MACEConfig, params: dict, *, device=None,
                     mesh=None, specs: Optional[dict] = None):
    """The port's MACE model holding exactly this parameter pytree (the
    reference's ``init_params`` layout: ``embed`` and a list ``layers`` of
    dicts of leaves), each leaf in ``cfg.dtype``. With ``mesh`` (a (data,
    model) ``distributed.Mesh``): a ``mace.ShardedMACE`` whose leaves are
    laid out by ``specs`` (name -> ``sharding.P``; the reference's rules
    by default)."""
    if mesh is not None:
        specs = mace.param_specs(cfg) if specs is None else specs
        return mace.ShardedMACE(cfg, mesh, _placed(params, cfg.dtype, mesh,
                                                   specs))
    dev = resolve_device(device)
    model = mace.MACE(cfg, device=dev)
    model.load_state_dict({k: _leaf_tensor(v, cfg.dtype, dev)
                           for k, v in flat_state(params).items()},
                          strict=True)
    return model


def adamw_state_from_arrays(tree, *, device=None) -> AdamWState:
    """The port's ``AdamWState`` from the reference's ``(step, mu, nu)``."""
    dev = resolve_device(device)
    step, mu, nu = tree
    return AdamWState(
        step=torch.as_tensor(np.array(step), dtype=torch.int32, device=dev),
        mu=_flat_tensors(mu, dev), nu=_flat_tensors(nu, dev))
