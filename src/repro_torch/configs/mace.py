"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant higher-order message passing
(Cartesian irreps, see models/mace.py).

The assigned GNN shapes are citation/product graphs without atomic positions;
the data pipeline synthesises 3D coordinates so the geometric model is
exercised at the published scales.
"""
import dataclasses

import torch

from repro_torch.models.mace import MACEConfig

from .base import ArchSpec, GNN_CELLS


def make_config() -> MACEConfig:
    return MACEConfig(
        name="mace",
        n_layers=2,
        channels=128,
        l_max=2,
        correlation=3,
        n_rbf=8,
        d_feat=1,       # overridden per shape by for_shape
        r_cut=5.0,
        dtype=torch.bfloat16,
        remat=True,
    )


def for_shape(cfg: MACEConfig, d_feat: int) -> MACEConfig:
    return dataclasses.replace(cfg, d_feat=d_feat)


def make_reduced() -> MACEConfig:
    return MACEConfig(
        name="mace-reduced",
        n_layers=2,
        channels=16,
        n_rbf=4,
        d_feat=8,
        radial_hidden=16,
        readout_hidden=8,
        dtype=torch.float32,
        remat=False,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mace",
        family="gnn",
        source="arXiv:2206.07697",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=GNN_CELLS,
    )
