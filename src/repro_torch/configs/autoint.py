"""autoint [arXiv:1810.11921]: n_sparse=39 embed_dim=16 n_attn_layers=3
n_heads=2 d_attn=32, self-attention feature interaction."""
from repro_torch.models.recsys import RecsysConfig, criteo_vocab

from .base import ArchSpec, RECSYS_CELLS


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="autoint",
        model="autoint",
        n_sparse=39,
        embed_dim=16,
        vocab_sizes=tuple(criteo_vocab(39)),
        n_attn_layers=3,
        n_heads=2,
        d_attn=32,
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="autoint-reduced",
        model="autoint",
        n_sparse=8,
        embed_dim=16,
        vocab_sizes=tuple([64] * 8),
        n_attn_layers=2,
        n_heads=2,
        d_attn=16,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="autoint",
        family="recsys",
        source="arXiv:1810.11921",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=RECSYS_CELLS,
    )
