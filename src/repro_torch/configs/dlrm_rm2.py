"""dlrm-rm2 [arXiv:1906.00091]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1, dot interaction. Embedding
tables use the public Criteo Kaggle cardinalities (~33.8M rows)."""
from repro_torch.models.recsys import CRITEO_26, RecsysConfig

from .base import ArchSpec, RECSYS_CELLS


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-rm2",
        model="dlrm",
        n_sparse=26,
        embed_dim=64,
        vocab_sizes=tuple(CRITEO_26),
        n_dense=13,
        bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1),
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-reduced",
        model="dlrm",
        n_sparse=8,
        embed_dim=16,
        vocab_sizes=tuple([64] * 8),
        n_dense=13,
        bot_mlp=(32, 16),
        top_mlp=(32, 16, 1),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dlrm-rm2",
        family="recsys",
        source="arXiv:1906.00091",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=RECSYS_CELLS,
    )
