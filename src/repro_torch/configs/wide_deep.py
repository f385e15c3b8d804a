"""wide-deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32 mlp=1024-512-256,
concat interaction + wide linear branch."""
from repro_torch.models.recsys import RecsysConfig, criteo_vocab

from .base import ArchSpec, RECSYS_CELLS


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="wide-deep",
        model="wide_deep",
        n_sparse=40,
        embed_dim=32,
        vocab_sizes=tuple(criteo_vocab(40)),
        mlp=(1024, 512, 256),
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="wide-deep-reduced",
        model="wide_deep",
        n_sparse=8,
        embed_dim=8,
        vocab_sizes=tuple([64] * 8),
        mlp=(32, 16),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="wide-deep",
        family="recsys",
        source="arXiv:1606.07792",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=RECSYS_CELLS,
    )
