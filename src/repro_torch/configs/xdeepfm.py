"""xdeepfm [arXiv:1803.05170]: n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400, CIN (compressed interaction network) + DNN + linear."""
from repro_torch.models.recsys import RecsysConfig, criteo_vocab

from .base import ArchSpec, RECSYS_CELLS


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm",
        model="xdeepfm",
        n_sparse=39,
        embed_dim=10,
        vocab_sizes=tuple(criteo_vocab(39)),
        cin_layers=(200, 200, 200),
        mlp=(400, 400),
    )


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        name="xdeepfm-reduced",
        model="xdeepfm",
        n_sparse=8,
        embed_dim=8,
        vocab_sizes=tuple([64] * 8),
        cin_layers=(16, 16),
        mlp=(32, 32),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="xdeepfm",
        family="recsys",
        source="arXiv:1803.05170",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=RECSYS_CELLS,
    )
