"""granite-8b [arXiv:2405.04324]: dense llama-arch 36L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=49152 (code model)."""
import torch

from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, lm_cells


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        qkv_bias=False,
        rope_theta=10_000_000.0,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        remat_policy="minimal",
        n_microbatches=8,  # the reference's value; neither trainer reads it
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="granite-8b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        tie_embeddings=False,
        dtype=torch.float32,
        remat_policy="none",
        query_chunk=64,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="granite-8b",
        family="lm",
        source="arXiv:2405.04324",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=lm_cells(full_attention_only=True),
    )
