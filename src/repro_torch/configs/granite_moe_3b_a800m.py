"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family]: 32L d_model=1536
24H (GQA kv=8) d_ff=512 (expert width), MoE 40 experts top-8."""
import torch

from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, lm_cells


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-3b-a800m",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=40,
        top_k=8,
        moe_d_ff=512,
        n_shared_experts=0,
        qkv_bias=False,
        rope_theta=10_000.0,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        remat_policy="minimal",
        n_microbatches=8,  # the reference's value; neither trainer reads it
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-reduced",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        top_k=4,
        moe_d_ff=32,
        moe_group_size=64,
        tie_embeddings=True,
        dtype=torch.float32,
        remat_policy="none",
        query_chunk=64,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="granite-moe-3b-a800m",
        family="lm",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=lm_cells(full_attention_only=True),
    )
