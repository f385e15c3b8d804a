"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H (GQA
kv=16) d_ff=1408 (MoE expert width) vocab=151936, MoE 60 routed top-4 + 4
shared experts."""
import torch

from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, lm_cells


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        n_experts=60,
        top_k=4,
        moe_d_ff=1408,
        n_shared_experts=4,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        dtype=torch.bfloat16,
        remat_policy="minimal",
        n_microbatches=8,  # the reference's value; neither trainer reads it
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        top_k=4,
        moe_d_ff=32,
        n_shared_experts=2,
        moe_group_size=64,
        qkv_bias=True,
        tie_embeddings=False,
        dtype=torch.float32,
        remat_policy="none",
        query_chunk=64,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen2-moe-a2.7b",
        family="lm",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=lm_cells(full_attention_only=True),
    )
