"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: dense 24L d_model=1024 16H (GQA kv=16)
d_ff=2816 vocab=151936, QKV bias."""
import torch

from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, lm_cells


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-0.5b",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        remat_policy="minimal",
        n_microbatches=2,  # the reference's value; neither trainer reads it
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
        dtype=torch.float32,
        remat_policy="none",
        query_chunk=64,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen1.5-0.5b",
        family="lm",
        source="hf:Qwen/Qwen1.5-0.5B",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=lm_cells(full_attention_only=True),
    )
