"""gemma2-2b [arXiv:2408.00118]: dense 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local(4096)/global alternating attention, logit softcaps,
GeGLU, post-norms, (1+w) RMSNorm, sqrt(d) embedding scale, head_dim 256.

long_500k RUNS for this arch: the alternating local/global layout keeps half
the stack's KV at the 4096-token window (sub-quadratic sliding-window path);
the decode step lowers a mixed ring/full cache (DESIGN.md §Arch-applicability).
"""
import torch

from repro_torch.models.transformer import TransformerConfig

from .base import ArchSpec, lm_cells


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab_size=256000,
        layer_pattern=(4096, 0),  # local window 4096, then global
        logit_softcap=30.0,
        attn_softcap=50.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        act="gelu",
        rope_theta=10_000.0,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        remat_policy="minimal",
        n_microbatches=4,  # the reference's value; neither trainer reads it
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-reduced",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=128,
        vocab_size=512,
        layer_pattern=(16, 0),
        logit_softcap=30.0,
        attn_softcap=50.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        act="gelu",
        tie_embeddings=True,
        dtype=torch.float32,
        remat_policy="none",
        query_chunk=64,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="gemma2-2b",
        family="lm",
        source="arXiv:2408.00118",
        make_config=make_config,
        make_reduced=make_reduced,
        cells=lm_cells(full_attention_only=False),  # hybrid: long_500k runs
    )
