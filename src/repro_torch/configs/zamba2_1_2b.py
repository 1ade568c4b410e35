"""Zamba2-1.2B: 38L, d=2048, Mamba2 backbone + shared full-attn blocks.

[arXiv:2411.15242; hf]. ssm_state=64. 32 Mamba2 layers with a *shared*
(parameter-tied) attention+FFN block invoked 6 times, interleaved every 6
layers — expressed here as 6 repeats of (5 mamba2 + 1 shared attn) plus a
2-layer mamba2 tail. Shared attn: 32H MHA (kv=32), head_dim 64.
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, LinearSpec, ModelConfig)


def build() -> ModelConfig:
    # Mamba2: expand=2 -> inner 4096 = 32 heads x 128 value dim; state N=64.
    mamba = LinearSpec(kind="mamba2", heads=32, key_dim=64, value_dim=128,
                       conv_kernel=4)
    attn = AttentionSpec(kind="full", q_heads=32, kv_heads=32, head_dim=64,
                         rope=True)
    no_ffn = FFNSpec(kind="none")
    ffn = FFNSpec(kind="dense", d_ff=8192, activation="swiglu")
    m_block = BlockSpec(mixer=mamba, ffn=no_ffn)
    shared_attn = BlockSpec(mixer=attn, ffn=ffn, shared=True)
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        d_model=2048,
        vocab_size=32000,
        groups=(
            GroupSpec(blocks=(m_block, m_block, m_block, m_block, m_block,
                              shared_attn), repeats=6),
            GroupSpec(blocks=(m_block,), repeats=2),
        ),
        max_seq_len=1_048_576,
        source="arXiv:2411.15242",
        notes="Mamba2 + shared attn blocks (params tied across 6 invocations).",
    )
