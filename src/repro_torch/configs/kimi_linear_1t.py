"""The paper's case-study model: internal 1T hybrid following Kimi Linear.

Proxy reconstruction (the internal model is unpublished): interleaved
KDA:MLA at 3:1 [arXiv:2510.26692], 64 layers = 16 x (3 KDA + 1 MLA),
d=7168, MoE FFN sized to ~1T total params.

Calibrated so S_kv(l) matches the paper's Table 5 within ~1%:
  - MLA layers cache (kv_rank 472 + rope 64) = 536 dims/token/layer * 2B
    * 16 layers = 16.75 KiB/token   (paper: ~16.7 KiB/token slope)
  - KDA fixed state: 56 heads x 128 x 128 fp32 = 3.67 MiB/layer * 48 layers
    = 176 MiB + conv tail            (paper: ~174 MiB intercept)
"""
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec, GroupSpec,
                                LinearSpec, ModelConfig)


def build() -> ModelConfig:
    kda = LinearSpec(kind="kda", heads=56, key_dim=128, value_dim=128,
                     conv_kernel=4)
    mla = AttentionSpec(kind="mla", q_heads=64, kv_heads=64, head_dim=128,
                        mla_kv_rank=472, mla_rope_dim=64, mla_q_rank=1536,
                        rope=True)
    moe = FFNSpec(kind="moe", d_ff=2048, activation="swiglu",
                  num_experts=352, top_k=8, shared_experts=1)
    kda_block = BlockSpec(mixer=kda, ffn=moe)
    mla_block = BlockSpec(mixer=mla, ffn=moe)
    return ModelConfig(
        name="kimi-linear-1t",
        family="hybrid",
        d_model=7168,
        vocab_size=163840,
        groups=(GroupSpec(blocks=(kda_block, kda_block, kda_block, mla_block),
                          repeats=16),),
        max_seq_len=1_048_576,
        source="arXiv:2510.26692 (architecture); paper §4 (scale)",
        notes="paper case-study proxy; S_kv(l) calibrated to paper Table 5.",
    )
