"""Architecture registry of the port: every architecture of the
reference, under the reference's names.  The encoder-decoder
(``seamless-m4t-medium``) and the VLM (``phi-3-vision-4.2b``) run through
``Model.prefill`` / ``decode_step`` only, as in the reference; the others
are served."""
from repro_torch.configs import (granite_20b, h2o_danube_1_8b,
                                 kimi_linear_1t, llama4_scout,
                                 mistral_nemo_12b, mixtral_8x22b,
                                 phi3_vision_4_2b, qwen2_5_3b,
                                 seamless_m4t_medium, xlstm_350m,
                                 zamba2_1_2b)
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, LinearSpec, ModelConfig,
                                      reduce_for_smoke)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells

ARCH_BUILDERS = {
    "kimi-linear-1t": kimi_linear_1t.build,
    "mistral-nemo-12b": mistral_nemo_12b.build,
    "zamba2-1.2b": zamba2_1_2b.build,
    "h2o-danube-1.8b": h2o_danube_1_8b.build,
    "qwen2.5-3b": qwen2_5_3b.build,
    "granite-20b": granite_20b.build,
    "xlstm-350m": xlstm_350m.build,
    "llama4-scout-17b-a16e": llama4_scout.build,
    "mixtral-8x22b": mixtral_8x22b.build,
    "seamless-m4t-medium": seamless_m4t_medium.build,
    "phi-3-vision-4.2b": phi3_vision_4_2b.build,
}


# the reference's ten assigned architectures (its dry-run grid), without
# the paper's own case-study model
ASSIGNED_ARCHS = [k for k in ARCH_BUILDERS if k != "kimi-linear-1t"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_BUILDERS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_BUILDERS)}")
    return ARCH_BUILDERS[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_for_smoke(get_config(name))


def all_configs(assigned_only: bool = True):
    names = ASSIGNED_ARCHS if assigned_only else list(ARCH_BUILDERS)
    return {n: get_config(n) for n in names}


__all__ = ["ARCH_BUILDERS", "ASSIGNED_ARCHS", "SHAPES", "ShapeSpec", "cells",
           "get_config", "get_smoke_config", "all_configs", "ModelConfig",
           "AttentionSpec", "LinearSpec", "FFNSpec", "BlockSpec", "GroupSpec",
           "reduce_for_smoke"]
