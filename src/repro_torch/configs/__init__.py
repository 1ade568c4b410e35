"""Architecture registry of the port: the architectures it can serve."""
from repro_torch.configs import kimi_linear_1t
from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      GroupSpec, LinearSpec, ModelConfig,
                                      reduce_for_smoke)

ARCH_BUILDERS = {
    "kimi-linear-1t": kimi_linear_1t.build,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_BUILDERS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_BUILDERS)}")
    return ARCH_BUILDERS[name]()


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_for_smoke(get_config(name))


__all__ = ["ARCH_BUILDERS", "get_config", "get_smoke_config", "ModelConfig",
           "AttentionSpec", "LinearSpec", "FFNSpec", "BlockSpec", "GroupSpec",
           "reduce_for_smoke"]
