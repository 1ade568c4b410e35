from repro_torch.serving.api import Request, Response
from repro_torch.serving.deployment import CrossDCDeployment, DeploymentConfig
from repro_torch.serving.engine import (ChunkedPrefill, DecodeEngine,
                                        PrefillEngine, RegionScheduler,
                                        next_pow2, trim_request_cache)

__all__ = ["Request", "Response", "CrossDCDeployment", "DeploymentConfig",
           "ChunkedPrefill", "DecodeEngine", "PrefillEngine",
           "RegionScheduler", "next_pow2", "trim_request_cache"]
