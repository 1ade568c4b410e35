"""The port's copies of the reference's pure-Python control plane: block
pool, hybrid prefix cache, global KV manager, hardware profiles, throughput
model, router, link topology, workloads, and the cluster simulator with its
vector engine, prefix cache and autoscaler (imports rewritten, nothing
else changed)."""
from repro_torch.core.autoscaler import (Autoscaler, AutoscalerConfig,
                                         StageTelemetry)
from repro_torch.core.blockpool import PREFIX, TRANSFER, Block, BlockPool
from repro_torch.core.hardware import (CHIPS, AnalyticProfile, Calibration,
                                       CalibratedProfile, ChipSpec,
                                       PaperProfile, Profile,
                                       paper_h20_profile, paper_h200_profile)
from repro_torch.core.kv_manager import GlobalKVManager, MatchInfo
from repro_torch.core.prefix_cache import (FullAttnGroup, HybridPrefixCache,
                                           LinearStateGroup,
                                           token_block_hashes)
from repro_torch.core.router import (PD, PRFAAS, Router, RouterConfig,
                                     RoutingDecision)
from repro_torch.core.simulator import (EventPool, PrfaasSimulator, Request,
                                        SimConfig)
from repro_torch.core.throughput_model import (SystemConfig, ThroughputModel,
                                               egress_bandwidth, kv_throughput,
                                               split_even)
from repro_torch.core.transfer import (Flow, Link, LinkTopology,
                                       layerwise_release, star_pairs)
from repro_torch.core.workload import (LogNormalLengths, Trace, Workload,
                                       conversation_trace, diurnal_trace,
                                       flash_crowd_trace, mmpp_rate)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "StageTelemetry",
    "Block", "BlockPool", "PREFIX", "TRANSFER",
    "CHIPS", "ChipSpec", "Profile", "PaperProfile", "AnalyticProfile",
    "Calibration", "CalibratedProfile",
    "paper_h200_profile", "paper_h20_profile",
    "GlobalKVManager", "MatchInfo",
    "FullAttnGroup", "HybridPrefixCache", "LinearStateGroup",
    "token_block_hashes",
    "Router", "RouterConfig", "RoutingDecision", "PD", "PRFAAS",
    "EventPool", "PrfaasSimulator", "Request", "SimConfig",
    "SystemConfig", "ThroughputModel", "egress_bandwidth", "kv_throughput",
    "split_even",
    "Flow", "Link", "LinkTopology", "layerwise_release", "star_pairs",
    "LogNormalLengths", "Trace", "Workload", "mmpp_rate",
    "diurnal_trace", "flash_crowd_trace", "conversation_trace",
]
