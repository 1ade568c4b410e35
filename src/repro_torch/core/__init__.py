"""The control plane the live deployment needs: block pool, hybrid prefix
cache, global KV manager, analytic profile, throughput model, router and
link topology (copies of the reference's pure-Python modules)."""
from repro_torch.core.blockpool import PREFIX, TRANSFER, Block, BlockPool
from repro_torch.core.hardware import CHIPS, AnalyticProfile, ChipSpec
from repro_torch.core.kv_manager import GlobalKVManager
from repro_torch.core.prefix_cache import HybridPrefixCache
from repro_torch.core.router import (PD, PRFAAS, Router, RouterConfig,
                                     RoutingDecision)
from repro_torch.core.throughput_model import (SystemConfig, ThroughputModel,
                                               split_even)
from repro_torch.core.transfer import Link, LinkTopology, star_pairs
from repro_torch.core.workload import Workload

__all__ = [
    "PREFIX", "TRANSFER", "Block", "BlockPool", "CHIPS", "AnalyticProfile",
    "ChipSpec", "GlobalKVManager", "HybridPrefixCache", "PD", "PRFAAS",
    "Router", "RouterConfig", "RoutingDecision", "SystemConfig",
    "ThroughputModel", "split_even", "Link", "LinkTopology", "star_pairs",
    "Workload",
]
