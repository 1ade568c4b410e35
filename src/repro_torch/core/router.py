"""Short-term scheduling: bandwidth- and cache-aware request routing
(paper §3.4.3, short-term loop).

Each request originates at a *home* PD cluster (its region).  Decision per
request (incremental uncached length l after prefix matching):
  * l > t      -> PrfaaS cluster (remote long-context prefill)
  * l <= t     -> home PD-P (local prefill)
with the paper's two cache-aware regimes:
  * bandwidth SCARCE  -> evaluate home and PrfaaS prefixes independently:
       if l_total - l_home <= t : prefill locally (use home's own cache)
       else                     : offload (use PrfaaS's own cache)
  * bandwidth ABUNDANT -> use the best cache anywhere across ALL clusters
       l_prefix = max over clusters; route on l_total - l_prefix and
       cross-transfer the cache when the owning cluster differs from the
       prefill target (the caller charges the owner<->target pair link).

The caller passes only the cluster matches reachable from ``home`` over the
link topology, so an unlinked region's cache is never chosen.  The classic
two-cluster deployment is ``home == PD`` with matches {PRFAAS, PD} and
reproduces the original decision table exactly.

This Router is the ONE routing policy in the repo: both the discrete-event
``core.simulator.PrfaasSimulator`` and the live JAX
``serving.CrossDCDeployment`` instantiate it over a
``transfer.LinkTopology`` — which is what makes ``launch.serve
--cross-validate`` (replaying a live run's arrivals through the simulator)
a meaningful policy/actual check.

The threshold t is re-derived from the live profile whenever the congestion
monitor triggers (egress utilization / queue depth), which is the paper's
"short-term routing adjustment".  The threshold is a *per-home vector*:
``observe_congestion(signal, home=...)`` adjusts only that home cluster's t
from its own regional congestion signal (``LinkTopology.dest_signal``), so
a congested region raises its offload bar alone while quiet regions keep
routing normally.  Calling without ``home`` keeps the legacy single global
threshold (two-cluster deployments, direct Router use).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.throughput_model import SystemConfig, ThroughputModel

PRFAAS = "prfaas"
PD = "pd"


@dataclass
class RoutingDecision:
    """One routing verdict.

    ``cross_cache_transfer`` is True when the reused prefix lives in a
    DIFFERENT cluster than ``target`` (abundant-bandwidth regime only: the
    router picks the best cache anywhere, and the cached-prefix KV must be
    copied across the inter-DC link before prefill can reuse it).  The
    simulator charges those ``S_kv(cached_tokens)`` bytes to the link as an
    eager flow — the copy is already materialized, unlike the layer-wise
    pipelined KV of the prefill itself — and decode admission waits for it.
    """

    target: str                  # "prfaas" | a PD cluster name
    cached_tokens: int           # reused prefix at the chosen cluster
    incremental: int             # tokens actually prefilled
    cache_cluster: str           # where the reused prefix lives
    cross_cache_transfer: bool = False
    home: str = PD               # the request's regional PD cluster


@dataclass
class RouterConfig:
    util_high: float = 0.90      # egress-utilization trigger
    queue_high_bytes: float = 2e9
    util_abundant: float = 0.50  # below this, bandwidth is "abundant"
    threshold_boost: float = 1.35  # raise t when congested
    min_threshold: float = 512.0


class Router:
    def __init__(self, model: ThroughputModel, system: SystemConfig,
                 cfg: Optional[RouterConfig] = None):
        self.model = model
        self.system = system
        # a fresh config per router: a dataclass default argument would be
        # one shared mutable instance across every Router in the process
        self.cfg = RouterConfig() if cfg is None else cfg
        self.threshold = system.threshold
        self.base_threshold = system.threshold
        # per-home threshold vector (short-term loop, regionalized): a home
        # without an entry falls back to the global ``threshold`` above
        self._home_t: Dict[str, float] = {}
        self._home_base: Dict[str, float] = {}
        self.adjustments = 0
        self.decisions = {PRFAAS: 0, PD: 0}
        self.cross_transfers = 0

    # ----------------------------------------------------- congestion loop
    def threshold_for(self, home: str) -> float:
        """Current routing threshold for requests originating at ``home``."""
        return self._home_t.get(home, self.threshold)

    @property
    def thresholds(self) -> Dict[str, float]:
        """Per-home threshold vector (homes seen by the congestion loop)."""
        return dict(self._home_t)

    def observe_congestion(self, signal: dict, home: Optional[str] = None):
        """Short-term adjustment: raise t near the bandwidth ceiling (longer
        requests => lower per-request KV throughput), relax it when clear.
        With ``home`` given, only that home cluster's threshold moves — the
        signal should then be that region's own congestion view."""
        congested = (signal.get("util", 0.0) > self.cfg.util_high
                     or signal.get("queue_bytes", 0.0) > self.cfg.queue_high_bytes)
        if home is None:
            t, base = self.threshold, self.base_threshold
        else:
            t = self._home_t.get(home, self.threshold)
            base = self._home_base.get(home, self.base_threshold)
        if congested:
            t = min(t * self.cfg.threshold_boost,
                    self.model.workload.lengths.hi)
            self.adjustments += 1
        elif t > base:
            t = max(base, t / self.cfg.threshold_boost)
        if home is None:
            self.threshold = t
        else:
            self._home_t[home] = t

    def reoptimize(self, n_prfaas: int, n_p: int, n_d: int, b_out: float,
                   home: Optional[str] = None):
        """Re-derive t for new instance counts (called by the autoscaler).
        With ``home`` given (per-region autoscaling), only that home's base
        threshold is re-anchored."""
        best, _, _ = self.model.grid_search(n_prfaas, n_p + n_d, b_out)
        if best is not None:
            # keep the searched split only for t; N allocation is the
            # autoscaler's decision
            if home is None:
                self.base_threshold = best.threshold
                self.threshold = best.threshold
            else:
                self._home_base[home] = best.threshold
                self._home_t[home] = best.threshold

    # --------------------------------------------------------------- route
    def route(self, l_total: int, matches: Dict[str, int],
              bandwidth_signal: Optional[dict] = None,
              home: str = PD) -> RoutingDecision:
        """Route one request originating at ``home``.  ``matches`` maps every
        reachable cluster (home, PrfaaS, and — bandwidth permitting — other
        regions) to its matched prefix tokens; ``bandwidth_signal`` is the
        home<->PrfaaS pair telemetry, which decides the regime."""
        l_home = matches.get(home, 0)
        l_prfaas = matches.get(PRFAAS, 0)
        signal = bandwidth_signal or {}
        abundant = signal.get("util", 0.0) < self.cfg.util_abundant
        t = self.threshold_for(home)

        if abundant:
            # compute is scarce: use the best cache across all clusters
            # (prefer home on ties, then dict order = registration order)
            best_cluster, l_prefix = home, l_home
            for name, m in matches.items():
                if m > l_prefix:
                    best_cluster, l_prefix = name, m
            incr = l_total - l_prefix
            target = home if incr <= t else PRFAAS
            # prefer the target's own cache on ties (no copy needed)
            cache_cluster = (target if matches.get(target, 0) >= l_prefix
                             else best_cluster)
            cross = cache_cluster != target and l_prefix > 0
            cached = l_prefix
        else:
            # bandwidth is scarce: evaluate home and PrfaaS independently
            if l_total - l_home <= t:
                target, cached, cache_cluster, cross = home, l_home, home, False
            else:
                target, cached, cache_cluster, cross = \
                    PRFAAS, l_prfaas, PRFAAS, False
            incr = l_total - cached

        if self.system.n_prfaas == 0:
            target, cached, cache_cluster, cross = home, l_home, home, False
            incr = l_total - cached
        elif self.system.n_p == 0:          # naive hetero: no local prefill
            target, cached, cache_cluster, cross = PRFAAS, l_prfaas, PRFAAS, False
            incr = l_total - cached
        self.decisions[target] = self.decisions.get(target, 0) + 1
        if cross:
            self.cross_transfers += 1
        return RoutingDecision(target=target, cached_tokens=cached,
                               incremental=max(0, incr),
                               cache_cluster=cache_cluster,
                               cross_cache_transfer=cross, home=home)
