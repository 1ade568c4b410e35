"""Long-term scheduling: traffic-driven allocation re-optimization
(paper §3.4.3, long-term loop).

Monitors stage utilization / queue depth over minutes, detects persistent
producer/consumer imbalance (Theta_prfaas + Theta_pdp vs Theta_pdd, Eq. 8)
and converts PD nodes between prefill and decode roles; after each
conversion the routing threshold t is re-optimized (Eq. 7).

Regionalized control (multi-cluster deployments): each PD cluster runs its
OWN Autoscaler over its region-local ``SystemConfig`` (that region's
N_p,c / N_d,c, and the shared PrfaaS cluster's instances/egress scaled by
the region's traffic share — region c consumes s_c of the offloaded-KV
stream) with ``home`` set, so conversions and the threshold re-anchor
apply to one region only — the simulator instantiates one per PD cluster
and feeds it per-region ``StageTelemetry``.  The single-cluster case is
one autoscaler over the whole fleet, exactly the paper's loop.

Session-aware producer estimate: ``StageTelemetry.cache_hit_frac`` is the
fraction of prefill tokens served from the regional prefix cache (fed from
``SimPrefixCache`` match telemetry via the router's decisions).  Cached
tokens consume no prefill compute, so the effective producer throughput is
``theta / (1 - frac)`` — a region with hot agentic sessions needs fewer
prefill instances than raw queue depths alone would suggest.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.router import Router
from repro_torch.core.throughput_model import SystemConfig, ThroughputModel


@dataclass
class StageTelemetry:
    prefill_queue: int = 0
    decode_queue: int = 0
    prefill_util: float = 0.0
    decode_util: float = 0.0
    # fraction of prefill tokens served from the prefix cache (long-term
    # loop's session-awareness; 0 = cold cache, matches pre-session model)
    cache_hit_frac: float = 0.0
    # CUMULATIVE routed-token counters (preferred over cache_hit_frac when
    # provided): the autoscaler diffs them against its previous evaluation,
    # so the producer boost tracks the hit rate over the last period
    # instead of a stale lifetime average
    cached_tokens: int = 0
    routed_tokens: int = 0


@dataclass
class AutoscalerConfig:
    period_s: float = 300.0          # re-evaluation period
    imbalance_ratio: float = 1.25    # hysteresis on producer/consumer ratio
    min_p: int = 1
    min_d: int = 1
    cache_frac_cap: float = 0.9      # bound the producer boost from cache hits


class Autoscaler:
    def __init__(self, model: ThroughputModel, router: Router,
                 system: SystemConfig,
                 cfg: Optional[AutoscalerConfig] = None,
                 home: Optional[str] = None):
        self.model = model
        self.router = router
        self.system = system
        self.home = home                 # PD cluster governed (None = global)
        # fresh config per autoscaler (a default argument would be a single
        # mutable instance shared by every Autoscaler in the process)
        self.cfg = AutoscalerConfig() if cfg is None else cfg
        self._last_eval = 0.0
        self._cache_snap = (0, 0)        # (cached, routed) at last eval
        # allocation before the first conversion, so cost accounting can
        # time-integrate the piecewise-constant (n_p, n_d) trajectory
        self.initial = (system.n_p, system.n_d)
        self.conversions: List[tuple] = []

    def _window_cache_frac(self, tel: StageTelemetry) -> float:
        """Cache-hit token fraction over the window since the previous
        evaluation (from the cumulative counters); falls back to the
        directly supplied ``cache_hit_frac`` when no tokens were routed
        in the window (or no counters are fed)."""
        d_cached = tel.cached_tokens - self._cache_snap[0]
        d_routed = tel.routed_tokens - self._cache_snap[1]
        self._cache_snap = (tel.cached_tokens, tel.routed_tokens)
        if d_routed > 0:
            return d_cached / d_routed
        return tel.cache_hit_frac

    def maybe_rebalance(self, now: float, tel: StageTelemetry) -> Optional[SystemConfig]:
        if now - self._last_eval < self.cfg.period_s:
            return None
        self._last_eval = now
        sc = self.system
        producer = self.model.theta_prfaas(sc) + self.model.theta_pdp(sc)
        # cached prefix tokens cost no prefill compute: the hit fraction
        # observed over the LAST period scales the effective producer rate
        # (session-aware loop)
        frac = min(max(self._window_cache_frac(tel), 0.0),
                   self.cfg.cache_frac_cap)
        producer /= (1.0 - frac)
        consumer = self.model.theta_pdd(sc)
        new_p, new_d = sc.n_p, sc.n_d
        # queue evidence + model evidence must agree (avoid flapping)
        if (producer > consumer * self.cfg.imbalance_ratio
                and tel.decode_queue > tel.prefill_queue
                and sc.n_p > self.cfg.min_p):
            new_p, new_d = sc.n_p - 1, sc.n_d + 1          # P -> D
        elif (consumer > producer * self.cfg.imbalance_ratio
                and tel.prefill_queue > tel.decode_queue
                and sc.n_d > self.cfg.min_d):
            new_p, new_d = sc.n_p + 1, sc.n_d - 1          # D -> P
        if (new_p, new_d) == (sc.n_p, sc.n_d):
            return None
        threshold = (self.router.threshold if self.home is None
                     else self.router.threshold_for(self.home))
        self.system = SystemConfig(sc.n_prfaas, new_p, new_d, sc.b_out,
                                   threshold)
        self.router.reoptimize(sc.n_prfaas, new_p, new_d, sc.b_out,
                               home=self.home)
        self.conversions.append((now, new_p, new_d))
        return self.system
