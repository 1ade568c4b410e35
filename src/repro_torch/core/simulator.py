"""Cross-datacenter PrfaaS-PD cluster simulator (discrete-event core).

Ties every core component together under a realistic workload: bursty
(MMPP-modulated Poisson) arrivals, truncated log-normal lengths, agentic
sessions producing prefix-cache hits, a fluctuating inter-DC Ethernet
topology with layer-wise pipelined KV flows, the dual-timescale scheduler,
and the hybrid prefix cache pools.

Multi-cluster deployments (paper deployment story)
--------------------------------------------------
One compute-dense PrfaaS cluster feeds ``SimConfig.pd_clusters`` regional
PD clusters over a ``transfer.LinkTopology``: a star of independent
per-pair links (plus an optional PD<->PD mesh for cross-region cache
copies), skewed regional traffic shares (``pd_shares``), per-region
prefill/decode pools, and a home-cluster router — each request offloads to
PrfaaS, prefills locally, or reuses the best cache anywhere reachable,
charging the correct pair link.  ``pd_clusters=1`` (the default) is the
paper's two-cluster deployment and reproduces the original single-``Link``
simulator bit-for-bit on the same seed.

Regionalized control plane
--------------------------
Both control loops react to *regional* state rather than one global
signal:

  * short-term (router): every control epoch each home cluster observes
    its OWN aggregated congestion view (``LinkTopology.dest_signal``) and
    adjusts a per-home routing threshold — a congested region raises its
    offload bar alone while quiet regions keep routing normally.
  * long-term (autoscaler): each PD cluster runs its own ``Autoscaler``
    over its region-local (N_p,c, N_d,c), converting P<->D roles from
    per-region queue depths, pool utilizations, and the region's prefix
    cache-hit token fraction (``SimPrefixCache`` telemetry via routing
    decisions) — cached tokens cost no prefill compute, so hot agentic
    regions shed prefill capacity sooner.  Conversions resize only that
    region's pools and re-anchor only that home's threshold.

Session roaming (``SimConfig.roam_prob``)
-----------------------------------------
With probability ``roam_prob`` a continuing session re-arrives at a
DIFFERENT home region (sampled from the other clusters' traffic shares);
the session's cached prefix stays where it was produced, so the router's
best-cache-anywhere regime triggers a cross-region copy charged to the
correct PD<->PD mesh pair link (``pd_mesh_gbps``) — or falls back to a
cold prefill when no mesh link exists.  ``roam_prob=0`` (default) keeps
sessions pinned and the RNG stream identical to the pre-roaming
simulator.  Live sessions are tracked in an explicit bounded window
(``SimConfig.max_open_sessions``): overflowing sessions are evicted
oldest-first and counted (``metrics()["session_evictions"]``), never
silently dropped.

Event model (``SimConfig(engine="event")``, the default)
--------------------------------------------------------
A single priority-queue loop over exact event times — no fixed dt:

  * ARRIVAL       — pre-generated exact MMPP arrival trace (thinning over the
                    piecewise-constant rate, mean-preserving for any
                    burst_factor); routes and submits to a prefill pool.
  * PREFILL_DONE  — frees the prefill server, starts the next queued request,
                    and (with all KV flows drained) admits the request to
                    decode.
  * LINK wake     — every fair-share pair link is solved *exactly* between
                    events by progressive filling (``transfer.Link.advance``):
                    flow completion / layer-release ramp end / OU bandwidth
                    resample times are computed analytically.  KV flows
                    release layer-wise while prefill computes (linear ramp),
                    and cross-cache prefix copies are charged to the
                    owner<->target pair link.
  * DECODE_DONE   — frees a decode slot in the request's home cluster
                    (slot count = N_d,c x BS_max).
  * ADMIT         — (``decode_block_tokens`` > 0) a ready request deferred
                    to the next decode block boundary claims its slot; both
                    engines model the live ``RegionScheduler``'s admit-at-
                    block-boundary cadence, and decode holds slots for
                    whole blocks.  0 (default) = exact-time admission.
  * CONTROL       — every ``control_dt``: the router's short-term congestion
                    loop observes aggregated link telemetry, and the
                    autoscaler's long-term loop may convert P<->D roles
                    (epoch gating is the autoscaler's own ``period_s``).
  * WARMUP        — at t0 = warmup_frac x horizon: snapshots topology
                    sent-bytes so egress is reported over the same
                    measurement window as throughput.

``SimConfig(engine="tick")`` keeps the legacy fixed-step fluid loop (fed the
identical arrival trace) for apples-to-apples equivalence testing; the event
engine reproduces its metrics within a few percent while running one to two
orders of magnitude faster.

Wire compression and live cross-validation
------------------------------------------
``SystemConfig.kv_wire_compression`` (the measured int8 quantized/raw byte
ratio, see ``models.kvcache.wire_compression_ratio``) is applied at FLOW
granularity: every per-request prefill-KV flow and cross-cache copy
carries ``S_kv / ratio`` bytes, so link telemetry, congestion feedback,
and egress metrics all see the compressed stream.  ``inject_trace``
replays an external arrival trace — the live deployment's recorded
arrivals — through the simulator, which is how ``launch.serve
--cross-validate`` checks per-request route agreement between this policy
model and the actual ``serving.CrossDCDeployment`` (both drive the same
``core.router.Router`` over a ``core.transfer.LinkTopology``).

Produces the paper's §4.3 observables: throughput, mean/P90 TTFT, egress
bandwidth (including cross-cache transfer bytes), offload fraction, cache
hit rates, queue depths — globally and per PD cluster.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware import Profile
from repro_torch.core.kv_manager import GlobalKVManager
from repro_torch.core.sim_cache import SimPrefixCache
from repro_torch.core.router import PD, PRFAAS, Router, RouterConfig, RoutingDecision
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig, StageTelemetry
from repro_torch.core.throughput_model import SystemConfig, ThroughputModel
from repro_torch.core.transfer import Link, LinkTopology, star_pairs
from repro_torch.core.workload import Workload, mmpp_rate


@dataclass
class Request:
    rid: int
    arrival: float
    total_len: int
    session: int
    home: str = PD                # regional PD cluster serving this request
    # filled by routing / execution
    decision: Optional[RoutingDecision] = None
    prefill_start: float = -1.0
    prefill_done: float = -1.0
    transfer_done: float = -1.0
    decode_start: float = -1.0
    first_token: float = -1.0
    done: float = -1.0
    flows_pending: int = 0        # in-flight link flows gating decode
    _hashes: Optional[List[int]] = field(default=None, repr=False)

    def block_hashes(self, block_tokens: int) -> List[int]:
        if self._hashes is None:
            n = self.total_len // block_tokens
            # chained-hash stand-in: unique per (session, block index), no
            # per-block tuple allocation (hot path: ~400 blocks/request)
            base = (self.session * 0x9E3779B97F4A7C15) & 0x7FFFFFFFFFFFFFFF
            self._hashes = [(base + i * 0x9E3779B1) & 0x7FFFFFFFFFFFFFFF
                            for i in range(n)]
        return self._hashes


class InstancePool:
    """N identical single-request servers with one FIFO queue (tick engine)."""

    def __init__(self, n: int):
        self.capacity = n
        self.busy: List[float] = []          # end times
        self.queue: deque = deque()          # (req, service_time)
        self.busy_time = 0.0
        self.cap_time = 0.0                  # time-integrated capacity

    def submit(self, req, service_time: float):
        self.queue.append((req, service_time))

    def tick(self, now: float, dt: float, on_start, admit: bool = True):
        self.busy = [t for t in self.busy if t > now]
        if admit:
            while self.queue and len(self.busy) < self.capacity:
                req, st = self.queue.popleft()
                self.busy.append(now + st)
                on_start(req, now, now + st)
        self.busy_time += dt * len(self.busy)
        self.cap_time += dt * max(1, self.capacity)

    def utilization(self, elapsed: float) -> float:
        # capacity is integrated over time (cap_time), so a mid-run resize
        # does not rewrite the history of earlier, differently-sized epochs
        return self.busy_time / max(1e-9, self.cap_time)


class DecodePool(InstancePool):
    """n_d instances x BS_max slots; a request holds a slot for its decode."""


class EventPool:
    """FIFO server pool for the event engine: exact start/finish times, no
    per-tick scans.  ``submit`` returns True when the item starts now;
    otherwise it queues until ``release`` or a capacity increase frees it."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.busy = 0
        self.queue: deque = deque()
        self.busy_time = 0.0
        self.cap_time = 0.0                  # time-integrated capacity
        self._last = 0.0

    def _integrate(self, now: float):
        self.busy_time += (now - self._last) * self.busy
        self.cap_time += (now - self._last) * max(1, self.capacity)
        self._last = now

    def submit(self, item, now: float) -> bool:
        self._integrate(now)
        if self.busy < self.capacity:
            self.busy += 1
            return True
        self.queue.append(item)
        return False

    def release(self, now: float):
        """Free one server; returns the next queued item to start (or None)."""
        self._integrate(now)
        self.busy -= 1
        if self.queue and self.busy < self.capacity:
            self.busy += 1
            return self.queue.popleft()
        return None

    def set_capacity(self, capacity: int, now: float) -> list:
        """Resize; returns queued items that can start immediately."""
        self._integrate(now)
        self.capacity = capacity
        started = []
        while self.queue and self.busy < self.capacity:
            self.busy += 1
            started.append(self.queue.popleft())
        return started

    def utilization(self, elapsed: float) -> float:
        """Busy fraction up to ``elapsed`` (== now; pools start at t=0).
        Integrates pending busy time first so mid-interval reads are
        current.  The denominator is capacity integrated over time, so a
        mid-run ``set_capacity`` changes only the epochs it governs instead
        of retroactively rescaling the whole history."""
        self._integrate(elapsed)
        return self.busy_time / max(1e-9, self.cap_time)


@dataclass
class SimConfig:
    arrival_rate: float                 # req/s offered (global, all regions)
    sim_time: float = 1800.0
    dt: float = 0.02                    # tick engine step
    seed: int = 0
    link_gbps: float = 100.0
    link_fluctuation: float = 0.0
    pool_blocks: int = 200_000          # per-cluster prefix pool blocks
    block_tokens: int = 64
    autoscale: bool = False
    warmup_frac: float = 0.1            # exclude from metrics
    engine: str = "event"               # "event" | "tick" | "vector" (SoA)
    control_dt: float = 0.25            # event engine: telemetry/control loop
    fluct_dt: float = 0.25              # event engine: OU resample period
    # vector engine epoch length (0 -> control_dt).  Larger epochs trade
    # control-loop granularity for speed at million-request scale.
    vector_dt: float = 0.0
    # TTFT SLO for goodput/attainment metrics (0 = off: attainment reports
    # 1.0 and goodput equals throughput, keeping the keys JSON-stable)
    ttft_slo_s: float = 0.0
    # TBT SLO (mean time-between-tokens per request); 0 = off, same
    # JSON-stable convention as ttft_slo_s
    tbt_slo_s: float = 0.0
    # mean accepted DRAFT tokens per verify dispatch from the live
    # speculative decoder (accepted_tokens_per_dispatch - 1).  > 0 scales
    # decode service time by 1/(1+rate); 0 keeps the golden exact path
    spec_accept_rate: float = 0.0
    # -- multi-cluster topology (1 = the paper's two-cluster deployment) ----
    pd_clusters: int = 1                # regional PD clusters fed by PrfaaS
    pd_shares: Optional[Tuple[float, ...]] = None   # regional traffic shares
    pd_link_gbps: Optional[Tuple[float, ...]] = None  # per-region star links
    pd_link_fluct: Optional[Tuple[float, ...]] = None
    pd_mesh_gbps: float = 0.0           # PD<->PD links (0 = star only)
    # -- regionalized control plane -----------------------------------------
    roam_prob: float = 0.0              # P(continuing session switches home)
    max_open_sessions: int = 512        # live-session window (explicit evict)
    # -- continuous-batching fidelity ---------------------------------------
    # > 0: decode admission happens only at block boundaries (every
    # decode_block_tokens * Workload.t_decode seconds), matching the live
    # RegionScheduler's step_block cadence, and decode service time is
    # rounded up to whole blocks.  0 (default) keeps the legacy exact-time
    # admission — byte-identical traces, golden tests untouched.
    decode_block_tokens: int = 0


# event kinds, ordered so ties process deterministically
(_EV_ARRIVAL, _EV_PREFILL_DONE, _EV_DECODE_DONE, _EV_CONTROL, _EV_LINK,
 _EV_WARMUP, _EV_ADMIT) = range(7)


class PrfaasSimulator:
    def __init__(self, model: ThroughputModel, system: SystemConfig,
                 workload: Workload, sim: SimConfig,
                 router_cfg: Optional[RouterConfig] = None):
        self.model = model
        self.system = system
        self.w = workload
        self.sim = sim
        self.rng = np.random.default_rng(sim.seed)

        # -- regional PD clusters, traffic shares, link topology ------------
        k = sim.pd_clusters
        if k < 1:
            raise ValueError("pd_clusters must be >= 1")
        if not 0.0 <= sim.roam_prob <= 1.0:
            raise ValueError(f"roam_prob {sim.roam_prob} not in [0, 1]")
        if sim.max_open_sessions < 1:
            raise ValueError("max_open_sessions must be >= 1")
        self._pd_names = [PD] if k == 1 else [f"pd{i}" for i in range(k)]
        shares = sim.pd_shares if sim.pd_shares is not None \
            else tuple([1.0 / k] * k)
        if len(shares) != k or min(shares) < 0 or sum(shares) <= 0:
            raise ValueError(f"pd_shares {shares} invalid for {k} clusters")
        self._shares = [s / sum(shares) for s in shares]
        if system.n_p_clusters is not None \
                and len(system.n_p_clusters) != k:
            raise ValueError("SystemConfig per-cluster tuples must match "
                             "SimConfig.pd_clusters")
        self._per_cluster = system.per_cluster(k)   # [(n_p, n_d) per region]

        self.router = Router(model, system, router_cfg)
        self.kv = GlobalKVManager()
        self.kv.register_cluster(
            PRFAAS, SimPrefixCache(sim.pool_blocks, sim.block_tokens),
            nodes=max(1, system.n_prfaas))
        for name, (n_p_c, n_d_c) in zip(self._pd_names, self._per_cluster):
            self.kv.register_cluster(
                name, SimPrefixCache(sim.pool_blocks, sim.block_tokens),
                nodes=max(1, n_p_c + n_d_c))
        self.topology = self._build_topology()
        self.prfaas_pool = InstancePool(system.n_prfaas)
        self.pdp_pools: Dict[str, InstancePool] = {
            name: InstancePool(n_p_c)
            for name, (n_p_c, _) in zip(self._pd_names, self._per_cluster)}
        self.decode_pools: Dict[str, InstancePool] = {
            name: DecodePool(n_d_c * workload.bs_max)
            for name, (_, n_d_c) in zip(self._pd_names, self._per_cluster)}
        # per-region long-term loop: one autoscaler per PD cluster, each
        # governing its region-local (n_p_c, n_d_c) and that home's routing
        # threshold.  The shared PrfaaS cluster is scaled by the region's
        # traffic share (region c consumes s_c of the offloaded stream), so
        # the region-local model — imbalance detection AND the post-
        # conversion threshold re-optimization — sees only its slice
        # instead of crediting the full hub to every region.
        self.autoscalers: Dict[str, Autoscaler] = {}
        if sim.autoscale:
            for name, share, (n_p_c, n_d_c) in zip(
                    self._pd_names, self._shares, self._per_cluster):
                n_prfaas_r = max(1, round(share * system.n_prfaas)) \
                    if system.n_prfaas else 0
                region_sc = SystemConfig(n_prfaas_r, n_p_c, n_d_c,
                                         share * system.b_out,
                                         system.threshold)
                self.autoscalers[name] = Autoscaler(
                    model, self.router, region_sc, home=name)

        self.completed: List[Request] = []
        self.all_requests: List[Request] = []
        self._next_rid = 0
        self._next_session = 0
        # (session_id, cur_len, home); window of live sessions with EXPLICIT
        # oldest-first eviction (counted) once max_open_sessions is exceeded
        self._open_sessions: deque = deque()
        self.session_evictions = 0
        # per-home (cached, total) routed token counters -> cache_hit_frac
        # telemetry for the session-aware long-term loop
        self._route_tokens: Dict[str, List[int]] = {
            name: [0, 0] for name in self._pd_names}
        self._egress_t0 = 0.0         # topology sent-bytes at warmup end
        # int8 KV on the wire, at flow granularity: every per-request link
        # flow (prefill KV and cross-cache copies) carries S_kv divided by
        # the measured quantized/raw ratio (SystemConfig.kv_wire_compression,
        # 1.0 = off -> byte-identical to the uncompressed simulator)
        if system.kv_wire_compression < 1.0:
            raise ValueError("kv_wire_compression must be >= 1.0 "
                             f"(got {system.kv_wire_compression})")
        self._wire_comp = system.kv_wire_compression
        # external arrival trace (policy/actual cross-validation): replaces
        # the generated MMPP trace when set via ``inject_trace``
        self._external_trace: Optional[List[Request]] = None
        # SoA trace for the vector engine (``inject_soa_trace``)
        self._soa_trace = None
        # continuous-batching fidelity: decode admission quantized to the
        # live scheduler's step_block cadence (0 = legacy exact-time)
        if sim.decode_block_tokens < 0:
            raise ValueError("decode_block_tokens must be >= 0")
        self._block_s = sim.decode_block_tokens * workload.t_decode

    def _build_topology(self) -> LinkTopology:
        """Star topology PrfaaS->each region (+ optional PD mesh).  The
        single-region star is one pair seeded ``sim.seed`` — identical to
        the original bare ``Link``."""
        sim, k = self.sim, self.sim.pd_clusters
        star = star_pairs(PRFAAS, self._pd_names, mesh=sim.pd_mesh_gbps > 0)
        n_star = k
        gbps = list(sim.pd_link_gbps) if sim.pd_link_gbps is not None \
            else [sim.link_gbps] * n_star
        fluct = list(sim.pd_link_fluct) if sim.pd_link_fluct is not None \
            else [sim.link_fluctuation] * n_star
        if len(gbps) != n_star or len(fluct) != n_star:
            raise ValueError("pd_link_gbps/pd_link_fluct must have one entry "
                             "per PD cluster")
        n_mesh = len(star) - n_star
        gbps += [sim.pd_mesh_gbps] * n_mesh
        fluct += [sim.link_fluctuation] * n_mesh
        return LinkTopology.build([PRFAAS] + self._pd_names, star, gbps,
                                  fluctuation=fluct, seed=sim.seed,
                                  fluct_dt=sim.fluct_dt)

    # ------------------------------------------------- two-cluster aliases
    # The classic deployment has one PD cluster; these aliases keep the
    # original single-cluster attribute API (tests, notebooks) working.
    @property
    def link(self) -> Link:
        return self.topology.link(PRFAAS, self._pd_names[0])

    @property
    def pdp_pool(self):
        return self.pdp_pools[self._pd_names[0]]

    @pdp_pool.setter
    def pdp_pool(self, pool):
        self.pdp_pools[self._pd_names[0]] = pool

    @property
    def decode_pool(self):
        return self.decode_pools[self._pd_names[0]]

    @decode_pool.setter
    def decode_pool(self, pool):
        self.decode_pools[self._pd_names[0]] = pool

    @property
    def autoscaler(self) -> Optional[Autoscaler]:
        """First region's autoscaler (the single-cluster autoscaler in the
        classic deployment); None when autoscaling is off."""
        if not self.autoscalers:
            return None
        return self.autoscalers[self._pd_names[0]]

    # ------------------------------------------------------------- arrivals
    def _arrival_rate(self, now: float) -> float:
        return mmpp_rate(self.sim.arrival_rate, self.w.burst_factor,
                         self.w.burst_period_s, now)

    def _sample_home(self, exclude: Optional[str] = None) -> str:
        """Regional origin of a new session, skewed by pd_shares.  The
        single-cluster case draws nothing, keeping the RNG stream (and thus
        the whole trajectory) identical to the pre-topology simulator.
        ``exclude`` (session roaming) renormalizes the shares over the
        OTHER regions so a roaming session always changes home."""
        if len(self._pd_names) == 1:
            return self._pd_names[0]
        if exclude is None:
            i = int(self.rng.choice(len(self._pd_names), p=self._shares))
            return self._pd_names[i]
        names = [n for n in self._pd_names if n != exclude]
        w = [s for n, s in zip(self._pd_names, self._shares) if n != exclude]
        tot = sum(w)
        p = [x / tot for x in w] if tot > 0 else None   # uniform fallback
        return names[int(self.rng.choice(len(names), p=p))]

    def _new_request(self, now: float) -> Request:
        if (self._open_sessions
                and self.rng.random() < self.w.session_prob):
            i = self.rng.integers(len(self._open_sessions))
            sid, cur, home = self._open_sessions[i]
            grow = int(self.rng.exponential(self.w.session_growth)) + 1
            total = min(cur + grow, int(self.w.lengths.hi))
            # session roaming: the user re-appears in a different region;
            # the cached prefix stays at the old home, so the router's
            # best-cache-anywhere regime charges a cross-region mesh copy.
            # Guarded draws keep the roam_prob=0 RNG stream untouched.
            if (self.sim.roam_prob > 0 and len(self._pd_names) > 1
                    and self.rng.random() < self.sim.roam_prob):
                home = self._sample_home(exclude=home)
            self._open_sessions[i] = (sid, total, home)
        else:
            sid = self._next_session
            self._next_session += 1
            total = int(self.w.lengths.sample(self.rng, 1)[0])
            home = self._sample_home()
            self._open_sessions.append((sid, total, home))
            # explicit live-session window: evict oldest-first and COUNT it
            # (a deque(maxlen=...) dropped live sessions silently, invisibly
            # skewing session_prob reuse under high arrival rates)
            while len(self._open_sessions) > self.sim.max_open_sessions:
                self._open_sessions.popleft()
                self.session_evictions += 1
        r = Request(self._next_rid, now, total, sid, home=home)
        self._next_rid += 1
        self.all_requests.append(r)
        return r

    def inject_trace(self, entries) -> List[Request]:
        """Replay an EXTERNAL arrival trace instead of generating one —
        the policy/actual cross-validation path (``launch.serve
        --cross-validate``): the live deployment's recorded arrivals
        ``(arrival_s, total_len, session_id, home)`` are replayed through
        the simulator so per-request routing decisions can be compared.
        Entries must be sorted by arrival time; homes must name existing
        PD clusters.  Returns the created simulator ``Request``s (in trace
        order, matching the live run's request order)."""
        reqs: List[Request] = []
        prev = -math.inf
        for arrival, total_len, session, home in entries:
            if home not in self._pd_names:
                raise ValueError(f"unknown home cluster {home!r}; "
                                 f"expected one of {self._pd_names}")
            if arrival < prev:
                raise ValueError("trace entries must be sorted by arrival")
            prev = arrival
            reqs.append(Request(self._next_rid, float(arrival),
                                int(total_len), int(session), home=home))
            self._next_rid += 1
        self._external_trace = reqs
        return reqs

    def inject_soa_trace(self, trace):
        """Feed a ``workload.Trace`` (SoA columns) directly to the vector
        engine — no per-request Python objects are materialized, which is
        what makes 1e6+ request runs single-digit seconds.  Other engines
        replay it through ``inject_trace`` (object path)."""
        if self.sim.engine == "vector":
            self._soa_trace = trace
            return None
        return self.inject_trace(trace.to_entries())

    def _generate_arrivals(self) -> List[Request]:
        """Exact MMPP arrival trace via thinning over the piecewise-constant
        rate — both engines consume the identical trace, so equivalence
        differences come from time discretization only.  An injected
        external trace (``inject_trace``) takes precedence."""
        if self._external_trace is not None:
            self.all_requests.extend(self._external_trace)
            return list(self._external_trace)
        sim, w = self.sim, self.w
        out: List[Request] = []
        lam_max = sim.arrival_rate * max(w.burst_factor, 1.0)
        if lam_max <= 0:
            return out
        t = 0.0
        while True:
            t += self.rng.exponential(1.0 / lam_max)
            if t >= sim.sim_time:
                return out
            lam = self._arrival_rate(t)
            if lam < lam_max and self.rng.random() * lam_max > lam:
                continue                             # thinned
            out.append(self._new_request(t))

    # ---------------------------------------------------- shared byte model
    def _wire_profile(self) -> Profile:
        return self.model.prfaas_profile or self.model.pd_profile

    def _prefill_wire_bytes(self, req: Request) -> float:
        """KV bytes for a PrfaaS-prefilled request crossing the link (the
        already-cached prefix need not be resent), after int8 wire
        compression (``SystemConfig.kv_wire_compression``)."""
        prof = self._wire_profile()
        nbytes = prof.s_kv(req.total_len)
        if req.decision.cached_tokens:
            nbytes -= prof.s_kv(req.decision.cached_tokens)
        return max(nbytes / self._wire_comp, 1.0)

    def _cross_cache_bytes(self, decision: RoutingDecision) -> float:
        """Cached-prefix KV bytes copied between clusters when the router
        reuses the best cache anywhere (abundant-bandwidth regime) — also
        compressed on the wire."""
        return max(self._wire_profile().s_kv(decision.cached_tokens)
                   / self._wire_comp, 1.0)

    def _match_eligible(self, home: str, name: str) -> bool:
        """Shared reachability rule: ``LinkTopology.cache_reachable``."""
        return self.topology.cache_reachable(home, name, hub=PRFAAS)

    def _prefill_pool(self, cluster: str):
        return self.prfaas_pool if cluster == PRFAAS \
            else self.pdp_pools[cluster]

    # -------------------------------------------- decode block granularity
    def _block_boundary(self, t: float) -> float:
        """Next decode block boundary at or after ``t`` (t itself when it
        lies on one, or always when block granularity is off)."""
        if self._block_s <= 0:
            return t
        return math.ceil((t - 1e-9) / self._block_s) * self._block_s

    def _decode_service_time(self) -> float:
        """Per-request decode slot hold time; with block granularity on,
        the slot is held for whole blocks (output_len rounded up)."""
        n = self.w.output_len
        b = self.sim.decode_block_tokens
        if b > 0:
            n = -(-n // b) * b
        t = n * self.w.t_decode
        # speculative decode emits (1 + accept_rate) tokens per dispatch on
        # average; the guard keeps rate = 0 byte-identical to the pre-spec
        # golden path
        if self.sim.spec_accept_rate > 0:
            t /= 1.0 + self.sim.spec_accept_rate
        return t

    def _route(self, req: Request) -> Tuple[str, float]:
        n_blocks = req.total_len // self.sim.block_tokens
        matches = {name: c.match(req.session, n_blocks)
                   for name, c in self.kv.clusters.items()
                   if self._match_eligible(req.home, name)}
        decision = self.router.route(
            req.total_len, matches,
            self.topology.pair_signal(PRFAAS, req.home), home=req.home)
        req.decision = decision
        acc = self._route_tokens[req.home]
        acc[0] += decision.cached_tokens
        acc[1] += req.total_len
        incr = max(decision.incremental, 1)
        if decision.target == PRFAAS:
            return PRFAAS, self.model.prfaas_profile.t_prefill(incr)
        return decision.target, self.model.pd_profile.t_prefill(incr)

    # ------------------------------------------------ regional control plane
    def _observe_regions(self):
        """Short-term loop: each home adjusts its OWN routing threshold from
        its own aggregated link view (``dest_signal``).  For one PD cluster
        the regional view IS the single pair link, reproducing the legacy
        global loop exactly."""
        for name in self._pd_names:
            self.router.observe_congestion(self.topology.dest_signal(name),
                                           home=name)

    def _region_telemetry(self, name: str,
                          util_now: Optional[float] = None) -> StageTelemetry:
        """Per-region long-term telemetry: the region's own prefill/decode
        queues (requests queued at PrfaaS attributed by home), pool
        utilizations (event engine), and the home's cumulative routed/
        cached token counters (prefix-cache telemetry; the autoscaler
        windows them over its own evaluation period)."""
        pq = sum(1 for item in self.prfaas_pool.queue
                 if item[0].home == name)
        pq += len(self.pdp_pools[name].queue)
        cached, total = self._route_tokens[name]
        tel = StageTelemetry(
            prefill_queue=pq,
            decode_queue=len(self.decode_pools[name].queue),
            # cumulative counters: the autoscaler windows them per period
            cached_tokens=cached, routed_tokens=total)
        if util_now is not None:
            tel.prefill_util = self.pdp_pools[name].utilization(
                max(util_now, 1e-9))
            tel.decode_util = self.decode_pools[name].utilization(
                max(util_now, 1e-9))
        return tel

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        if self.sim.engine == "tick":
            return self._run_tick()
        if self.sim.engine == "vector":
            from repro_torch.core.vector_engine import run_vector
            return run_vector(self)
        if self.sim.engine != "event":
            raise ValueError(f"unknown engine {self.sim.engine!r}; "
                             "expected 'event', 'tick', or 'vector'")
        return self._run_event()

    # ---------------------------------------------------------- tick engine
    def _route_and_submit_tick(self, req: Request, now: float):
        cluster, st = self._route(req)
        self._prefill_pool(cluster).submit(req, st)

    def _submit_request_flows(self, req: Request, cluster: str, now: float,
                              done: float, on_all_done=None):
        """Submit this request's link flows (main KV + cross-cache copy) to
        the correct pair links and wire their completion into the request's
        readiness state.  ``on_all_done(req, tc)`` fires when the LAST flow
        drains, at its exact completion time (event engine decode
        admission)."""
        req.flows_pending = 0

        def on_flow_done(tc: float, _req=req):
            _req.flows_pending -= 1
            _req.transfer_done = max(_req.transfer_done, tc)
            if _req.flows_pending == 0 and on_all_done is not None:
                on_all_done(_req, tc)

        if cluster == PRFAAS:
            # layer-wise pipelined KV flow to the request's home region:
            # releases linearly while prefill computes (the fluid limit of
            # the per-layer staircase)
            self.topology.submit(PRFAAS, req.home,
                                 self._prefill_wire_bytes(req), now,
                                 ramp_end=done, on_done=on_flow_done)
            req.flows_pending += 1
        if req.decision.cross_cache_transfer and req.decision.cached_tokens:
            # cached prefix lives in another cluster: the copy is already
            # materialized, so it is wire-eligible immediately (eager),
            # charged to the owner<->target pair link
            self.topology.submit(req.decision.cache_cluster,
                                 req.decision.target,
                                 self._cross_cache_bytes(req.decision), now,
                                 ramp_end=now, on_done=on_flow_done)
            req.flows_pending += 1
        if req.flows_pending == 0:
            req.transfer_done = done      # intra-cluster RDMA: free

    def _on_prefill_start(self, cluster: str):
        def cb(req: Request, now: float, done: float):
            req.prefill_start = now
            req.prefill_done = done
            self._inflight.append(req)
            self._submit_request_flows(req, cluster, now, done)
        return cb

    def _on_decode_start(self, req: Request, now: float, done: float):
        req.decode_start = now
        req.first_token = now + self.w.t_decode
        req.done = done

    def _run_tick(self) -> dict:
        sim, w = self.sim, self.w
        trace = self._generate_arrivals()
        idx = 0
        now = 0.0
        self._inflight: List[Request] = []
        decode_time = self._decode_service_time()
        t0 = sim.sim_time * sim.warmup_frac
        egress_snapped = False
        steps = int(sim.sim_time / sim.dt)
        for step in range(steps):
            now = step * sim.dt
            if not egress_snapped and now >= t0:
                # warmup ends: egress measured over the same window as
                # throughput (sent-bytes so far cover [0, now))
                self._egress_t0 = self.topology.sent_bytes
                egress_snapped = True
            # process arrivals at the first tick AT or AFTER their exact
            # arrival time, so prefill never starts before the request exists
            while idx < len(trace) and trace[idx].arrival <= now:
                self._route_and_submit_tick(trace[idx], now)
                idx += 1
            self.prfaas_pool.tick(now, sim.dt, self._on_prefill_start(PRFAAS))
            for name, pool in self.pdp_pools.items():
                pool.tick(now, sim.dt, self._on_prefill_start(name))
            self.topology.tick(now, sim.dt)
            # decode block granularity: only ticks whose interval crosses a
            # block boundary admit into decode slots (all ticks when off)
            at_boundary = (self._block_s <= 0 or math.floor(
                (now + 1e-9) / self._block_s) != math.floor(
                (now - sim.dt + 1e-9) / self._block_s) or step == 0)
            # prefill+transfer complete -> decode queue (+cache insert)
            still = []
            for req in self._inflight:
                ready = (req.prefill_done <= now and req.flows_pending == 0
                         and 0 <= req.transfer_done <= now)
                if ready:
                    cluster = req.decision.target
                    self.kv.clusters[cluster].insert(
                        req.session, req.total_len // sim.block_tokens)
                    self.decode_pools[req.home].submit(req, decode_time)
                else:
                    still.append(req)
            self._inflight = still
            for pool in self.decode_pools.values():
                pool.tick(now, sim.dt, self._on_decode_start,
                          admit=at_boundary)
            self._observe_regions()
            for name in (self._pd_names if self.autoscalers else ()):
                new_sys = self.autoscalers[name].maybe_rebalance(
                    now, self._region_telemetry(name))
                if new_sys is not None:
                    self.pdp_pools[name].capacity = new_sys.n_p
                    self.decode_pools[name].capacity = new_sys.n_d * w.bs_max
        return self.metrics()

    # --------------------------------------------------------- event engine
    def _push(self, t: float, kind: int, payload=None):
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def _wake_link(self, now: float):
        nxt = self.topology.next_event()
        if not math.isfinite(nxt) or nxt > self.sim.sim_time:
            return
        nxt = max(nxt, now + 1e-9)
        if nxt < self._link_wake - 1e-9:
            self._link_wake = nxt
            self._push(nxt, _EV_LINK)

    def _start_prefill(self, req: Request, st: float, cluster: str,
                       now: float):
        req.prefill_start = now
        done = now + st
        req.prefill_done = done
        self._submit_request_flows(req, cluster, now, done,
                                   on_all_done=self._flows_done)
        self._push(done, _EV_PREFILL_DONE, (req, cluster))

    def _flows_done(self, req: Request, tc: float):
        """All link flows drained at tc.  Only admit to decode if prefill is
        also finished by then — otherwise the PREFILL_DONE event handles it
        (never call pools with a timestamp in their future)."""
        if req.prefill_done <= tc + 1e-9:
            self._maybe_ready(req, tc)

    def _maybe_ready(self, req: Request, t: float):
        """Prefill finished and every link flow drained -> decode admission
        (exact time) in the home cluster, inserting the produced KV into the
        target cluster's prefix cache."""
        if req.rid in self._ready_seen:
            return
        if req.flows_pending > 0 or req.prefill_done > t + 1e-9:
            return
        self._ready_seen.add(req.rid)
        self.kv.clusters[req.decision.target].insert(
            req.session, req.total_len // self.sim.block_tokens)
        self._admit_decode(req, t)

    def _admit_decode(self, req: Request, t: float):
        """Hand a ready request to its home decode pool — at the exact
        ready time by default, or deferred to the next block boundary when
        ``decode_block_tokens`` models the live scheduler's admit-at-
        boundary cadence."""
        tb = self._block_boundary(t)
        if tb > t + 1e-12:
            self._push(tb, _EV_ADMIT, req)
            return
        if self.decode_pools[req.home].submit(req, tb):
            self._start_decode(req, tb)

    def _start_decode(self, req: Request, now: float):
        req.decode_start = now
        req.first_token = now + self.w.t_decode
        req.done = now + self._decode_time
        self._push(req.done, _EV_DECODE_DONE, req)

    def _ev_arrival(self, req: Request, now: float):
        cluster, st = self._route(req)
        if self._prefill_pool(cluster).submit((req, st), now):
            self._start_prefill(req, st, cluster, now)

    def _ev_control(self, now: float):
        self._observe_regions()
        for name in (self._pd_names if self.autoscalers else ()):
            new_sys = self.autoscalers[name].maybe_rebalance(
                now, self._region_telemetry(name, util_now=now))
            if new_sys is None:
                continue
            # resize ONLY this region's pools; freed capacity starts queued
            # work at the exact conversion time
            for req, st in self.pdp_pools[name].set_capacity(
                    new_sys.n_p, now):
                self._start_prefill(req, st, name, now)
            for req in self.decode_pools[name].set_capacity(
                    new_sys.n_d * self.w.bs_max, now):
                self._start_decode(req, self._block_boundary(now))
        nxt = now + self.sim.control_dt
        if nxt <= self.sim.sim_time:
            self._push(nxt, _EV_CONTROL)

    def _run_event(self) -> dict:
        sim, w = self.sim, self.w
        self.prfaas_pool = EventPool(self.system.n_prfaas)
        self.pdp_pools = {
            name: EventPool(n_p_c)
            for name, (n_p_c, _) in zip(self._pd_names, self._per_cluster)}
        self.decode_pools = {
            name: EventPool(n_d_c * w.bs_max)
            for name, (_, n_d_c) in zip(self._pd_names, self._per_cluster)}
        self._decode_time = self._decode_service_time()
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._link_wake = math.inf
        self._ready_seen: set = set()
        for req in self._generate_arrivals():
            self._push(req.arrival, _EV_ARRIVAL, req)
        self._push(sim.sim_time * sim.warmup_frac, _EV_WARMUP)
        if sim.control_dt > 0:
            self._push(sim.control_dt, _EV_CONTROL)
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > sim.sim_time:
                break
            # solve every link exactly up to this event; flow completions
            # fire at their exact times and may admit requests to decode
            self.topology.advance(t)
            if kind == _EV_LINK and t >= self._link_wake - 1e-9:
                self._link_wake = math.inf
            if kind == _EV_ARRIVAL:
                self._ev_arrival(payload, t)
            elif kind == _EV_PREFILL_DONE:
                req, cluster = payload
                nxt = self._prefill_pool(cluster).release(t)
                if nxt is not None:
                    self._start_prefill(nxt[0], nxt[1], cluster, t)
                self._maybe_ready(req, t)
            elif kind == _EV_DECODE_DONE:
                nxt = self.decode_pools[payload.home].release(t)
                if nxt is not None:
                    # a freed slot refills at the next block boundary (==
                    # t when block granularity is off: done times already
                    # lie on the admitting request's block grid)
                    self._start_decode(nxt, self._block_boundary(t))
            elif kind == _EV_ADMIT:
                if self.decode_pools[payload.home].submit(payload, t):
                    self._start_decode(payload, t)
            elif kind == _EV_CONTROL:
                self._ev_control(t)
            elif kind == _EV_WARMUP:
                self._egress_t0 = self.topology.sent_bytes
            self._wake_link(t)
        self.topology.advance(sim.sim_time)
        return self.metrics()

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        sim = self.sim
        horizon = sim.sim_time
        t0 = horizon * sim.warmup_frac
        # only requests whose decode actually finishes inside the horizon
        # count as completions — both engines stamp ``done`` when decode
        # STARTS (with its future end time), so an unfiltered list inflates
        # throughput near saturation with work the horizon never absorbed
        done = [r for r in self.all_requests
                if 0 <= r.done <= horizon and r.arrival >= t0]
        ttft = np.array([r.first_token - r.arrival for r in done
                         if r.first_token > 0])
        # mean time-between-tokens per request: decode span over the
        # output_len - 1 inter-token gaps (speculation shrinks the span)
        tbt = np.array([(r.done - r.first_token)
                        / max(1, self.w.output_len - 1)
                        for r in done if r.first_token > 0])
        window = max(1e-9, horizon - t0)
        thr = len(done) / window
        offload = sum(1 for r in self.all_requests
                      if r.decision and r.decision.target == PRFAAS)
        routed = sum(1 for r in self.all_requests if r.decision)

        def _pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        slo = self.sim.ttft_slo_s

        def _slo_stats(tt):
            """(attainment, goodput under the TTFT SLO).  SLO off (0) keeps
            the keys JSON-stable: everything attains, goodput == thr."""
            if slo <= 0:
                return 1.0, len(tt) / window
            good = int((tt <= slo).sum())
            return (good / len(tt) if len(tt) else float("nan"),
                    good / window)

        per_cluster = {}
        for name in self._pd_names:
            c_done = [r for r in done if r.home == name]
            c_ttft = np.array([r.first_token - r.arrival for r in c_done
                               if r.first_token > 0])
            cached, total = self._route_tokens[name]
            c_att, c_good = _slo_stats(c_ttft)
            per_cluster[name] = {
                "completed": len(c_done),
                "throughput_rps": len(c_done) / window,
                "ttft_mean": float(c_ttft.mean()) if len(c_ttft)
                else float("nan"),
                "ttft_p90": _pct(c_ttft, 90),
                "ttft_p99": _pct(c_ttft, 99),
                "slo_attainment": c_att,
                "goodput_rps": c_good,
                "prefill_queue": len(self.pdp_pools[name].queue),
                "decode_queue": len(self.decode_pools[name].queue),
                "threshold": self.router.threshold_for(name),
                "cache_hit_frac": cached / total if total else 0.0,
                "conversions": len(self.autoscalers[name].conversions)
                if name in self.autoscalers else 0,
            }
        thresholds = {name: self.router.threshold_for(name)
                      for name in self._pd_names}
        att, goodput = _slo_stats(ttft)
        return {
            "throughput_rps": thr,
            "ttft_mean": float(ttft.mean()) if len(ttft) else float("nan"),
            "ttft_p50": _pct(ttft, 50),
            "ttft_p90": _pct(ttft, 90),
            "ttft_p99": _pct(ttft, 99),
            "ttft_slo_s": slo,
            "slo_attainment": att,
            "goodput_rps": goodput,
            "tbt_mean": float(tbt.mean()) if len(tbt) else float("nan"),
            "tbt_p50": _pct(tbt, 50),
            "tbt_p90": _pct(tbt, 90),
            "tbt_p99": _pct(tbt, 99),
            "tbt_slo_s": self.sim.tbt_slo_s,
            "tbt_attainment": (float((tbt <= self.sim.tbt_slo_s).mean())
                               if self.sim.tbt_slo_s > 0 and len(tbt)
                               else 1.0),
            "completed": len(done),
            "offload_frac": offload / max(1, routed),
            # same measurement window as throughput: bytes sent after the
            # warmup snapshot, averaged over horizon - t0
            "egress_gbps": (self.topology.sent_bytes - self._egress_t0)
            * 8 / 1e9 / window,
            "link_util": max(l.util_ewma
                             for l in self.topology.links.values()),
            "router_adjustments": self.router.adjustments,
            "prefill_queue": len(self.prfaas_pool.queue)
            + sum(len(p.queue) for p in self.pdp_pools.values()),
            "decode_queue": sum(len(p.queue)
                                for p in self.decode_pools.values()),
            "cache": self.kv.stats(),
            # max over homes == the legacy global value for one PD cluster
            "threshold": max(thresholds.values()),
            "thresholds": thresholds,
            "session_evictions": self.session_evictions,
            "open_sessions": len(self._open_sessions),
            "clusters": per_cluster,
            "links": self.topology.pair_stats(),
        }
