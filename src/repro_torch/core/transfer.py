"""Cross-datacenter KV transfer engine (paper §3.3): flow-level model of the
commodity-Ethernet inter-cluster link.

Models the three mechanisms the paper combines:
  * layer-wise prefill pipelining — a flow may start while its prefill is
    still computing (release curve = prefill progress), so transfer overlaps
    compute and only the tail is exposed;
  * multi-connection TCP — flows share the link by processor sharing
    (max-min fair); per-flow parallelism is folded into the fair share;
  * congestion monitoring — utilization / queue-depth / drop signals are
    exported for the scheduler (§3.4.3 short-term loop).

Two integration modes over the same ``Link`` state:
  * ``tick(now, dt)`` — legacy fixed-step fluid draining (kept for the
    apples-to-apples equivalence test against the event engine);
  * ``advance(to)`` / ``next_event()`` — exact discrete-event solver.
    Between structural events the max-min fair allocation is computed by
    progressive filling (water-filling over per-flow release-rate caps),
    all rates are constant, and the next flow drain / ramp end / capacity
    resample time is found analytically — no bytes are drained per tick.
    Bandwidth fluctuation (an OU-like mean-reverting multiplicative
    process) is resampled on a coarse independent schedule (``fluct_dt``)
    so capacity is piecewise constant and the solve stays exact.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

_EPS_T = 1e-9          # time epsilon (s)
_EPS_B = 1e-6          # byte epsilon
_DROP_WINDOW_S = 30.0  # congestion-drop signal decay window


@dataclass
class Flow:
    flow_id: int
    total_bytes: float
    # layer-wise pipelining: bytes eligible for the wire at time t.  Either a
    # callable release curve (tick mode, arbitrary shape) or a linear ramp
    # [start_time, ramp_end] (event mode, exactly solvable).
    release: Optional[Callable[[float], float]] = None
    on_done: Optional[Callable[[float], None]] = None
    sent: float = 0.0
    start_time: float = 0.0
    ramp_end: Optional[float] = None
    done_time: Optional[float] = None

    def eligible(self, t: float) -> float:
        """Bytes allowed on the wire by time t (monotone, <= total).
        Nothing is eligible before the flow's start_time — a flow may be
        submitted ahead of the link clock (e.g. the deployment's virtual
        batches) and must not transfer bytes before it exists."""
        if t < self.start_time:
            return 0.0
        if self.ramp_end is not None:
            dur = self.ramp_end - self.start_time
            if dur <= 0.0:
                return self.total_bytes
            frac = (t - self.start_time) / dur
            return self.total_bytes * min(max(frac, 0.0), 1.0)
        if self.release is not None:
            return max(0.0, min(self.release(t), self.total_bytes))
        return self.total_bytes

    def release_rate(self, t: float) -> float:
        """d(eligible)/dt at time t — nonzero only on a linear ramp."""
        if self.ramp_end is None or t < self.start_time:
            return 0.0
        dur = self.ramp_end - self.start_time
        if dur <= 0.0 or t >= self.ramp_end - _EPS_T:
            return 0.0
        return self.total_bytes / dur

    def backlog(self, now: float) -> float:
        return max(0.0, self.eligible(now) - self.sent)


class Link:
    """Fair-share link with fluctuating capacity (fluid tick or exact event)."""

    def __init__(self, capacity_bps: float, fluctuation: float = 0.0,
                 revert: float = 0.2, seed: int = 0, fluct_dt: float = 0.25):
        self.capacity_bps = capacity_bps          # bits/s nominal
        self.fluctuation = fluctuation            # rel. std of capacity
        self.revert = revert
        self.fluct_dt = fluct_dt                  # event-mode resample period
        self._mult = 1.0
        self._rng = np.random.default_rng(seed)
        self.flows: Dict[int, Flow] = {}
        self._next_id = 0
        # event-mode clock + cached segment solution (rates are piecewise
        # constant between structural events, so absolute drain/completion
        # times are invariant until a flow joins/leaves/resamples)
        self.now = 0.0
        self._fluct_t = 0.0                       # last resample time
        self._seg_valid = False
        self._seg_rates: Dict[int, float] = {}
        self._seg_total = 0.0
        self._seg_backlogged = False
        self._seg_next = math.inf
        self._queue_stale = False
        # telemetry for the scheduler
        self.util_ewma = 0.0
        self.queue_bytes = 0.0
        self.drops_total = 0.0                    # cumulative congested "drops"
        self._drops_w = 0.0                       # windowed (decaying) drops
        self.sent_bytes = 0.0
        self.busy_time = 0.0

    # -------------------------------------------------------------- control
    def current_capacity(self) -> float:
        """bytes/s after fluctuation."""
        return self.capacity_bps * self._mult / 8.0

    @property
    def drops(self) -> float:
        """Windowed congestion-drop signal (decays over ~30 s) — NOT a
        monotonically growing counter; see ``drops_total`` for cumulative."""
        return self._drops_w

    def submit(self, total_bytes: float, now: float,
               release: Optional[Callable[[float], float]] = None,
               on_done: Optional[Callable[[float], None]] = None,
               ramp_end: Optional[float] = None) -> Flow:
        f = Flow(self._next_id, total_bytes, release, on_done,
                 start_time=now, ramp_end=ramp_end)
        self._next_id += 1
        self.flows[f.flow_id] = f
        self._seg_valid = False
        return f

    def _record_drops(self, n: float, dt: float):
        decay = math.exp(-dt / _DROP_WINDOW_S)
        self._drops_w = self._drops_w * decay + n
        self.drops_total += n

    def _fluct_step(self, dt: float):
        """One Euler step of the mean-reverting log-OU capacity multiplier."""
        z = self._rng.standard_normal()
        logm = math.log(self._mult)
        logm += -self.revert * logm * dt + self.fluctuation * math.sqrt(dt) * z
        self._mult = min(max(math.exp(logm), 0.3), 1.5)

    # ----------------------------------------------------------------- tick
    def tick(self, now: float, dt: float):
        """Legacy fixed-step fluid drain (engine="tick")."""
        if self.fluctuation > 0:
            self._fluct_step(dt)
        cap = self.current_capacity() * dt                   # bytes this tick
        active = [f for f in self.flows.values() if f.backlog(now) > 0]
        total_backlog = sum(f.backlog(now) for f in active)
        sent_this_tick = 0.0
        # processor sharing with redistribution of unused shares
        remaining = cap
        while active and remaining > 1e-9:
            share = remaining / len(active)
            nxt = []
            used = 0.0
            for f in active:
                take = min(f.backlog(now), share)
                f.sent += take
                used += take
                if f.backlog(now) > 0:
                    nxt.append(f)
            remaining -= used
            sent_this_tick += used
            if used <= 1e-12:
                break
            active = nxt
        # completions
        done = [f for f in self.flows.values()
                if f.sent >= f.total_bytes - 1e-6]
        for f in done:
            f.done_time = now + dt
            del self.flows[f.flow_id]
            if f.on_done:
                f.on_done(now + dt)
        # telemetry
        self.sent_bytes += sent_this_tick
        util = sent_this_tick / max(cap, 1e-9)
        self.util_ewma = 0.98 * self.util_ewma + 0.02 * util
        self.queue_bytes = max(0.0, total_backlog - sent_this_tick)
        congested = util > 0.999 and self.queue_bytes > 0
        self._record_drops(1.0 if congested else 0.0, dt)
        self.busy_time += dt * min(util, 1.0)
        self.now = now + dt

    # ---------------------------------------------------------- event solve
    def _fair_rates(self, t: float, cap_bps: float) -> Dict[int, float]:
        """Max-min fair rates by progressive filling (water-filling).

        Backlogged flows are greedy (uncapped); flows with no backlog but an
        active release ramp are paced at their release rate (their cap), and
        the unused share is redistributed to the rest.
        """
        entries = []
        for f in self.flows.values():
            backlog = f.eligible(t) - f.sent
            if backlog > _EPS_B:
                entries.append((math.inf, f))
            else:
                rr = f.release_rate(t)
                if rr > 0.0:
                    entries.append((rr, f))
        if not entries:
            return {}
        entries.sort(key=lambda e: e[0])
        rates: Dict[int, float] = {}
        remaining = cap_bps
        n = len(entries)
        for i, (cap, f) in enumerate(entries):
            share = remaining / (n - i)
            r = min(cap, share)
            rates[f.flow_id] = r
            remaining -= r
        return rates

    def _recompute_segment(self):
        """Solve the current fluid segment: fair rates at ``now`` plus the
        absolute time of the next structural change (a flow drains its
        eligible backlog and possibly completes, a release ramp ends, or
        the capacity resamples).  Valid until a flow joins/leaves or the
        structural time is reached."""
        t0 = self.now
        cap = self.current_capacity()
        rates = self._fair_rates(t0, cap)
        self._seg_rates = rates
        self._seg_total = sum(rates.values())
        self._seg_backlogged = False
        t = math.inf
        if self.fluctuation > 0:
            t = self._fluct_t + self.fluct_dt
        for f in self.flows.values():
            if f.start_time > t0 + _EPS_T:
                t = min(t, f.start_time)      # not-yet-started flow joins
                continue
            r = rates.get(f.flow_id, 0.0)
            rr = f.release_rate(t0)
            if f.ramp_end is not None and f.ramp_end > t0 + _EPS_T:
                t = min(t, f.ramp_end)
            backlog = f.eligible(t0) - f.sent
            if backlog > _EPS_B:
                self._seg_backlogged = True
                if r > rr + _EPS_B:
                    t = min(t, t0 + backlog / (r - rr))
        self._seg_next = t
        self._seg_valid = True

    def next_event(self) -> float:
        """Next time the event engine must wake the link (inf when idle)."""
        if not self.flows:
            return math.inf
        if not self._seg_valid:
            self._recompute_segment()
        return self._seg_next

    def _fire_completions(self):
        """Structural boundary at ``now``: invalidate the segment and fire
        on_done for every fully drained flow at the exact current time."""
        self._seg_valid = False
        done = [f for f in self.flows.values()
                if f.sent >= f.total_bytes - _EPS_B]
        for f in done:
            f.done_time = self.now
            del self.flows[f.flow_id]
        for f in done:
            if f.on_done:
                f.on_done(self.now)

    def _process_due_boundary(self):
        """A structural boundary lies within ``_EPS_T`` of the clock — a
        zero-length segment no positive-dt step can cross.  Snap the
        sub-epsilon residual backlogs the fair rates would drain in that
        instant (<= rate x eps bytes, by construction of the drain time)
        and fire completions.  Without this, a drain time landing inside
        the time epsilon livelocks the solver: ``next_event`` re-announces
        the same boundary ~1 ns ahead forever while the residual bytes
        never move."""
        for fid, r in self._seg_rates.items():
            f = self.flows.get(fid)
            if f is None:
                continue
            backlog = f.eligible(self.now) - f.sent
            if 0.0 < backlog <= max(r, 1.0) * (2.0 * _EPS_T):
                take = min(backlog, f.total_bytes - f.sent)
                f.sent += take
                self.sent_bytes += take
        self._fire_completions()

    def advance(self, to: float):
        """Exactly advance the fluid solution from ``self.now`` to ``to``,
        firing flow on_done callbacks at their exact completion times."""
        if not self.flows and self.fluctuation <= 0:
            # idle fast path (telemetry decays toward zero)
            if to <= self.now + _EPS_T:
                return
            self._telemetry_step(to - self.now, 0.0, congested=False)
            self.now = to
            return
        while True:
            if self.fluctuation > 0:
                boundary = self._fluct_t + self.fluct_dt
                if boundary <= self.now + _EPS_T:
                    self._fluct_step(self.fluct_dt)
                    self._fluct_t = boundary
                    self._seg_valid = False
                    continue
            if not self._seg_valid:
                self._recompute_segment()
            if self._seg_next <= self.now + _EPS_T:
                # zero-length segment: resolve it NOW (each pass strictly
                # removes its cause — drained backlog, expired ramp, or
                # started flow — so this cannot cycle)
                self._process_due_boundary()
                continue
            if to <= self.now + _EPS_T:
                break
            t_next = min(to, self._seg_next)
            dt = t_next - self.now
            if self._seg_rates:
                cap = self.current_capacity()
                for fid, r in self._seg_rates.items():
                    f = self.flows.get(fid)
                    if f is not None and r > 0.0:
                        f.sent = min(f.sent + r * dt, f.total_bytes)
                self.sent_bytes += self._seg_total * dt
                util = min(self._seg_total / max(cap, _EPS_B), 1.0)
                self._telemetry_step(
                    dt, util,
                    congested=(util >= 0.999 and self._seg_backlogged))
            else:
                self._telemetry_step(dt, 0.0, congested=False)
            self.now = t_next
            if t_next < self._seg_next - _EPS_T:
                break                 # mid-segment: solution still valid
            # structural boundary: completions fire exactly here
            self._fire_completions()
        self.now = max(self.now, to)
        self._queue_stale = True

    def run_until_idle(self, max_time: float = math.inf) -> float:
        """Drain all flows exactly; returns the time the link went idle."""
        while self.flows:
            t = self.next_event()
            if not math.isfinite(t) or t > max_time:
                break
            self.advance(t)
        return self.now

    def _telemetry_step(self, dt: float, util: float, congested: bool):
        # continuous-time EWMA with ~1 s time constant (the tick engine's
        # 0.98-per-20ms decay) so the router sees comparable signals;
        # congested fluid time converts to "drops" at the tick engine's
        # reference rate of one per 20 ms tick
        a = math.exp(-dt / 1.0)
        self.util_ewma = util + (self.util_ewma - util) * a
        self.busy_time += dt * util
        self._record_drops(dt / 0.02 if congested else 0.0, dt)

    def backlog_bytes(self) -> float:
        """Total bytes still owed by live flows (eligible or not): the
        conservation counterpart of ``sent_bytes`` — at any instant
        ``sent_bytes + backlog_bytes() == total bytes ever submitted``
        (within the solver's byte epsilon)."""
        return sum(f.total_bytes - f.sent for f in self.flows.values())

    # ------------------------------------------------------------ telemetry
    def congestion_signal(self) -> dict:
        if self._queue_stale:
            now = self.now
            self.queue_bytes = sum(f.backlog(now)
                                   for f in self.flows.values())
            self._queue_stale = False
        return {"util": self.util_ewma, "queue_bytes": self.queue_bytes,
                "drops": self._drops_w, "drops_total": self.drops_total,
                "inflight": len(self.flows)}


class LinkTopology:
    """N named clusters with one fair-share ``Link`` per connected unordered
    cluster pair (paper deployment story: one compute-dense PrfaaS cluster
    feeding several regional PD clusters over loosely coupled Ethernet).

    The topology is a thin routing matrix over independent ``Link`` solvers:
    each pair link keeps its own capacity, OU fluctuation process, and
    telemetry, so a congested PrfaaS->region-A link never slows region B.
    Pairs are unordered — a pair link carries both prefill KV egress and
    reverse cross-cache copies, exactly like the original single ``Link``
    (which makes a two-cluster topology bit-for-bit identical to it).

    ``advance``/``tick``/``next_event`` fan out to every member link so both
    simulator engines drive all links with one call; per-destination
    aggregation (``dest_signal``) gives the router the regional congestion
    view, while ``aggregate_signal`` preserves the legacy single-link
    telemetry shape for global control loops.
    """

    def __init__(self, clusters: List[str]):
        self.clusters = list(clusters)
        self._links: Dict[tuple, Link] = {}

    @staticmethod
    def _key(a: str, b: str) -> tuple:
        if a == b:
            raise ValueError(f"no self-link: {a!r}")
        return (a, b) if a < b else (b, a)

    @classmethod
    def build(cls, clusters: List[str], pairs: List[tuple],
              gbps, fluctuation=0.0, seed: int = 0,
              fluct_dt: float = 0.25) -> "LinkTopology":
        """Construct links for ``pairs``.  ``gbps``/``fluctuation`` may be
        scalars (shared) or per-pair sequences aligned with ``pairs``.  Link
        i is seeded ``seed + 7919*i`` so pair 0 of a single-pair topology
        reproduces a bare ``Link(seed=seed)`` exactly and additional links
        get independent fluctuation streams."""
        topo = cls(clusters)
        n = len(pairs)
        gbps_l = list(gbps) if hasattr(gbps, "__len__") else [gbps] * n
        fluct_l = (list(fluctuation) if hasattr(fluctuation, "__len__")
                   else [fluctuation] * n)
        if len(gbps_l) != n or len(fluct_l) != n:
            raise ValueError("per-pair gbps/fluctuation must match pairs")
        for i, (a, b) in enumerate(pairs):
            topo.add_link(a, b, Link(gbps_l[i] * 1e9,
                                     fluctuation=fluct_l[i],
                                     seed=seed + 7919 * i,
                                     fluct_dt=fluct_dt))
        return topo

    # ------------------------------------------------------------- wiring
    def add_link(self, a: str, b: str, link: Link):
        for c in (a, b):
            if c not in self.clusters:
                raise ValueError(f"unknown cluster {c!r}")
        self._links[self._key(a, b)] = link

    def link(self, a: str, b: str) -> Link:
        return self._links[self._key(a, b)]

    def has_link(self, a: str, b: str) -> bool:
        return a != b and self._key(a, b) in self._links

    def cache_reachable(self, home: str, name: str,
                        hub: str = "prfaas") -> bool:
        """Is cluster ``name``'s prefix cache usable by a request whose home
        is ``home``?  The home itself and the ``hub`` (PrfaaS) always are;
        another region only with pair links to BOTH possible prefill
        targets (home and hub) — a star-only topology cannot ship another
        region's cache anywhere useful.  The ONE reachability rule shared
        by the simulator and the live deployment (route agreement in
        ``launch.serve --cross-validate`` depends on it)."""
        if name == home or name == hub:
            return True
        return self.has_link(name, home) and self.has_link(name, hub)

    @property
    def links(self) -> Dict[tuple, Link]:
        return self._links

    # ----------------------------------------------------------- transfer
    def submit(self, a: str, b: str, total_bytes: float, now: float,
               **kw) -> Flow:
        """Charge a KV flow to the (a, b) pair link."""
        return self.link(a, b).submit(total_bytes, now, **kw)

    def advance(self, to: float):
        for link in self._links.values():
            link.advance(to)

    def tick(self, now: float, dt: float):
        for link in self._links.values():
            link.tick(now, dt)

    def next_event(self) -> float:
        return min((l.next_event() for l in self._links.values()),
                   default=math.inf)

    def run_until_idle(self, max_time: float = math.inf) -> float:
        """Drain all links exactly; returns the time the last one idled."""
        t = 0.0
        while True:
            nxt = self.next_event()
            if not math.isfinite(nxt) or nxt > max_time:
                return t
            self.advance(nxt)
            t = nxt

    # ------------------------------------------------------------ telemetry
    @property
    def sent_bytes(self) -> float:
        return sum(l.sent_bytes for l in self._links.values())

    def pair_signal(self, a: str, b: str) -> dict:
        return self.link(a, b).congestion_signal()

    def dest_signal(self, dst: str) -> dict:
        """Aggregate congestion toward ``dst`` over every incident link:
        worst-case util (one saturated ingress stalls that region), summed
        queues/drops/inflight."""
        incident = [l for (a, b), l in self._links.items() if dst in (a, b)]
        return self._aggregate(incident)

    def aggregate_signal(self) -> dict:
        """Topology-wide signal with the single-``Link`` telemetry shape
        (identical to that link's signal for a one-pair topology)."""
        return self._aggregate(list(self._links.values()))

    @staticmethod
    def _aggregate(links: List[Link]) -> dict:
        sigs = [l.congestion_signal() for l in links]
        if not sigs:
            return {"util": 0.0, "queue_bytes": 0.0, "drops": 0.0,
                    "drops_total": 0.0, "inflight": 0}
        return {"util": max(s["util"] for s in sigs),
                "queue_bytes": sum(s["queue_bytes"] for s in sigs),
                "drops": sum(s["drops"] for s in sigs),
                "drops_total": sum(s["drops_total"] for s in sigs),
                "inflight": sum(s["inflight"] for s in sigs)}

    def pair_backlogs(self) -> Dict[str, float]:
        """Per-pair live backlog (bytes still owed by in-flight flows) —
        with ``pair_stats()[pair]["sent_bytes"]`` this conserves the total
        bytes submitted to each pair link."""
        return {f"{a}|{b}": l.backlog_bytes()
                for (a, b), l in self._links.items()}

    def pair_stats(self) -> Dict[str, dict]:
        """Per-pair byte/utilization accounting for metrics and tests."""
        return {f"{a}|{b}": {"sent_bytes": l.sent_bytes,
                             "capacity_gbps": l.capacity_bps / 1e9,
                             "util_ewma": l.util_ewma,
                             "busy_time": l.busy_time,
                             "drops_total": l.drops_total,
                             "drops": l.drops,
                             "inflight": len(l.flows)}
                for (a, b), l in self._links.items()}


def star_pairs(hub: str, leaves: List[str],
               mesh: bool = False) -> List[tuple]:
    """Hub-and-spoke pair list (PrfaaS at the hub, one spoke per PD
    cluster), optionally adding the full leaf-to-leaf mesh so regional
    caches can cross-transfer without transiting the hub."""
    pairs = [(hub, leaf) for leaf in leaves]
    if mesh:
        pairs += [(a, b) for i, a in enumerate(leaves)
                  for b in leaves[i + 1:]]
    return pairs


def layerwise_release(prefill_start: float, prefill_time: float,
                      total_bytes: float, n_layers: int = 64):
    """Release curve for layer-wise pipelined prefill: layer i's KV becomes
    wire-eligible when its compute finishes (staircase, ~linear ramp).

    The event engine instead passes ``ramp_end`` to ``Link.submit`` (the
    fluid n_layers -> inf limit of this staircase), which solves exactly."""

    def release(t: float) -> float:
        if prefill_time <= 0:
            return total_bytes
        frac = (t - prefill_start) / prefill_time
        steps = math.floor(max(0.0, min(1.0, frac)) * n_layers)
        return total_bytes * steps / n_layers

    return release
