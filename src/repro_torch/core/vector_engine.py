"""Vectorized structure-of-arrays fast path for ``PrfaasSimulator``
(``SimConfig(engine="vector")``).

The exact event engine (``simulator._run_event``) processes one event at a
time; at production scale (1e6+ requests over hours of simulated time) the
Python event loop dominates.  This engine batches homogeneous events into
numpy SoA state and advances the world in fixed epochs of
``SimConfig.vector_dt`` seconds (default: ``control_dt``):

  * **arrivals** — all arrivals in an epoch are matched against the prefix
    caches and routed in one vectorized pass that mirrors
    ``Router.route``'s decision table exactly (regime split, best-cache
    scan in registration order, tie-prefers-target cache source, the
    ``n_prfaas==0`` / ``n_p==0`` overrides).  Congestion signals and
    per-home thresholds are frozen at epoch start — the event engine only
    updates them on the ``control_dt`` grid anyway.
  * **prefill pools** — an exact FIFO-c server pool over a finish-time
    heap (``heapreplace`` per job): start times are exact, not epoch
    quantized.  Without autoscaling the pool is drained eagerly at
    routing time; with autoscaling jobs start lazily per epoch so queue
    telemetry and capacity resizes happen on the control grid.
  * **links** — each fair-share pair link becomes a per-epoch fluid
    recurrence: layer-wise release ramps are pre-scattered into per-epoch
    rate-difference/lump arrays (``np.add.at``) and each epoch moves
    ``min(capacity, backlog + released)`` bytes.  Completions follow
    processor-sharing virtual time: V advances by ``sent / active_flows``
    per epoch and a flow finishes when V reaches ``V(ramp_end)`` plus its
    bytes left unserved at the ramp end (read off the aggregate S/R
    trajectories over the flow's own ramp window).  Uncongested links are
    exact — completion == ramp end; under congestion small flows overtake
    large backlogs exactly as max-min fair sharing does, with flow counts
    frozen per epoch.  OU bandwidth fluctuation is precomputed per link
    with the event engine's exact RNG stream (``seed + 7919*i``, one
    ``standard_normal`` per ``fluct_dt``).
  * **decode** — without autoscaling decode feeds back into nothing, so
    slot contention is solved in one closed-form post-pass: sort ready
    times per home and solve the FIFO-c recurrence
    ``start_i = max(r_i, start_{i-c} + s)`` per residue class with a
    ``np.maximum.accumulate`` (service is constant per run).  With
    autoscaling a per-epoch heap pool keeps queue telemetry exact.
  * **caches** — a vectorized twin of ``SimPrefixCache`` holds per-cluster
    per-session block coverage / snapshot counts as arrays.  Because a
    session's request lengths are non-decreasing, the longest resumable
    prefix is always the full covered coverage, so ``match`` is one
    gather; LRU is an append-only (session, stamp) log with stale-entry
    skipping, giving the same whole-chain eviction order.

Equivalence contract: held to the same 5% band as the tick engine on
throughput / TTFT mean / TTFT P90 / offload fraction / egress
(``tests/test_sim_event_engine.py``), with known quantizations: control
and insert timing rounded to the epoch grid, flow completion order under
sustained congestion, and single-epoch LRU interleavings.  The event
engine stays the default; the golden trace never runs through this path.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.autoscaler import StageTelemetry
from repro_torch.core.router import PRFAAS

_EPS_B = 1e-6


class _VecPool:
    """Exact FIFO server pool over a finish-time heap (``EventPool`` twin).

    ``extend`` enqueues jobs in submission order; ``process(until)`` starts
    every queued job whose exact start time (max of its ready time and the
    earliest server-free time) is <= ``until``.  Capacity decrease pops the
    earliest finish time — exactly ``EventPool.set_capacity``'s semantics,
    where the first finisher's slot disappears because ``release`` checks
    ``busy < capacity`` after decrementing."""

    def __init__(self, capacity: int, n_homes: int = 1):
        self.capacity = max(int(capacity), 0)
        self.heap: List[float] = [0.0] * self.capacity
        self.q: deque = deque()                 # (ready, service, idx, home)
        self.home_pending = np.zeros(max(n_homes, 1), np.int64)

    def extend(self, ready, service, idx, homes):
        self.q.extend(zip(ready.tolist(), service.tolist(),
                          idx.tolist(), homes.tolist()))
        np.add.at(self.home_pending, homes, 1)

    def process(self, until: float):
        starts: List[float] = []
        dones: List[float] = []
        idxs: List[int] = []
        h, q = self.heap, self.q
        while q and h:
            r, s, i, hm = q[0]
            st = r if r >= h[0] else h[0]
            if st > until:
                break
            heapq.heapreplace(h, st + s)
            q.popleft()
            self.home_pending[hm] -= 1
            starts.append(st)
            dones.append(st + s)
            idxs.append(i)
        return (np.array(idxs, np.int64), np.array(starts, np.float64),
                np.array(dones, np.float64))

    def set_capacity(self, cap: int, now: float):
        cap = max(int(cap), 0)
        while self.capacity > cap and self.heap:
            heapq.heappop(self.heap)
            self.capacity -= 1
        while self.capacity < cap:
            heapq.heappush(self.heap, now)
            self.capacity += 1

    def pending(self) -> int:
        return len(self.q)


def _fifo_lanes(ready_sorted: np.ndarray, c: int, s: float) -> np.ndarray:
    """Closed-form FIFO-c start times for constant service ``s``: request i
    (in ready order) is served by the server that finished request i-c, so
    ``start_i = max(r_i, start_{i-c} + s)`` — solved per residue class as
    ``max.accumulate(r_j - j*s) + j*s``."""
    n = len(ready_sorted)
    start = np.empty(n, np.float64)
    if c <= 0:
        start.fill(np.inf)
        return start
    for j in range(min(c, n)):
        lane = ready_sorted[j::c]
        m = np.arange(len(lane), dtype=np.float64)
        start[j::c] = np.maximum.accumulate(lane - m * s) + m * s
    return start


class _VecCache:
    """Vectorized ``SimPrefixCache`` twin over all clusters at once.

    Per (cluster, session): covered blocks, snapshot count, and the stamp
    of the latest LRU touch.  Request lengths are non-decreasing within a
    session, so a match is always the full coverage (one gather) and an
    insert only ever grows coverage by ``n - old + 1`` blocks (+1 = the
    new linear snapshot).  LRU eviction replays an append-only
    (session, stamp) log, skipping entries whose stamp is stale — the
    surviving order is exactly the OrderedDict move-to-end order."""

    def __init__(self, n_clusters: int, n_sessions: int, num_blocks: int,
                 block_tokens: int):
        self.C, self.bt = n_clusters, block_tokens
        self.num_blocks = num_blocks
        self.blocks = np.zeros((n_clusters, n_sessions), np.int64)
        self.snaps = np.zeros((n_clusters, n_sessions), np.int32)
        self.pos = np.full((n_clusters, n_sessions), -1, np.int64)
        self.used = [0] * n_clusters
        self.chains = [0] * n_clusters
        self.hits = [0] * n_clusters
        self.misses = [0] * n_clusters
        self.hit_tokens = [0] * n_clusters
        self.allocated = [0] * n_clusters
        self.evicted = [0] * n_clusters
        self.alloc_fail = [0] * n_clusters
        self._pend = [([], []) for _ in range(n_clusters)]  # sid/stamp arrays
        self._flat = [(np.empty(0, np.int64), np.empty(0, np.int64), 0)
                      for _ in range(n_clusters)]
        self._ctr = 0

    def touch(self, c: int, sids: np.ndarray):
        n = len(sids)
        if n == 0:
            return
        stamps = np.arange(self._ctr, self._ctr + n, dtype=np.int64)
        self._ctr += n
        self.pos[c, sids] = stamps
        self._pend[c][0].append(np.asarray(sids, np.int64))
        self._pend[c][1].append(stamps)

    def insert_batch(self, c: int, sids: np.ndarray, nblks: np.ndarray):
        pos = nblks > 0                          # insert(n<=0) is a no-op
        sids, nblks = sids[pos], nblks[pos]
        if len(sids) == 0:
            return
        if np.unique(sids).size < sids.size:
            # same session twice in one epoch batch: fall back to exact
            # sequential semantics (each insert sees the previous one)
            for s, n in zip(sids.tolist(), nblks.tolist()):
                self._insert_one(c, s, n)
            return
        fail = nblks + 1 > self.num_blocks
        self.alloc_fail[c] += int(fail.sum())
        sids, nblks = sids[~fail], nblks[~fail]
        if len(sids) == 0:
            return
        old = self.blocks[c, sids]
        grow = nblks > old
        delta = np.where(grow, nblks - old + 1, 0)
        self.chains[c] += int((grow & (old == 0)).sum())
        gs = sids[grow]
        self.blocks[c, gs] = nblks[grow]
        self.snaps[c, gs] += 1
        tot = int(delta.sum())
        self.used[c] += tot
        self.allocated[c] += tot
        self.touch(c, sids)                      # insert == MRU touch
        if self.used[c] > self.num_blocks:
            self._evict_over(c)

    def _insert_one(self, c: int, sid: int, n: int):
        if n + 1 > self.num_blocks:
            self.alloc_fail[c] += 1
            return
        old = int(self.blocks[c, sid])
        if n > old:
            delta = n - old + 1
            if old == 0:
                self.chains[c] += 1
            self.blocks[c, sid] = n
            self.snaps[c, sid] += 1
            self.used[c] += delta
            self.allocated[c] += delta
        self.touch(c, np.array([sid], np.int64))
        if self.used[c] > self.num_blocks:
            self._evict_over(c)

    def _pop_lru(self, c: int) -> Optional[int]:
        sid_f, st_f, head = self._flat[c]
        while True:
            if head >= len(sid_f):
                pend = self._pend[c]
                if not pend[0]:
                    self._flat[c] = (sid_f, st_f, head)
                    return None
                sid_f = np.concatenate(pend[0])
                st_f = np.concatenate(pend[1])
                pend[0].clear()
                pend[1].clear()
                head = 0
            s, st = int(sid_f[head]), int(st_f[head])
            head += 1
            if self.pos[c, s] == st and self.blocks[c, s] > 0:
                self._flat[c] = (sid_f, st_f, head)
                return s

    def _evict_over(self, c: int):
        ev = 0
        while self.used[c] > self.num_blocks and self.chains[c] > 1:
            s = self._pop_lru(c)
            if s is None:
                break
            freed = int(self.blocks[c, s]) + int(self.snaps[c, s])
            self.used[c] -= freed
            ev += freed
            self.blocks[c, s] = 0
            self.snaps[c, s] = 0
            self.pos[c, s] = -1
            self.chains[c] -= 1
        self.evicted[c] += ev

    def stats(self, names: List[str]) -> dict:
        out = {}
        for c, name in enumerate(names):
            tot = self.hits[c] + self.misses[c]
            out[name] = {
                "hit_rate": self.hits[c] / tot if tot else 0.0,
                "pool_util": self.used[c] / max(1, self.num_blocks),
                "evicted": self.evicted[c],
                "pool": {"allocated": self.allocated[c],
                         "evicted": self.evicted[c], "freed": 0,
                         "alloc_fail": self.alloc_fail[c],
                         "resident": self.used[c],
                         "used_blocks": self.used[c],
                         "num_blocks": self.num_blocks}}
        return out


class _VecLink:
    """One pair link as a per-epoch fluid recurrence (see module doc)."""

    def __init__(self, capacity_bps: float, cap_bytes_per_epoch: np.ndarray,
                 n_ep: int):
        self.capacity_bps = capacity_bps
        self.capB = cap_bytes_per_epoch         # byte capacity per epoch
        # release accounting: running-ramp rate diffs + partial-epoch bytes,
        # split into paced ramp segments vs instantaneous lumps (the split
        # feeds the water-filling V-rate: greedy lump/backlogged flows soak
        # up whatever pacing leaves unused)
        self.rate_diff = np.zeros(n_ep + 2, np.float64)
        self.extra_p = np.zeros(n_ep + 1, np.float64)
        self.extra_l = np.zeros(n_ep + 1, np.float64)
        self.rate = 0.0
        self.backlog = 0.0
        self.R = 0.0                            # total released
        self.S = 0.0                            # total sent
        self.submitted = 0.0                    # conservation: bytes charged
        self.n_flows = 0
        self.n_done = 0
        # processor-sharing virtual time: V advances by sent/active per
        # epoch, so a flow's fair-share service is V(now) - V(join).  S/R
        # histories at epoch starts let late ramp-end marks reconstruct the
        # aggregate served fraction over their own ramp window.
        self.V = 0.0
        self.act = 0                            # flows joined - completed
        self.join = np.zeros(n_ep + 1, np.int64)
        self.S_hist = np.zeros(n_ep + 2, np.float64)
        self.R_hist = np.zeros(n_ep + 2, np.float64)
        # waiting completions: a flow finishes at the EARLIER of its
        # virtual-time crossing (fair-share order) and its sent-byte
        # crossing (total-drain order) — each is exact in the regime the
        # other mis-ranks
        self.wait_V = np.empty(0, np.float64)
        self.wait_S = np.empty(0, np.float64)
        self.wait_re = np.empty(0, np.float64)
        self.wait_req = np.empty(0, np.int64)
        # telemetry (event-engine formulas)
        self.util_ewma = 0.0
        self.busy_time = 0.0
        self.drops_w = 0.0
        self.drops_total = 0.0
        self.sent_at_warmup = 0.0


class _VectorEngine:
    def __init__(self, sim):
        self.sim = sim                          # the PrfaasSimulator
        cfg = sim.sim
        raw = cfg.vector_dt if getattr(cfg, "vector_dt", 0.0) > 0 \
            else max(cfg.control_dt, 1e-3)
        # snap the epoch length onto the control grid (divisor below it,
        # multiple above it) so control/telemetry sampling happens at the
        # same instants as the event engine's control events — an epoch
        # boundary drifting past the control tick skews the util_ewma the
        # router sees and flips regime decisions near the boundary
        cd = cfg.control_dt
        if cd > 0:
            if raw <= cd:
                self.dt = cd / max(1, round(cd / raw))
            else:
                self.dt = cd * max(1, round(raw / cd))
        else:
            self.dt = raw
        self.T = cfg.sim_time
        self.n_ep = max(1, int(math.ceil(self.T / self.dt - 1e-12)))
        self.edges = np.minimum(np.arange(self.n_ep + 1) * self.dt, self.T)
        self.names = [PRFAAS] + sim._pd_names   # cluster index space
        self.k = len(sim._pd_names)
        self.eager = not cfg.autoscale

    # ------------------------------------------------------------- helpers
    def _ep(self, t: float) -> int:
        return min(int(t / self.dt), self.n_ep - 1)

    def _ep_arr(self, t: np.ndarray) -> np.ndarray:
        return np.minimum((t / self.dt).astype(np.int64), self.n_ep - 1)

    # -------------------------------------------------------------- traces
    def _load_trace(self):
        sim = self.sim
        soa = getattr(sim, "_soa_trace", None)
        if soa is not None:
            self.reqs = None
            self.arrival = np.asarray(soa.arrival, np.float64)
            self.total = np.asarray(soa.total_len, np.int64)
            self.sess = np.asarray(soa.session, np.int64)
            hmap = {}
            for i, n in enumerate(soa.home_names):
                if n not in sim._pd_names:
                    raise ValueError(f"trace home {n!r} not in simulator "
                                     f"clusters {sim._pd_names}")
                hmap[i] = sim._pd_names.index(n)
            lut = np.array([hmap[i] for i in range(len(soa.home_names))],
                           np.int64)
            self.home = lut[np.asarray(soa.home, np.int64)]
        else:
            reqs = sim._generate_arrivals()
            self.reqs = reqs
            self.arrival = np.array([r.arrival for r in reqs], np.float64)
            self.total = np.array([r.total_len for r in reqs], np.int64)
            self.sess = np.array([r.session for r in reqs], np.int64)
            pidx = {n: i for i, n in enumerate(sim._pd_names)}
            self.home = np.array([pidx[r.home] for r in reqs], np.int64)
        self.N = len(self.arrival)
        self.n_sess = int(self.sess.max()) + 1 if self.N else 1

    # --------------------------------------------------------------- links
    def _build_links(self):
        sim = self.sim
        self.link_keys = list(sim.topology.links.keys())
        self.links: List[_VecLink] = []
        nidx = {n: i for i, n in enumerate(self.names)}
        self.pair_link = np.full((len(self.names), len(self.names)), -1,
                                 np.int64)
        for li, (a, b) in enumerate(self.link_keys):
            real = sim.topology.links[(a, b)]
            capB = self._cap_bytes(real)
            self.links.append(_VecLink(real.capacity_bps, capB, self.n_ep))
            ia, ib = nidx[a], nidx[b]
            self.pair_link[ia, ib] = self.pair_link[ib, ia] = li
        # star link index per home (PrfaaS <-> pd), for regime signals
        self.star = np.array(
            [self.pair_link[0, 1 + h] for h in range(self.k)], np.int64)

    def _cap_bytes(self, real) -> np.ndarray:
        """Per-epoch byte capacity with the event engine's exact OU draw
        sequence: one ``standard_normal`` per ``fluct_dt`` boundary from
        ``default_rng(seed + 7919*i)`` (the link's own generator seed)."""
        cap = real.capacity_bps / 8.0
        if real.fluctuation <= 0:
            return cap * np.diff(self.edges)
        fdt = real.fluct_dt
        n_f = int(math.floor(self.T / fdt + 1e-9))
        # the real Link objects are never advanced in vector mode, so its
        # generator is ours to consume — the exact same PCG64 stream the
        # event engine would draw from
        z = real._rng.standard_normal(n_f)
        mult = np.empty(n_f + 2, np.float64)
        mult[0] = 1.0
        m, rev, fl, sq = 1.0, real.revert, real.fluctuation, math.sqrt(fdt)
        for j in range(n_f):
            logm = math.log(m)
            logm += -rev * logm * fdt + fl * sq * z[j]
            m = min(max(math.exp(logm), 0.3), 1.5)
            mult[j + 1] = m
        mult[n_f + 1] = m                        # pad past the horizon
        grid = np.arange(n_f + 3) * fdt
        cum = np.concatenate([[0.0], np.cumsum(mult * fdt)]) * cap
        return np.diff(np.interp(self.edges, grid, cum))

    # ------------------------------------------------------------- routing
    def _route_batch(self, ai: np.ndarray, e: int):
        sim, router = self.sim, self.sim.router
        C = len(self.names)
        h = self.home[ai]
        sid = self.sess[ai]
        L = self.total[ai]
        nblk = L // sim.sim.block_tokens
        thr = np.array([router.threshold_for(n) for n in sim._pd_names])
        star_util = np.array([self.links[s].util_ewma for s in self.star])
        abundant = star_util[h] < router.cfg.util_abundant
        # vectorized cache match: coverage is the full resumable prefix
        # (session lengths are non-decreasing -> n >= coverage always)
        M = np.zeros((len(ai), C), np.int64)
        valid = nblk > 0
        for c in range(C):
            ok = self.reach[h, c] & valid
            blk = self.cache.blocks[c, sid]
            hit = ok & (blk > 0)
            M[:, c] = np.where(hit, blk * sim.sim.block_tokens, 0)
            self.cache.hits[c] += int(hit.sum())
            self.cache.misses[c] += int((ok & ~hit).sum())
            self.cache.hit_tokens[c] += int(M[hit, c].sum())
            self.cache.touch(c, sid[hit])
        home_cl = h + 1
        l_home = M[np.arange(len(ai)), home_cl]
        l_prfaas = M[:, 0]
        t = thr[h]
        # abundant regime: best cache anywhere, first-strictly-greater in
        # registration order, starting from home
        best = home_cl.copy()
        lp = l_home.copy()
        for c in range(C):
            upd = M[:, c] > lp
            best[upd] = c
            lp[upd] = M[upd, c]
        tgt_ab = np.where(L - lp <= t, home_cl, 0)
        m_tgt = M[np.arange(len(ai)), tgt_ab]
        cc_ab = np.where(m_tgt >= lp, tgt_ab, best)
        cross_ab = (cc_ab != tgt_ab) & (lp > 0)
        # scarce regime: home and PrfaaS caches evaluated independently
        local = (L - l_home) <= t
        tgt_sc = np.where(local, home_cl, 0)
        cached_sc = np.where(local, l_home, l_prfaas)
        target = np.where(abundant, tgt_ab, tgt_sc).astype(np.int64)
        cached = np.where(abundant, lp, cached_sc).astype(np.int64)
        cache_cl = np.where(abundant, cc_ab, tgt_sc).astype(np.int64)
        cross = np.where(abundant, cross_ab, False)
        if sim.system.n_prfaas == 0:
            target, cached, cache_cl = home_cl, l_home, home_cl
            cross = np.zeros(len(ai), bool)
        elif sim.system.n_p == 0:
            target = np.zeros(len(ai), np.int64)
            cached, cache_cl = l_prfaas, target
            cross = np.zeros(len(ai), bool)
        incr = L - cached
        # mirror the Router's counters so downstream telemetry/metrics see
        # the same decision stream
        for c in range(C):
            n = int((target == c).sum())
            if n:
                router.decisions[self.names[c]] = \
                    router.decisions.get(self.names[c], 0) + n
        router.cross_transfers += int(cross.sum())
        for hh, name in enumerate(sim._pd_names):
            sel = h == hh
            if sel.any():
                acc = sim._route_tokens[name]
                acc[0] += int(cached[sel].sum())
                acc[1] += int(L[sel].sum())
        # store per-request decision state
        self.target[ai] = target
        self.cached[ai] = cached
        self.cache_cl[ai] = cache_cl
        self.cross[ai] = cross
        # service times + wire bytes
        incr_c = np.maximum(incr, 1).astype(np.float64)
        svc = np.empty(len(ai), np.float64)
        on_hub = target == 0
        if on_hub.any():
            svc[on_hub] = sim.model.prfaas_profile.t_prefill_vec(
                incr_c[on_hub])
        if (~on_hub).any():
            svc[~on_hub] = sim.model.pd_profile.t_prefill_vec(
                incr_c[~on_hub])
        self.service[ai] = svc
        prof = sim._wire_profile()
        if on_hub.any():
            hubL = L[on_hub].astype(np.float64)
            wb = prof.s_kv_vec(hubL)
            ch = cached[on_hub]
            has = ch > 0
            if has.any():
                sub = np.zeros(len(wb))
                sub[has] = prof.s_kv_vec(ch[has].astype(np.float64))
                wb = wb - sub
            self.wire_b[ai[on_hub]] = np.maximum(wb / sim._wire_comp, 1.0)
        xs = cross & (cached > 0)
        self.cross[ai] = xs                      # event guards cached>0 too
        if xs.any():
            self.cross_b[ai[xs]] = np.maximum(
                prof.s_kv_vec(cached[xs].astype(np.float64))
                / sim._wire_comp, 1.0)
        # enqueue into prefill pools (arrival order preserved per pool)
        for c in range(C):
            sel = target == c
            if sel.any():
                self.pools[c].extend(self.arrival[ai[sel]], svc[sel],
                                     ai[sel], h[sel])

    # --------------------------------------------------------- flow starts
    def _handle_starts(self, idx, start, done, e: int):
        if len(idx) == 0:
            return
        self.pf_start[idx] = start
        self.pf_done[idx] = done
        tgt = self.target[idx]
        on_hub = tgt == 0
        nfl = on_hub.astype(np.int32) + self.cross[idx].astype(np.int32)
        self.flows_left[idx] = nfl
        # requests with no link flows: transfer is free, ready at prefill end
        free = nfl == 0
        if free.any():
            self.tr_done[idx[free]] = done[free]
            self._mark_ready(idx[free], done[free], e)
        # main KV flow: PrfaaS -> home star link, linear ramp [start, done]
        if on_hub.any():
            sel = idx[on_hub]
            li = self.star[self.home[sel]]
            self._scatter_flow(li, start[on_hub], done[on_hub],
                               self.wire_b[sel], sel)
        xs = self.cross[idx]
        if xs.any():
            sel = idx[xs]
            li = self.pair_link[self.cache_cl[sel], self.target[sel]]
            st = start[xs]
            self._scatter_flow(li, st, st, self.cross_b[sel], sel)

    def _scatter_flow(self, li, start, end, nbytes, req):
        """Scatter flow release ramps into per-link per-epoch accounting and
        register completion marks at each flow's ramp-end epoch."""
        n_ep, dt = self.n_ep, self.dt
        inside = start <= self.T + 1e-9
        li, start, end = li[inside], start[inside], end[inside]
        nbytes, req = nbytes[inside], req[inside]
        if len(li) == 0:
            return
        e0 = self._ep_arr(start)
        dur = end - start
        ramp = dur > 1e-12
        lump = ~ramp
        e1 = np.where(ramp, self._ep_arr(np.minimum(end, self.T)), e0)
        same = ramp & (self._ep_arr(end) == e0) & (end <= self.T + 1e-9)
        # treat beyond-horizon ramp ends via rate columns only
        over = ramp & (end > self.T + 1e-9)
        for l in np.unique(li):
            L = self.links[l]
            m = li == l
            L.submitted += float(nbytes[m].sum())
            L.n_flows += int(m.sum())
            np.add.at(L.join, e0[m], 1)
            # instantaneous lumps vs single-epoch ramps (paced)
            w = m & lump
            if w.any():
                np.add.at(L.extra_l, e0[w], nbytes[w])
            w = m & same
            if w.any():
                np.add.at(L.extra_p, e0[w], nbytes[w])
            # multi-epoch ramps: partial first, full middle, partial last
            w = m & ramp & ~same
            if w.any():
                rho = nbytes[w] / dur[w]
                a, b = e0[w], e1[w]
                np.add.at(L.extra_p, a,
                          rho * (self.edges[np.minimum(a + 1, n_ep)]
                                 - start[w]))
                np.add.at(L.rate_diff, np.minimum(a + 1, n_ep + 1), rho)
                ov = over[w]
                np.add.at(L.rate_diff,
                          np.where(ov, n_ep + 1, b), -rho)
                tail = ~ov
                if tail.any():
                    np.add.at(L.extra_p, b[tail],
                              rho[tail] * (end[w][tail]
                                           - self.edges[b[tail]]))
        # completion marks at the ramp-end epoch (skip beyond-horizon ends:
        # the event engine never fires those either)
        fin = end <= self.T + 1e-9
        if fin.any():
            ee = self._ep_arr(end[fin])
            for e in np.unique(ee):
                m = ee == e
                self.ramp_q.setdefault(int(e), []).append(
                    (li[fin][m], end[fin][m], req[fin][m],
                     start[fin][m], nbytes[fin][m]))

    def _mark_ready(self, idx, ready, e: int):
        ok = ready <= self.T + 1e-9
        idx, ready = idx[ok], ready[ok]
        if len(idx) == 0:
            return
        self.ready_t[idx] = ready
        # cache insert at ready time, applied at the next epoch boundary
        eb = np.minimum(self._ep_arr(ready) + 1, self.n_ep)
        for b in np.unique(eb):
            m = eb == b
            self.insert_q.setdefault(int(b), []).append(idx[m])
        if not self.eager:
            ed = np.maximum(self._ep_arr(ready), e)
            for b in np.unique(ed):
                m = ed == b
                self.ready_q.setdefault(int(b), []).append(
                    (ready[m], idx[m]))

    def _apply_inserts(self, e: int):
        batch = self.insert_q.pop(e, None)
        if not batch:
            return
        idx = np.concatenate(batch)
        tgt = self.target[idx]
        for c in np.unique(tgt):
            m = tgt == c
            self.cache.insert_batch(
                int(c), self.sess[idx[m]],
                self.total[idx[m]] // self.sim.sim.block_tokens)

    # ------------------------------------------------------------ link epoch
    def _links_epoch(self, e: int):
        t0, t1 = float(self.edges[e]), float(self.edges[e + 1])
        dte = t1 - t0
        if dte <= 0:
            return
        marks = self.ramp_q.pop(e, None)
        if marks:
            ml = np.concatenate([m[0] for m in marks])
            mre = np.concatenate([m[1] for m in marks])
            mreq = np.concatenate([m[2] for m in marks])
            mst = np.concatenate([m[3] for m in marks])
            mby = np.concatenate([m[4] for m in marks])
        done_req: List[np.ndarray] = []
        done_t: List[np.ndarray] = []
        for li, L in enumerate(self.links):
            L.rate += L.rate_diff[e]
            paced = L.rate * dte + L.extra_p[e]
            rel = paced + L.extra_l[e]
            Rprev = L.R
            L.R += rel
            cap = float(L.capB[e])
            sent = min(cap, L.backlog + rel)
            Sprev = L.S
            L.S += sent
            L.backlog += rel - sent
            L.S_hist[e] = Sprev
            L.R_hist[e] = Rprev
            L.S_hist[e + 1] = L.S
            L.R_hist[e + 1] = L.R
            L.act += int(L.join[e])
            act = max(L.act, 1)
            Vprev = L.V
            # water-filling V-rate for greedy (past-ramp-end / lump) flows:
            # they soak up what pacing leaves unused when bandwidth is
            # plentiful, and degrade to an equal 1/active share when not.
            # vinc is the epoch's actual per-waiter service; g is the
            # instantaneous per-waiter drain rate (bytes/s) that maps
            # virtual-time crossings back to wall-clock within the epoch —
            # an idle-link lump completes in B/capacity seconds, not a
            # whole epoch.
            n_new = int((ml == li).sum()) if marks else 0
            n_wait = max(len(L.wait_V) + n_new, 1)
            vinc = max(sent - paced, sent * n_wait / act) / n_wait
            L.V += vinc
            cps = cap / dte
            g = max(cps - paced / dte, cps * n_wait / act) / n_wait
            g = max(g, _EPS_B)
            if L.backlog < _EPS_B:
                L.backlog = 0.0
            util = sent / cap if cap > 0 else 0.0
            a = math.exp(-dte)
            L.util_ewma = util + (L.util_ewma - util) * a
            L.busy_time += dte * util
            congested = util >= 0.999 and L.backlog > _EPS_B
            decay = math.exp(-dte / 30.0)
            add = dte / 0.02 if congested else 0.0
            L.drops_w = L.drops_w * decay + add
            L.drops_total += add
            if self.warm_ep == e:
                frac = (self.warm_t - t0) / dte
                L.sent_at_warmup = Sprev + sent * min(max(frac, 0.0), 1.0)
            # register this epoch's ramp-end marks.  A flow needs virtual
            # time V(ramp_end) + unserved bytes, where the unserved fraction
            # is read off the aggregate S/R trajectories over its own ramp
            # window: exact (completes at ramp_end) when the link kept up,
            # fair-share-ordered when a backlog formed.
            if marks:
                m = ml == li
                if m.any():
                    re = mre[m]
                    rq = mreq[m]
                    a = mst[m]
                    B = mby[m]
                    fr = (re - t0) / dte
                    S_re = Sprev + sent * fr
                    R_re = Rprev + rel * fr
                    ea = self._ep_arr(a)
                    t0a = self.edges[ea]
                    dta = np.maximum(self.edges[ea + 1] - t0a, 1e-12)
                    fra = (a - t0a) / dta
                    Sa = L.S_hist[ea] + (L.S_hist[ea + 1]
                                         - L.S_hist[ea]) * fra
                    Ra = L.R_hist[ea] + (L.R_hist[ea + 1]
                                         - L.R_hist[ea]) * fra
                    den = R_re - Ra
                    frac = np.where(
                        den > _EPS_B,
                        (S_re - Sa) / np.maximum(den, _EPS_B), 0.0)
                    frac = np.clip(frac, 0.0, 1.0)
                    vre = np.minimum(g * (re - t0), vinc)
                    needV = Vprev + vre + B * (1.0 - frac)
                    needS = R_re
                    L.wait_V = np.concatenate([L.wait_V, needV])
                    L.wait_S = np.concatenate([L.wait_S, needS])
                    L.wait_re = np.concatenate([L.wait_re, re])
                    L.wait_req = np.concatenate([L.wait_req, rq])
            if len(L.wait_V):
                doneV = L.wait_V <= L.V + _EPS_B
                doneS = L.wait_S <= L.S + _EPS_B
                dm = doneV | doneS
                pos = int(dm.sum())
                if pos:
                    dre = L.wait_re[dm]
                    rate_s = sent / dte
                    tcV = np.where(doneV[dm],
                                   t0 + (L.wait_V[dm] - Vprev) / g, np.inf)
                    if rate_s > 0:
                        tcS = np.where(doneS[dm],
                                       t0 + (L.wait_S[dm] - Sprev) / rate_s,
                                       np.inf)
                    else:
                        tcS = np.where(doneS[dm], t1, np.inf)
                    tc = np.minimum(tcV, tcS)
                    tc = np.minimum(np.maximum(tc, dre), t1)
                    done_req.append(L.wait_req[dm])
                    done_t.append(tc)
                    L.n_done += pos
                    L.act -= pos
                    keep = ~dm
                    L.wait_V = L.wait_V[keep]
                    L.wait_S = L.wait_S[keep]
                    L.wait_re = L.wait_re[keep]
                    L.wait_req = L.wait_req[keep]
        if done_req:
            dr = np.concatenate(done_req)
            dtm = np.concatenate(done_t)
            np.maximum.at(self.tr_done, dr, dtm)
            np.subtract.at(self.flows_left, dr, 1)
            cand = np.unique(dr)
            fin = cand[self.flows_left[cand] == 0]
            if len(fin):
                ready = np.maximum(self.pf_done[fin], self.tr_done[fin])
                self._mark_ready(fin, ready, e)

    # ------------------------------------------------------------- control
    def _control(self, t1: float):
        sim = self.sim
        for hh, name in enumerate(sim._pd_names):
            row = self.pair_link[1 + hh]
            incident = [self.links[int(li)] for li in row[row >= 0]]
            sig = {"util": max((L.util_ewma for L in incident), default=0.0),
                   "queue_bytes": sum(L.backlog for L in incident),
                   "drops": sum(L.drops_w for L in incident),
                   "drops_total": sum(L.drops_total for L in incident),
                   "inflight": sum(L.act for L in incident)}
            sim.router.observe_congestion(sig, home=name)
        for name in (sim._pd_names if sim.autoscalers else ()):
            hh = sim._pd_names.index(name)
            tel = StageTelemetry(
                prefill_queue=int(self.pools[0].home_pending[hh])
                + self.pools[1 + hh].pending(),
                decode_queue=self.dec_pools[hh].pending(),
                cached_tokens=sim._route_tokens[name][0],
                routed_tokens=sim._route_tokens[name][1])
            new_sys = sim.autoscalers[name].maybe_rebalance(t1, tel)
            if new_sys is not None:
                self.pools[1 + hh].set_capacity(new_sys.n_p, t1)
                self.dec_pools[hh].set_capacity(
                    new_sys.n_d * sim.w.bs_max, t1)

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        sim = self.sim
        self._load_trace()
        N = self.N
        # decision + execution state (SoA)
        self.target = np.full(N, -1, np.int64)
        self.cached = np.zeros(N, np.int64)
        self.cache_cl = np.full(N, -1, np.int64)
        self.cross = np.zeros(N, bool)
        self.service = np.zeros(N, np.float64)
        self.wire_b = np.zeros(N, np.float64)
        self.cross_b = np.zeros(N, np.float64)
        self.pf_start = np.full(N, -1.0)
        self.pf_done = np.full(N, -1.0)
        self.tr_done = np.full(N, -1.0)
        self.flows_left = np.zeros(N, np.int32)
        self.ready_t = np.full(N, np.inf)
        self.dec_start = np.full(N, -1.0)
        self.ramp_q: Dict[int, list] = {}
        self.insert_q: Dict[int, list] = {}
        self.ready_q: Dict[int, list] = {}
        C = len(self.names)
        self.reach = np.zeros((self.k, C), bool)
        for hh, hname in enumerate(sim._pd_names):
            for c, cname in enumerate(self.names):
                self.reach[hh, c] = sim._match_eligible(hname, cname)
        self.cache = _VecCache(C, self.n_sess, sim.sim.pool_blocks,
                               sim.sim.block_tokens)
        self._build_links()
        self.warm_t = self.T * sim.sim.warmup_frac
        self.warm_ep = self._ep(self.warm_t) if self.warm_t > 0 else -1
        # pools: index 0 = PrfaaS hub, 1+h = regional PD-P
        self.pools = [_VecPool(sim.system.n_prfaas, n_homes=self.k)]
        for name, (n_p_c, _) in zip(sim._pd_names, sim._per_cluster):
            self.pools.append(_VecPool(n_p_c, n_homes=self.k))
        self.dec_pools = [
            _VecPool(n_d_c * sim.w.bs_max)
            for (_, n_d_c) in sim._per_cluster]
        self.decode_time = sim._decode_service_time()
        block_s = sim._block_s
        ctrl_dt = sim.sim.control_dt
        next_ctrl = ctrl_dt if ctrl_dt > 0 else math.inf
        ptr = 0
        for e in range(self.n_ep):
            t1 = float(self.edges[e + 1])
            self._apply_inserts(e)
            hi = int(np.searchsorted(self.arrival, t1, side="left")) \
                if e < self.n_ep - 1 else N
            if hi > ptr:
                self._route_batch(np.arange(ptr, hi, dtype=np.int64), e)
                ptr = hi
            until = math.inf if self.eager else t1
            for c in range(C):
                out = self.pools[c].process(until)
                self._handle_starts(out[0], out[1], out[2], e)
            self._links_epoch(e)
            if not self.eager:
                batch = self.ready_q.pop(e, None)
                if batch:
                    rt = np.concatenate([b[0] for b in batch])
                    ri = np.concatenate([b[1] for b in batch])
                    order = np.argsort(rt, kind="stable")
                    rt, ri = rt[order], ri[order]
                    if block_s > 0:
                        rt = np.ceil((rt - 1e-9) / block_s) * block_s
                    for hh in range(self.k):
                        m = self.home[ri] == hh
                        if m.any():
                            self.dec_pools[hh].extend(
                                rt[m], np.full(int(m.sum()),
                                               self.decode_time),
                                ri[m], np.zeros(int(m.sum()), np.int64))
                for hh in range(self.k):
                    out = self.dec_pools[hh].process(t1)
                    if len(out[0]):
                        self.dec_start[out[0]] = out[1]
            if t1 + 1e-9 >= next_ctrl:
                self._control(t1)
                while next_ctrl <= t1 + 1e-9:
                    next_ctrl += ctrl_dt
        # drain remaining scheduled inserts from the final epoch (cache
        # telemetry parity; routing is over so hit stats are unaffected)
        for e in sorted(self.insert_q):
            self._apply_inserts(e)
        if self.eager:
            self._decode_post_pass(block_s)
        return self._metrics()

    def _decode_post_pass(self, block_s: float):
        """Exact FIFO-c decode solve per home: legal because decode feeds
        back into nothing when autoscaling is off (queue depth is telemetry
        only)."""
        sim = self.sim
        self.dec_queue_end = [0] * self.k
        for hh in range(self.k):
            m = (self.home == hh) & np.isfinite(self.ready_t) \
                & (self.ready_t <= self.T + 1e-9)
            idx = np.where(m)[0]
            if len(idx) == 0:
                continue
            r = self.ready_t[idx]
            order = np.argsort(r, kind="stable")
            idx, r = idx[order], r[order]
            if block_s > 0:
                r = np.ceil((r - 1e-9) / block_s) * block_s
            cap = self.dec_pools[hh].capacity
            start = _fifo_lanes(r, cap, self.decode_time)
            ok = start <= self.T + 1e-9
            self.dec_start[idx[ok]] = start[ok]
            self.dec_queue_end[hh] = int((~ok).sum())

    # -------------------------------------------------------------- metrics
    def _metrics(self) -> dict:
        sim = self.sim
        cfg = sim.sim
        horizon = self.T
        t0 = horizon * cfg.warmup_frac
        window = max(1e-9, horizon - t0)
        started = self.dec_start >= 0
        done_t = np.where(started, self.dec_start + self.decode_time, -1.0)
        first = np.where(started, self.dec_start + sim.w.t_decode, -1.0)
        done = started & (done_t <= horizon) & (self.arrival >= t0)
        ttft = (first - self.arrival)[done & (first > 0)]
        tbt = (done_t - first)[done & (first > 0)] \
            / max(1, sim.w.output_len - 1)
        routed = int((self.target >= 0).sum())
        offload = int((self.target == 0).sum())
        slo = getattr(cfg, "ttft_slo_s", 0.0)

        def _pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        def _slo_stats(tt):
            if slo <= 0:
                return 1.0, len(tt) / window
            good = int((tt <= slo).sum())
            return (good / len(tt) if len(tt) else float("nan"),
                    good / window)

        att, goodput = _slo_stats(ttft)
        if self.eager:
            dec_q = sum(getattr(self, "dec_queue_end", [0] * self.k))
        else:
            dec_q = sum(p.pending() for p in self.dec_pools)
        if self.eager:
            # queued-at-end == jobs whose exact start lies beyond horizon
            pf_q = int(((self.pf_start > self.T + 1e-9)
                        & (self.target >= 0)).sum())
            pf_q += sum(p.pending() for p in self.pools)
        else:
            pf_q = sum(p.pending() for p in self.pools)
        per_cluster = {}
        for hh, name in enumerate(sim._pd_names):
            cm = done & (self.home == hh)
            ct = (first - self.arrival)[cm & (first > 0)]
            c_att, c_good = _slo_stats(ct)
            cached, total = sim._route_tokens[name]
            if self.eager:
                c_pf = int(((self.pf_start > self.T + 1e-9)
                            & (self.target == 1 + hh)).sum()) \
                    + self.pools[1 + hh].pending()
                c_dec = getattr(self, "dec_queue_end", [0] * self.k)[hh]
            else:
                c_pf = self.pools[1 + hh].pending()
                c_dec = self.dec_pools[hh].pending()
            per_cluster[name] = {
                "completed": int(cm.sum()),
                "throughput_rps": int(cm.sum()) / window,
                "ttft_mean": float(ct.mean()) if len(ct) else float("nan"),
                "ttft_p90": _pct(ct, 90),
                "ttft_p99": _pct(ct, 99),
                "slo_attainment": c_att,
                "goodput_rps": c_good,
                "prefill_queue": c_pf,
                "decode_queue": c_dec,
                "threshold": sim.router.threshold_for(name),
                "cache_hit_frac": cached / total if total else 0.0,
                "conversions": len(sim.autoscalers[name].conversions)
                if name in sim.autoscalers else 0,
            }
        thresholds = {name: sim.router.threshold_for(name)
                      for name in sim._pd_names}
        sent_total = sum(L.S for L in self.links)
        egress0 = sum(L.sent_at_warmup for L in self.links) \
            if self.warm_ep >= 0 else 0.0
        links = {}
        for (a, b), L in zip(self.link_keys, self.links):
            links[f"{a}|{b}"] = {
                "sent_bytes": L.S, "capacity_gbps": L.capacity_bps / 1e9,
                "util_ewma": L.util_ewma, "busy_time": L.busy_time,
                "drops_total": L.drops_total, "drops": L.drops_w,
                "inflight": L.act}
        self._stamp_requests(first, done_t)
        return {
            "throughput_rps": int(done.sum()) / window,
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
            "tbt_slo_s": getattr(cfg, "tbt_slo_s", 0.0),
            "tbt_attainment": (
                float((tbt <= cfg.tbt_slo_s).mean())
                if getattr(cfg, "tbt_slo_s", 0.0) > 0 and len(tbt) else 1.0),
            "completed": int(done.sum()),
            "offload_frac": offload / max(1, routed),
            "egress_gbps": (sent_total - egress0) * 8 / 1e9 / window,
            "link_util": max(L.util_ewma for L in self.links),
            "router_adjustments": sim.router.adjustments,
            "prefill_queue": pf_q,
            "decode_queue": dec_q,
            "cache": self.cache.stats(self.names),
            "threshold": max(thresholds.values()),
            "thresholds": thresholds,
            "session_evictions": sim.session_evictions,
            "open_sessions": len(sim._open_sessions),
            "clusters": per_cluster,
            "links": links,
            "engine": "vector",
            "n_requests": self.N,
        }

    def _stamp_requests(self, first, done_t):
        """Write results back into the Request objects when the trace came
        from the object path (tests / small runs introspect them); the SoA
        path skips this entirely."""
        if self.reqs is None or len(self.reqs) > 200_000:
            return
        from repro_torch.core.router import RoutingDecision
        for i, r in enumerate(self.reqs):
            if self.target[i] >= 0:
                tname = self.names[self.target[i]]
                r.decision = RoutingDecision(
                    target=tname, cached_tokens=int(self.cached[i]),
                    incremental=max(0, int(self.total[i] - self.cached[i])),
                    cache_cluster=self.names[self.cache_cl[i]]
                    if self.cache_cl[i] >= 0 else tname,
                    cross_cache_transfer=bool(self.cross[i]),
                    home=sim_name(self.sim, int(self.home[i])))
            r.prefill_start = float(self.pf_start[i])
            r.prefill_done = float(self.pf_done[i])
            r.transfer_done = float(self.tr_done[i])
            if self.dec_start[i] >= 0:
                r.decode_start = float(self.dec_start[i])
                r.first_token = float(first[i])
                r.done = float(done_t[i])


def sim_name(sim, h: int) -> str:
    return sim._pd_names[h]


def run_vector(sim) -> dict:
    """Entry point: run ``sim`` through the vectorized engine."""
    eng = _VectorEngine(sim)
    sim._vector_state = eng                  # introspection for tests
    return eng.run()
