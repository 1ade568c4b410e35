"""Workload model: truncated log-normal request lengths (paper §4.1) plus
the trace-driven workload layer for the vectorized simulator.

All conditional moments needed by the throughput model — p(t) = P(L > t),
l_long(t) = E[L | L > t], l_short(t) = E[L | L <= t] — are computed in closed
form from the truncated log-normal (no scipy; erf from math).

Traces (``Trace``) are structure-of-arrays arrival schedules — (arrival_s,
total_len, session, home) columns — replayable through either simulator
engine: ``PrfaasSimulator.inject_trace(trace.to_entries())`` for the exact
event engine, or directly (no per-request Python objects) for
``SimConfig(engine="vector")``.  ``Trace.save``/``Trace.load`` round-trip
through ``.npz`` with a JSON metadata blob, so recorded production traces
and generated scenario traces share one format.  Three generator families
cover the production shapes the paper's claims are about:

  * ``diurnal_trace``       — nonhomogeneous Poisson with a sinusoidal
                              day/night cycle, phase-shifted per region by
                              its time-zone offset (peaks do not align);
  * ``flash_crowd_trace``   — baseline Poisson plus exponentially decaying
                              rate spikes at flash onset times;
  * ``conversation_trace``  — multi-turn conversation trees: session starts
                              from any arrival process, geometric turn
                              counts, exponential think-time gaps between
                              turns, per-turn context growth (the agentic
                              prefix-cache workload), optional roaming.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np


def _phi(z: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def mmpp_rate(base_rate: float, burst_factor: float, period_s: float,
              t: float) -> float:
    """Square-wave 2-state MMPP modulation of a Poisson rate, preserving the
    mean rate for ANY burst_factor bf >= 1:

      * bf <= 2: 50% duty cycle with phase rates (bf, 2-bf) x base
        -> mean = (bf + (2-bf))/2 = 1 x base
      * bf  > 2: the low phase would go negative, so instead the duty cycle
        shrinks to 1/bf with a silent low phase
        -> mean = (1/bf)*bf + (1-1/bf)*0 = 1 x base

    (The seed clamped the low phase at max(0, 2-bf) with a fixed 50% duty,
    which inflated the offered load to bf/2 x base for bf > 2.)
    """
    bf = burst_factor
    if bf <= 1.0 or period_s <= 0.0:
        return base_rate
    if bf <= 2.0:
        duty, low = 0.5, 2.0 - bf
    else:
        duty, low = 1.0 / bf, 0.0
    phase_high = (t % period_s) < duty * period_s
    return base_rate * (bf if phase_high else low)


@dataclass(frozen=True)
class LogNormalLengths:
    mu: float = 9.90
    sigma: float = 1.00
    lo: float = 128.0
    hi: float = 131072.0

    # -- closed-form moments -------------------------------------------------
    def _z(self, x: float) -> float:
        return (math.log(x) - self.mu) / self.sigma

    @property
    def _norm(self) -> float:
        return _phi(self._z(self.hi)) - _phi(self._z(self.lo))

    def p_gt(self, t: float) -> float:
        """P(L > t) under truncation."""
        t = min(max(t, self.lo), self.hi)
        return (_phi(self._z(self.hi)) - _phi(self._z(t))) / self._norm

    def _partial_mean(self, a: float, b: float) -> float:
        """E[L ; a < L <= b] (unnormalized partial expectation)."""
        m = math.exp(self.mu + 0.5 * self.sigma ** 2)
        return m * (_phi(self._z(b) - self.sigma)
                    - _phi(self._z(a) - self.sigma)) / self._norm

    def mean(self) -> float:
        return self._partial_mean(self.lo, self.hi)

    def mean_above(self, t: float) -> float:
        """E[L | L > t]."""
        t = min(max(t, self.lo), self.hi)
        p = self.p_gt(t)
        if p <= 0:
            return self.hi
        return self._partial_mean(t, self.hi) / p

    def mean_below(self, t: float) -> float:
        """E[L | L <= t]."""
        t = min(max(t, self.lo), self.hi)
        p = 1.0 - self.p_gt(t)
        if p <= 0:
            return self.lo
        return self._partial_mean(self.lo, t) / p

    # -- sampling ------------------------------------------------------------
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """True truncation (rejection), matching the analytic moments —
        clipping would put a point mass at the bounds."""
        out = np.empty(n, np.float64)
        filled = 0
        while filled < n:
            x = rng.lognormal(self.mu, self.sigma, size=max(n - filled, 64))
            x = x[(x >= self.lo) & (x <= self.hi)]
            take = min(len(x), n - filled)
            out[filled:filled + take] = x[:take]
            filled += take
        return out.astype(np.int64)


@dataclass(frozen=True)
class Workload:
    """Full serving workload (paper §4.1 defaults)."""

    lengths: LogNormalLengths = LogNormalLengths()
    output_len: int = 1024
    decode_tps_slo: float = 40.0          # tokens/s per stream (SLO)
    bs_max: int = 20                      # decode slots per instance
    # request arrival burstiness (MMPP 2-state modulation of Poisson rate)
    burst_factor: float = 1.0             # 1.0 = plain Poisson
    burst_period_s: float = 60.0
    # prefix caching behaviour (agentic multi-turn sessions)
    session_prob: float = 0.0             # P(request continues a session)
    session_growth: float = 4096.0        # mean new tokens per turn

    @property
    def t_decode(self) -> float:
        return 1.0 / self.decode_tps_slo


# ---------------------------------------------------------------------------
# trace-driven workload layer
# ---------------------------------------------------------------------------
@dataclass
class Trace:
    """Structure-of-arrays arrival trace (sorted by arrival time).

    Columns: ``arrival`` (float64 seconds), ``total_len`` (int64 tokens),
    ``session`` (int64, dense ids from 0), ``home`` (int32 index into
    ``home_names``).  ``meta`` carries generator provenance (family,
    parameters, seed) for the scenario engine's artifacts.
    """

    arrival: np.ndarray
    total_len: np.ndarray
    session: np.ndarray
    home: np.ndarray
    home_names: Tuple[str, ...] = ("pd",)
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.arrival = np.asarray(self.arrival, np.float64)
        self.total_len = np.asarray(self.total_len, np.int64)
        self.session = np.asarray(self.session, np.int64)
        self.home = np.asarray(self.home, np.int32)
        n = len(self.arrival)
        if not (len(self.total_len) == len(self.session)
                == len(self.home) == n):
            raise ValueError("trace columns must have equal length")
        if n and np.any(np.diff(self.arrival) < 0):
            raise ValueError("trace must be sorted by arrival time")
        if n and (self.home.min() < 0
                  or self.home.max() >= len(self.home_names)):
            raise ValueError("home index out of range of home_names")

    def __len__(self) -> int:
        return len(self.arrival)

    @property
    def n_sessions(self) -> int:
        return int(self.session.max()) + 1 if len(self) else 0

    def to_entries(self):
        """(arrival, total_len, session, home_name) tuples for
        ``PrfaasSimulator.inject_trace`` — the event-engine replay path."""
        names = self.home_names
        return [(float(a), int(l), int(s), names[h])
                for a, l, s, h in zip(self.arrival, self.total_len,
                                      self.session, self.home)]

    # ------------------------------------------------------------------ io
    def save(self, path: str):
        """Write the ``.npz`` trace file (columns + JSON meta blob)."""
        np.savez_compressed(
            path, arrival=self.arrival, total_len=self.total_len,
            session=self.session, home=self.home,
            meta=np.frombuffer(json.dumps(
                {"home_names": list(self.home_names), **self.meta}
            ).encode(), dtype=np.uint8))

    @classmethod
    def load(cls, path: str) -> "Trace":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            names = tuple(meta.pop("home_names"))
            return cls(z["arrival"], z["total_len"], z["session"], z["home"],
                       home_names=names, meta=meta)


def _thin_poisson(rate_grid: np.ndarray, grid_dt: float, sim_time: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Nonhomogeneous Poisson arrival times on [0, sim_time) by thinning a
    piecewise-constant rate (vectorized: exponential gaps + cumsum, then one
    acceptance pass — no per-arrival Python loop)."""
    lam_max = float(rate_grid.max(initial=0.0))
    if lam_max <= 0.0 or sim_time <= 0.0:
        return np.empty(0, np.float64)
    out = []
    t0 = 0.0
    # draw in chunks until the candidate stream crosses the horizon
    chunk = max(1024, int(lam_max * sim_time * 1.2))
    while t0 < sim_time:
        gaps = rng.exponential(1.0 / lam_max, size=chunk)
        t = t0 + np.cumsum(gaps)
        u = rng.random(chunk)
        keep = t < sim_time
        lam = rate_grid[np.minimum((t[keep] / grid_dt).astype(np.int64),
                                   len(rate_grid) - 1)]
        out.append(t[keep][u[keep] * lam_max < lam])
        if not keep.all():
            break
        t0 = float(t[-1])
        chunk = max(1024, chunk // 4)
    return np.concatenate(out) if out else np.empty(0, np.float64)


def _sample_homes(n: int, shares: Optional[Sequence[float]], k: int,
                  rng: np.random.Generator) -> np.ndarray:
    if k == 1:
        return np.zeros(n, np.int32)
    p = (np.full(k, 1.0 / k) if shares is None
         else np.asarray(shares, np.float64) / np.sum(shares))
    return rng.choice(k, size=n, p=p).astype(np.int32)


def diurnal_trace(mean_rate: float, sim_time: float, seed: int = 0,
                  home_names: Sequence[str] = ("pd",),
                  shares: Optional[Sequence[float]] = None,
                  tz_offsets_s: Optional[Sequence[float]] = None,
                  day_s: float = 86_400.0, depth: float = 0.6,
                  lengths: LogNormalLengths = LogNormalLengths(),
                  grid_dt: float = 10.0) -> Trace:
    """Diurnal cycle with regional time-zone offsets: each region r draws a
    nonhomogeneous Poisson stream at

        lam_r(t) = mean_rate * share_r * (1 + depth * sin(2pi (t+tz_r)/day))

    so regional peaks are phase-shifted (the paper's cross-datacenter
    premise: one region's off-peak prefill capacity can serve another's
    peak).  Every request is its own single-turn session; compose with
    ``conversation_trace`` for multi-turn sessions."""
    k = len(home_names)
    shares_v = ([1.0 / k] * k if shares is None
                else [s / sum(shares) for s in shares])
    tz = list(tz_offsets_s) if tz_offsets_s is not None else [0.0] * k
    if len(tz) != k or len(shares_v) != k:
        raise ValueError("shares/tz_offsets_s must match home_names")
    rng = np.random.default_rng(seed)
    grid_t = np.arange(0.0, sim_time + grid_dt, grid_dt)
    per_region = []
    for r in range(k):
        rate = mean_rate * shares_v[r] * (
            1.0 + depth * np.sin(2.0 * np.pi * (grid_t + tz[r]) / day_s))
        times = _thin_poisson(np.maximum(rate, 0.0), grid_dt, sim_time, rng)
        per_region.append((times, np.full(len(times), r, np.int32)))
    arrival = np.concatenate([t for t, _ in per_region])
    home = np.concatenate([h for _, h in per_region])
    order = np.argsort(arrival, kind="stable")
    arrival, home = arrival[order], home[order]
    n = len(arrival)
    return Trace(arrival, lengths.sample(rng, n), np.arange(n, dtype=np.int64),
                 home, tuple(home_names),
                 meta={"family": "diurnal", "mean_rate": mean_rate,
                       "sim_time": sim_time, "seed": seed, "depth": depth,
                       "day_s": day_s, "tz_offsets_s": tz})


def flash_crowd_trace(base_rate: float, sim_time: float, seed: int = 0,
                      home_names: Sequence[str] = ("pd",),
                      shares: Optional[Sequence[float]] = None,
                      flash_times: Optional[Sequence[float]] = None,
                      flash_amp: float = 4.0, flash_decay_s: float = 60.0,
                      lengths: LogNormalLengths = LogNormalLengths(),
                      grid_dt: float = 1.0) -> Trace:
    """Baseline Poisson plus flash crowds: at each onset time the global
    rate jumps by ``flash_amp x base_rate`` and decays exponentially
    (``flash_decay_s``) — the viral-moment / breaking-news shape that
    stresses admission and the short-term routing loop."""
    rng = np.random.default_rng(seed)
    if flash_times is None:
        # a couple of onsets per run by default, clear of the warmup edge
        n_flash = max(1, int(sim_time / 600.0))
        flash_times = np.sort(rng.uniform(0.2 * sim_time, 0.9 * sim_time,
                                          size=n_flash))
    grid_t = np.arange(0.0, sim_time + grid_dt, grid_dt)
    rate = np.full_like(grid_t, base_rate)
    for tf in np.asarray(flash_times, np.float64):
        dt = grid_t - tf
        rate += np.where(dt >= 0.0,
                         base_rate * flash_amp * np.exp(-dt / flash_decay_s),
                         0.0)
    arrival = _thin_poisson(rate, grid_dt, sim_time, rng)
    n = len(arrival)
    return Trace(arrival, lengths.sample(rng, n), np.arange(n, dtype=np.int64),
                 _sample_homes(n, shares, len(home_names), rng),
                 tuple(home_names),
                 meta={"family": "flash_crowd", "base_rate": base_rate,
                       "sim_time": sim_time, "seed": seed,
                       "flash_times": [float(t) for t in flash_times],
                       "flash_amp": flash_amp,
                       "flash_decay_s": flash_decay_s})


def conversation_trace(session_starts: np.ndarray, sim_time: float,
                       seed: int = 0,
                       home_names: Sequence[str] = ("pd",),
                       shares: Optional[Sequence[float]] = None,
                       turns_mean: float = 4.0,
                       think_mean_s: float = 30.0,
                       growth_mean: float = 4096.0,
                       roam_prob: float = 0.0,
                       lengths: LogNormalLengths = LogNormalLengths()
                       ) -> Trace:
    """Multi-turn conversation trees with think-time gaps: each session
    start spawns a geometric number of turns (mean ``turns_mean``); turn
    j+1 arrives an Exp(``think_mean_s``) gap after turn j and grows the
    context by Exp(``growth_mean``)+1 tokens (capped at ``lengths.hi``),
    reusing the session's cached prefix — the workload where prefix-cache
    dynamics dominate.  ``roam_prob`` re-homes individual turns (session
    roaming: the cached prefix stays behind, forcing cross-region copies).

    ``session_starts`` is any sorted arrival-time array — e.g.
    ``diurnal_trace(...).arrival`` to put conversation trees on a diurnal
    cycle."""
    starts = np.asarray(session_starts, np.float64)
    n_sess = len(starts)
    rng = np.random.default_rng(seed)
    if n_sess == 0:
        return Trace(np.empty(0), np.empty(0, np.int64),
                     np.empty(0, np.int64), np.empty(0, np.int32),
                     tuple(home_names), meta={"family": "conversation"})
    turns = rng.geometric(min(1.0, 1.0 / max(turns_mean, 1.0)), size=n_sess)
    total = int(turns.sum())
    sess = np.repeat(np.arange(n_sess, dtype=np.int64), turns)
    # segmented cumsum helper: within-session running sums over flat draws
    offsets = np.concatenate(([0], np.cumsum(turns)[:-1]))

    def _seg_cumsum(flat: np.ndarray) -> np.ndarray:
        cs = np.cumsum(flat)
        base = np.repeat(cs[offsets] - flat[offsets], turns)
        return cs - base

    # think-time gaps (turn 0 gap = 0: it IS the session start)
    gaps = rng.exponential(think_mean_s, size=total)
    gaps[offsets] = 0.0
    arrival = np.repeat(starts, turns) + _seg_cumsum(gaps)
    # context growth per turn on top of the first-turn length
    first_len = lengths.sample(rng, n_sess).astype(np.float64)
    grow = rng.exponential(growth_mean, size=total) + 1.0
    grow[offsets] = 0.0
    total_len = np.minimum(np.repeat(first_len, turns) + _seg_cumsum(grow),
                           lengths.hi).astype(np.int64)
    # homes: per session, with optional per-turn roaming
    k = len(home_names)
    home = np.repeat(_sample_homes(n_sess, shares, k, rng), turns)
    if roam_prob > 0.0 and k > 1:
        roam = rng.random(total) < roam_prob
        roam[offsets] = False
        idx = np.flatnonzero(roam)
        if len(idx):
            # redraw uniformly over the OTHER regions
            shift = rng.integers(1, k, size=len(idx)).astype(np.int32)
            home[idx] = (home[idx] + shift) % k
    keep = arrival < sim_time
    order = np.argsort(arrival[keep], kind="stable")
    return Trace(arrival[keep][order], total_len[keep][order],
                 sess[keep][order], home[keep][order], tuple(home_names),
                 meta={"family": "conversation", "sim_time": sim_time,
                       "seed": seed, "turns_mean": turns_mean,
                       "think_mean_s": think_mean_s,
                       "growth_mean": growth_mean, "roam_prob": roam_prob})
