"""The paper's analytical throughput model (§3.4, Eqs. 1-8) + grid search.

Roles: PrfaaS prefill (N_prfaas instances), PD-P (N_p), PD-D (N_d).
A fraction p = P(L > t) of requests offload to PrfaaS; Eq. 6 gives

    Lambda_max = min(Theta_prfaas / p, Theta_pdp / (1-p), Theta_pdd)

with Theta_prfaas bandwidth-clipped by B_out (Eq. 3). ``grid_search``
solves the two decision variables (t, N_p/N_d) exactly as §3.4.2/§4.2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.hardware import Profile
from repro_torch.core.workload import Workload


def kv_throughput(profile: Profile, l: float) -> float:
    """Eq. 1: Φ_kv(l) = S_kv(l) / T_prefill(l), bytes/s."""
    return profile.s_kv(int(l)) / profile.t_prefill(int(l))


def egress_bandwidth(n_gpus: int, gpus_per_instance: int, profile: Profile,
                     l_avg: float) -> float:
    """Eq. 2: minimum egress bandwidth of an N-GPU prefill cluster, bytes/s."""
    return (n_gpus / gpus_per_instance) * kv_throughput(profile, l_avg)


@dataclass(frozen=True)
class SystemConfig:
    n_prfaas: int                 # PrfaaS prefill instances
    n_p: int                      # PD prefill instances (total over clusters)
    n_d: int                      # PD decode instances (total over clusters)
    b_out: float                  # PrfaaS egress bandwidth (bytes/s)
    threshold: float              # routing threshold t (tokens); inf => no offload
    # beyond-paper: int8 KV quantization on the inter-DC wire (KIVI/CacheGen
    # family, paper §5) — divides S_kv on the link, raising the bandwidth-
    # bound Θ_prfaas ceiling. NOT a free parameter: set it to the MEASURED
    # quantized/raw byte ratio of a real prefill cache
    # (``models.kvcache.wire_compression_ratio`` /
    # ``CrossDCDeployment.measured_compression``). 1.0 = off
    # (paper-faithful); the simulator charges the same ratio per flow.
    kv_wire_compression: float = 1.0
    # multi-cluster deployments: per-PD-cluster instance counts (must sum to
    # n_p / n_d).  None = one PD cluster holding everything (paper baseline).
    n_p_clusters: Optional[tuple] = None
    n_d_clusters: Optional[tuple] = None

    def __post_init__(self):
        for name, per, total in (("n_p_clusters", self.n_p_clusters, self.n_p),
                                 ("n_d_clusters", self.n_d_clusters, self.n_d)):
            if per is not None and sum(per) != total:
                raise ValueError(f"{name} {per} must sum to {total}")
        if (self.n_p_clusters is None) != (self.n_d_clusters is None):
            raise ValueError("set both n_p_clusters and n_d_clusters or neither")
        if (self.n_p_clusters is not None
                and len(self.n_p_clusters) != len(self.n_d_clusters)):
            raise ValueError("per-cluster tuples must have equal length")

    @property
    def num_pd_clusters(self) -> int:
        return len(self.n_p_clusters) if self.n_p_clusters is not None else 1

    def per_cluster(self, k: Optional[int] = None):
        """(n_p, n_d) per PD cluster.  Without explicit tuples the totals are
        split evenly over ``k`` clusters, remainder to earlier ones."""
        if self.n_p_clusters is not None:
            return list(zip(self.n_p_clusters, self.n_d_clusters))
        k = 1 if k is None else k
        return list(zip(split_even(self.n_p, k), split_even(self.n_d, k)))


def split_even(total: int, k: int):
    """Deterministic even split of ``total`` over ``k`` buckets."""
    base, rem = divmod(total, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


@dataclass
class ThroughputModel:
    prfaas_profile: Optional[Profile]   # None => no PrfaaS cluster
    pd_profile: Profile
    workload: Workload

    # -- stage throughputs (req/s) ------------------------------------------
    def theta_prfaas(self, sc: SystemConfig) -> float:
        """Eq. 3: min(compute rate, egress rate) with layer-wise pipelining."""
        if sc.n_prfaas == 0 or self.prfaas_profile is None:
            return 0.0
        if self.workload.lengths.p_gt(sc.threshold) <= 0.0:
            return math.inf
        l_long = self.workload.lengths.mean_above(sc.threshold)
        compute = sc.n_prfaas / self.prfaas_profile.t_prefill(int(l_long))
        wire_bytes = self.prfaas_profile.s_kv(int(l_long)) \
            / max(sc.kv_wire_compression, 1e-9)
        egress = sc.b_out / wire_bytes
        return min(compute, egress)

    def theta_pdp(self, sc: SystemConfig) -> float:
        """Eq. 4 (RDMA intra-cluster: compute bound only)."""
        if sc.n_p == 0:
            return 0.0
        frac_long = self.workload.lengths.p_gt(sc.threshold)
        if sc.n_prfaas == 0 or frac_long >= 1.0:
            l_short = self.workload.lengths.mean()
        elif frac_long <= 0.0:
            l_short = self.workload.lengths.mean()
        else:
            l_short = self.workload.lengths.mean_below(sc.threshold)
        return sc.n_p / self.pd_profile.t_prefill(int(l_short))

    def theta_pdd(self, sc: SystemConfig) -> float:
        """Eq. 5: N_d * BS_max / (T_decode * L_out)."""
        w = self.workload
        return sc.n_d * w.bs_max / (w.t_decode * w.output_len)

    # -- Eq. 6 ----------------------------------------------------------------
    def lambda_max(self, sc: SystemConfig,
                   pd_shares: Optional[list] = None,
                   thresholds: Optional[list] = None) -> float:
        """Eq. 6, generalized to per-PD-cluster instance counts: with
        regional traffic shares s_c, cluster c must sustain s_c of the
        global rate with its own N_p,c / N_d,c, so each per-cluster stage
        throughput is divided by its share.  The single-cluster case
        (``n_p_clusters is None``) is the paper's original min().

        ``thresholds`` (per-region, multi-cluster only) models the
        regionalized short-term loop: region c offloads with its OWN
        t_c, so p_c = P(L > t_c) and the PrfaaS cluster serves the traffic
        mixture — compute constraint sum_c s_c p_c T_prefill(l_long,c)
        <= N_prfaas / Lambda, egress constraint sum_c s_c p_c S_kv(l_long,c)
        <= B_out / Lambda — while each region's PD-P stage is evaluated at
        its own conditional short-length mean.  ``thresholds=None`` uses
        ``sc.threshold`` everywhere (identical to the uniform case).

        (A request short-circuits to 0 via theta_pdp == 0 when n_p == 0 and
        p < 1 — the old explicit ``return 0.0`` branch was unreachable.)"""
        terms = []
        if sc.n_p_clusters is None:
            if thresholds is not None:
                raise ValueError("per-region thresholds require per-cluster "
                                 "instance counts (n_p_clusters)")
            p = self.workload.lengths.p_gt(sc.threshold) if sc.n_prfaas \
                else 0.0
            if p > 0:
                terms.append(self.theta_prfaas(sc) / p)
            terms.append(self.theta_pdd(sc))
            if p < 1:
                terms.append(self.theta_pdp(sc) / (1.0 - p))
            return min(terms)
        k = sc.num_pd_clusters
        if pd_shares is None:
            shares = [1.0 / k] * k
        else:
            if len(pd_shares) != k or min(pd_shares) < 0 \
                    or sum(pd_shares) <= 0:
                raise ValueError(f"pd_shares {pd_shares} invalid for "
                                 f"{k} PD clusters")
            shares = [s / sum(pd_shares) for s in pd_shares]
        if thresholds is None:
            ts = [sc.threshold] * k
        else:
            if len(thresholds) != k:
                raise ValueError(f"thresholds {thresholds} invalid for "
                                 f"{k} PD clusters")
            ts = list(thresholds)
        lengths = self.workload.lengths
        # PrfaaS serves the cross-region mixture of long requests: one
        # aggregate compute and one aggregate egress constraint.
        if sc.n_prfaas:
            time_per_req = 0.0      # E[s_c p_c T_prefill(l_long,c)]
            bytes_per_req = 0.0     # E[s_c p_c S_kv(l_long,c)] on the wire
            for s, t in zip(shares, ts):
                p_c = lengths.p_gt(t)
                if s <= 0 or p_c <= 0:
                    continue
                if self.prfaas_profile is None:
                    # offloading configured with no PrfaaS profile: the
                    # offloaded fraction has nowhere to run (theta == 0)
                    return 0.0
                l_long = int(lengths.mean_above(t))
                time_per_req += s * p_c * self.prfaas_profile.t_prefill(l_long)
                bytes_per_req += s * p_c * self.prfaas_profile.s_kv(l_long) \
                    / max(sc.kv_wire_compression, 1e-9)
            if time_per_req > 0:
                terms.append(sc.n_prfaas / time_per_req)
                terms.append(sc.b_out / bytes_per_req)
        pdd_unit = self.theta_pdd(
            SystemConfig(sc.n_prfaas, 1, 1, sc.b_out, sc.threshold))
        for (n_p_c, n_d_c), s, t in zip(sc.per_cluster(), shares, ts):
            if s <= 0:
                continue
            terms.append(n_d_c * pdd_unit / s)
            p_c = lengths.p_gt(t) if sc.n_prfaas else 0.0
            if p_c < 1:
                l_short = lengths.mean() if sc.n_prfaas == 0 \
                    else lengths.mean_below(t)
                pdp_c = n_p_c / self.pd_profile.t_prefill(int(l_short))
                terms.append(pdp_c / ((1.0 - p_c) * s))
        return min(terms)

    def egress_load(self, sc: SystemConfig, rate: Optional[float] = None) -> float:
        """Average egress bytes/s at offered rate (default: Λ_max)."""
        if sc.n_prfaas == 0:
            return 0.0
        rate = self.lambda_max(sc) if rate is None else rate
        p = self.workload.lengths.p_gt(sc.threshold)
        l_long = self.workload.lengths.mean_above(sc.threshold)
        return rate * p * self.prfaas_profile.s_kv(int(l_long)) \
            / max(sc.kv_wire_compression, 1e-9)

    # -- §3.4.2: grid search over (t, N_p/N_d) --------------------------------
    def grid_search(self, n_prfaas: int, n_pd_total: int, b_out: float,
                    thresholds=None, kv_wire_compression: float = 1.0):
        """Exhaustive 2-D search maximizing Λ_max (paper Fig. 5).

        Returns (best SystemConfig, Λ_max, search trace).
        """
        lo = math.log(max(self.workload.lengths.lo, 256))
        hi = math.log(self.workload.lengths.hi)
        if thresholds is None:
            thresholds = [math.exp(lo + (hi - lo) * i / 400)
                          for i in range(401)]
        if n_prfaas == 0:
            thresholds = [math.inf]
        # The per-threshold workload moments (p_gt, conditional means, and
        # the resulting per-instance stage rates) are independent of the
        # N_p/N_d split, so hoist them out of the inner loop: O(T + T*N)
        # cheap arithmetic instead of O(T*N) erf/interp evaluations.
        decode_unit = self.theta_pdd(
            SystemConfig(n_prfaas, 0, 1, b_out, 0.0))
        per_t = []
        for t in thresholds:
            sc1 = SystemConfig(n_prfaas, 1, 1, b_out, t,
                               kv_wire_compression=kv_wire_compression)
            p = self.workload.lengths.p_gt(t) if n_prfaas else 0.0
            per_t.append((t, p, self.theta_prfaas(sc1),
                          self.theta_pdp(sc1)))
        best, best_rate, trace = None, -1.0, []
        for n_p in range(0 if n_prfaas else 1, n_pd_total):
            n_d = n_pd_total - n_p
            th_pdd = n_d * decode_unit
            for t, p, th_prfaas, th_pdp_unit in per_t:
                rate = th_pdd
                if p > 0:
                    rate = min(rate, th_prfaas / p)
                if p < 1:
                    rate = min(rate, n_p * th_pdp_unit / (1.0 - p))
                trace.append((n_p, n_d, t, rate))
                if rate > best_rate:
                    best_rate = rate
                    best = SystemConfig(
                        n_prfaas, n_p, n_d, b_out, t,
                        kv_wire_compression=kv_wire_compression)
        return best, best_rate, trace

    # -- §3.4.2 optimality residuals (Eqs. 7-8), for tests/analysis ----------
    def balance_residuals(self, sc: SystemConfig):
        p = self.workload.lengths.p_gt(sc.threshold)
        eq7 = None
        if 0 < p < 1:
            eq7 = (self.theta_prfaas(sc) / p) - (self.theta_pdp(sc) / (1 - p))
        eq8 = (self.theta_prfaas(sc) + self.theta_pdp(sc)) - self.theta_pdd(sc)
        return eq7, eq8
