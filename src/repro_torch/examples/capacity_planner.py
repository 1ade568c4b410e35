"""Capacity planner on the port: the paper's throughput model and
simulator size a PrfaaS-PD deployment for a given traffic, the operator's
workflow of the paper's §3.4/§4.

A copy of the reference's ``examples/capacity_planner.py`` through the
port's ``core`` (host only, no device): sweeps the PrfaaS cluster size and
link bandwidth (achievable req/s, optimal threshold, egress), validates
the best point under bursty traffic with the discrete-event simulator,
splits the PD fleet into three regions over the multi-cluster
``LinkTopology`` with the regionalized control plane on, and reads the
repo's ``BENCH_scenario_grid.json`` (read-only) for the cheapest fleet on
each workload family's cost/SLO frontier.

    PYTHONPATH=src python -m repro_torch.examples.capacity_planner
"""
import json
import os

from repro_torch.core import (PrfaasSimulator, SimConfig, SystemConfig,
                              ThroughputModel, Workload, paper_h20_profile,
                              paper_h200_profile)

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir, os.pardir, os.pardir))


def share_split(total, shares, min_per=1):
    """Allocate instances ~proportional to regional traffic, >=1 each
    (a region with zero prefill instances models to zero capacity: its
    short requests have nowhere to run)."""
    alloc = [max(min_per, round(total * s)) for s in shares]
    alloc[0] += total - sum(alloc)            # rounding drift -> hot region
    return tuple(alloc)


def main():
    """Print the plan; returns the sweep's best (plan, rate, Gbps), the
    bursty run's metrics and the regional run's metrics."""
    w = Workload()
    tm = ThroughputModel(paper_h200_profile(), paper_h20_profile(), w)

    print("PrfaaS-PD capacity plan (PD cluster fixed at 8 instances)")
    print(f"{'N_prfaas':>9} {'link':>9} {'t*':>8} {'Np/Nd':>6} {'req/s':>7} "
          f"{'egress':>9} {'vs_none':>8}")
    _, base, _ = ThroughputModel(None, paper_h20_profile(),
                                 w).grid_search(0, 8, 0)
    best = None
    for n_prfaas in (0, 2, 4, 8):
        for gbps in (10, 100, 400):
            if n_prfaas == 0 and gbps > 10:
                continue
            sc, lam, _ = tm.grid_search(n_prfaas, 8, gbps * 1e9 / 8) \
                if n_prfaas else ThroughputModel(
                    None, paper_h20_profile(), w).grid_search(0, 8, 0)
            egress = tm.egress_load(sc) * 8 / 1e9 if n_prfaas else 0.0
            print(f"{n_prfaas:>9} {gbps:>7}Gb {sc.threshold/1000:>7.1f}K "
                  f"{sc.n_p}/{sc.n_d:>4} {lam:>7.2f} {egress:>8.1f}Gb "
                  f"{lam/base:>7.2f}x")
            if best is None or lam > best[1]:
                best = (sc, lam, gbps)

    sc, lam, gbps = best
    print(f"\nvalidating best plan under bursty traffic "
          f"(burst_factor=1.6, link fluctuation 20%):")
    wb = Workload(burst_factor=1.6, burst_period_s=120.0, session_prob=0.3)
    sim = PrfaasSimulator(tm, sc, wb, SimConfig(
        arrival_rate=0.85 * lam, sim_time=600, dt=0.05, seed=0,
        link_gbps=gbps, link_fluctuation=0.2, autoscale=True))
    m = sim.run()
    print(f"  sustained {m['throughput_rps']:.2f} req/s "
          f"(offered {0.85*lam:.2f}), TTFT p90 {m['ttft_p90']:.2f}s, "
          f"egress {m['egress_gbps']:.1f} Gbps, "
          f"router adjustments {m['router_adjustments']}, "
          f"threshold now {m['threshold']/1000:.1f}K")

    # regional build-out: three PD clusters over a star topology
    shares = (0.5, 0.3, 0.2)
    region_gbps = (100.0, 50.0, 25.0)        # thinner links to small regions
    sc_r, lam_r, _ = tm.grid_search(4, 12, 100e9 / 8)
    sc3 = SystemConfig(sc_r.n_prfaas, sc_r.n_p, sc_r.n_d, sc_r.b_out,
                       sc_r.threshold,
                       n_p_clusters=share_split(sc_r.n_p, shares),
                       n_d_clusters=share_split(sc_r.n_d, shares))
    lam3 = tm.lambda_max(sc3, pd_shares=list(shares))
    print(f"\nregional build-out: 12 PD instances as 3 clusters "
          f"(shares {shares}, links {region_gbps} Gbps):")
    print(f"  Np/Nd per region {sc3.n_p_clusters}/{sc3.n_d_clusters}; "
          f"modeled capacity {lam3:.2f} req/s "
          f"(vs {lam_r:.2f} pooled; regional split costs "
          f"{(1 - lam3/lam_r)*100:.0f}%)")
    sim3 = PrfaasSimulator(tm, sc3, wb, SimConfig(
        arrival_rate=0.85 * lam3, sim_time=600, dt=0.05, seed=0,
        link_fluctuation=0.2, pd_clusters=3, pd_shares=shares,
        pd_link_gbps=region_gbps, pd_mesh_gbps=10.0,
        autoscale=True, roam_prob=0.1))       # regionalized control plane ON
    m3 = sim3.run()
    print(f"  sustained {m3['throughput_rps']:.2f} req/s, "
          f"TTFT p90 {m3['ttft_p90']:.2f}s, "
          f"egress {m3['egress_gbps']:.1f} Gbps")
    for name, c in m3["clusters"].items():
        print(f"    {name}: {c['throughput_rps']:.2f} req/s, "
              f"TTFT p90 {c['ttft_p90']:.2f}s, t {c['threshold']/1000:.1f}K, "
              f"cache-hit {c['cache_hit_frac']*100:.0f}%, "
              f"P<->D conversions {c['conversions']}")
    for pair, s in m3["links"].items():
        if s["sent_bytes"]:
            kind = "mesh" if "prfaas" not in pair else "star"
            print(f"    {kind} link {pair}: "
                  f"{s['sent_bytes']*8/1e9/600:.2f} Gbps avg "
                  f"of {s['capacity_gbps']:.0f} Gbps")
    # planner-side check at the state the sim actually converged to: the
    # autoscalers' final per-region (n_p, n_d) plus the per-home thresholds
    names = sorted(m3["thresholds"])
    n_p_f = tuple(sim3.autoscalers[n].system.n_p for n in names)
    n_d_f = tuple(sim3.autoscalers[n].system.n_d for n in names)
    sc3_final = SystemConfig(sc_r.n_prfaas, sum(n_p_f), sum(n_d_f),
                             sc_r.b_out, sc_r.threshold,
                             n_p_clusters=n_p_f, n_d_clusters=n_d_f)
    lam3_t = tm.lambda_max(sc3_final, pd_shares=list(shares),
                           thresholds=[m3["thresholds"][n] for n in names])
    print(f"  modeled capacity at the converged allocation "
          f"{n_p_f}/{n_d_f} + per-home thresholds: {lam3_t:.2f} req/s")

    # scenario-engine frontier: what does the SLO actually cost?
    # The scenario engine sweeps workload family x topology x policy x
    # fleet size through the vectorized simulator and keeps the
    # Pareto-optimal (cost-per-1M-requests, SLO attainment) points.  The
    # planner walks that frontier: the cheapest fleet meeting the target.
    TARGET_ATTAINMENT = 0.9
    _bench = os.path.join(ROOT, "BENCH_scenario_grid.json")
    if not os.path.exists(_bench):
        print("\n(no BENCH_scenario_grid.json at the repo root: the "
              "scenario engine's cost/SLO frontier is not there to read)")
    else:
        with open(_bench) as f:
            _grid = json.load(f)
        frontier = _grid.get("frontier", {})
        slo = _grid.get("slo_ttft_s", 0.0)
        print(f"\ncost/SLO frontier by workload family "
              f"(TTFT SLO {slo:.0f}s, target attainment "
              f">={TARGET_ATTAINMENT:.0%}):")
        for fam, pts in frontier.items():
            curve = " -> ".join(f"${p['cost_per_mreq']:.0f}@"
                                f"{p['slo_attainment']:.2f}" for p in pts)
            print(f"  {fam}: {curve}")
            ok = [p for p in pts if p["slo_attainment"] >= TARGET_ATTAINMENT]
            if ok:
                p = ok[0]                 # frontier is sorted by cost
                print(f"    -> cheapest meeting target: "
                      f"{p['size']:.2f}x fleet, {p['pd_clusters']} "
                      f"region(s), {p['policy']} policy: "
                      f"${p['cost_per_mreq']:.0f}/Mreq "
                      f"(attains {p['slo_attainment']:.1%}, "
                      f"p99 {p['ttft_p99_s']:.1f}s)")
            else:
                p = pts[-1]
                print(f"    -> NO swept fleet meets "
                      f"{TARGET_ATTAINMENT:.0%}; "
                      f"best is {p['size']:.2f}x/{p['policy']} at "
                      f"{p['slo_attainment']:.1%} — provision beyond "
                      f"{max(pt['size'] for pt in pts):.2f}x or relax the "
                      f"SLO")
    return best, m, m3


if __name__ == "__main__":
    main()
