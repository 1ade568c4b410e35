"""Multi-region serving launcher on the port + policy/actual
cross-validation.

Drives the port's ``CrossDCDeployment`` (N PD regions fed by one PrfaaS
cluster over a ``LinkTopology``, routed by the same ``core.router.Router``
the simulator uses) under the reference launcher's sessionful synthetic
workload, and prints per-request routes and the deployment metrics; then
(``--cross-validate``) replays the live run's arrival trace through
``core.simulator.PrfaasSimulator`` and reports per-request route agreement
plus TTFT/egress deltas.  With ``--freeze-thresholds`` (no congestion
feedback on either side) the two control planes are the same code over the
same state and must agree on every request; with live feedback they may
drift where telemetry timing differs.  The fidelity caveats are the
reference's (``src/repro/launch/serve.py``): freezing pins thresholds, not
the abundant/scarce bandwidth regime, and the live TTFT/egress are upper
bounds (the deployment reships the full prefill cache on a cached prefix).

Weights are drawn from ``--seed``.  Decode is greedy unless
``--temperature`` is set (``--top-k`` keeps the k largest logits), and
speculative with ``--spec-k`` draft tokens a round (greedy only);
``--calibration`` prices routing and the replay with a measured profile
(``python -m repro_torch.analysis.calibrate --sweep``).  Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-linear-1t \
        --smoke --requests 12 --batches 3 --pd-clusters 3 \
        --pd-mesh-gbps 10 --link-gbps 10 --wire-compression \
        --freeze-thresholds --cross-validate
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (PrfaasSimulator, SimConfig, SystemConfig,
                              ThroughputModel, Workload, split_even)
from repro_torch.core.hardware import CHIPS, AnalyticProfile
from repro_torch.models import Model
from repro_torch.models.model import require_token_only
from repro_torch.params import init_params
from repro_torch.serving import CrossDCDeployment, DeploymentConfig, Request


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8, help="total requests")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--threshold", type=int, default=64)
    ap.add_argument("--link-gbps", type=float, default=1.0,
                    help="PrfaaS->region star link capacity (all regions)")
    ap.add_argument("--pd-clusters", type=int, default=1)
    ap.add_argument("--pd-shares", type=str, default=None,
                    help="comma-separated regional traffic shares")
    ap.add_argument("--pd-link-gbps", type=str, default=None,
                    help="comma-separated per-region star-link Gbps")
    ap.add_argument("--pd-mesh-gbps", type=float, default=0.0)
    ap.add_argument("--wire-compression", action="store_true",
                    help="int8-quantize KV on the inter-DC wire")
    ap.add_argument("--calibration", default=None,
                    help="a sweep's JSON (repro_torch.analysis.calibrate "
                         "--sweep): route thresholds + simulator service "
                         "times then derive from that machine's measured "
                         "kernels (CalibratedProfile) instead of the "
                         "default chip roofline")
    ap.add_argument("--freeze-thresholds", action="store_true",
                    help="disable congestion feedback (deterministic "
                         "routing for exact cross-validation)")
    ap.add_argument("--cross-validate", action="store_true",
                    help="replay the live arrival trace through "
                         "PrfaasSimulator and report route agreement")
    ap.add_argument("--session-prob", type=float, default=0.35,
                    help="P(request continues an open session)")
    ap.add_argument("--decode-block-size", type=int, default=8)
    ap.add_argument("--max-prefill-bucket", type=int, default=None,
                    help="pow2 bucket cap; longer prompts run as chunked "
                         "prefill interleaved between decode blocks")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decode sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the top-k logits (0 = full vocab)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft tokens per verify round "
                         "(0 = plain decode; greedy only)")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="drafter suffix-match length")
    ap.add_argument("--tbt-slo", type=float, default=0.0)
    ap.add_argument("--batch-gap-s", type=float, default=120.0)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _parse_floats(text, k, what):
    if text is None:
        return None
    vals = tuple(float(x) for x in text.split(","))
    if len(vals) != k:
        raise SystemExit(f"{what} needs {k} comma-separated values")
    return vals


def _session_tokens(seed: int, sid: int, length: int, vocab: int):
    """Deterministic per-session token stream: a longer turn of a session
    is an exact prefix extension, so prefix-cache hits are real."""
    rng = np.random.default_rng((seed * 1_000_003 + sid) & 0x7FFFFFFF)
    return rng.integers(0, vocab, (length,)).astype(np.int32)


def generate_workload(args, cfg, pd_names, shares):
    """Sessionful multi-region batches + the matching simulator trace (the
    reference launcher's workload generator).

    Returns (batches, trace) where ``trace`` rows are
    ``(arrival_s, total_len, session_id, home)`` in request order — exactly
    what ``PrfaasSimulator.inject_trace`` consumes."""
    rng = np.random.default_rng(args.seed)
    sessions: dict = {}                    # sid -> (length, home)
    batches, trace = [], []
    rid, next_sid = 0, 0
    sizes = [n for n in split_even(args.requests, max(1, args.batches))
             if n > 0]
    for b, size in enumerate(sizes):
        arrival = b * args.batch_gap_s
        batch = []
        for _ in range(size):
            if sessions and rng.random() < args.session_prob:
                sid = sorted(sessions)[int(rng.integers(len(sessions)))]
                length, home = sessions[sid]
                length = min(length + int(rng.integers(16, 64)), 480)
                sessions[sid] = (length, home)
            else:
                sid, next_sid = next_sid, next_sid + 1
                length = int(rng.integers(8, 256))
                home = pd_names[int(rng.choice(len(pd_names), p=shares))] \
                    if len(pd_names) > 1 else pd_names[0]
                sessions[sid] = (length, home)
            batch.append(Request(
                rid=rid, tokens=_session_tokens(args.seed, sid, length,
                                                cfg.vocab_size),
                max_new_tokens=args.max_new_tokens, arrival=arrival,
                home=home))
            trace.append((arrival, length, sid, home))
            rid += 1
        batches.append(batch)
    return batches, trace


def cross_validate(args, model_cfg, dep: CrossDCDeployment, trace,
                   live_reqs) -> dict:
    """Replay the live run's arrival trace through the discrete-event
    simulator (same Router policy, same topology shape, the live run's
    profile) and compare per-request routing plus TTFT/egress."""
    k = args.pd_clusters
    if dep.cfg.calibration:
        # the replay must price prefill with the SAME measured profile the
        # live Router used, or thresholds/agreement are meaningless
        profile = dep.profile
    else:
        profile = AnalyticProfile(
            model_cfg, CHIPS[dep.cfg.chip], dep.cfg.chips_per_instance,
            kv_dtype_bytes=2 if model_cfg.dtype == "bfloat16" else 4)
    w = Workload()
    tm = ThroughputModel(profile, profile, w)
    ratio = dep.measured_compression() if args.wire_compression else 1.0
    sc = SystemConfig(1, k, k, dep.system.b_out, float(args.threshold),
                      kv_wire_compression=ratio)
    horizon = trace[-1][0] + args.batch_gap_s + 60.0
    # price speculation with the live run's measured acceptance: mean
    # accepted draft tokens per verify round (0.0 with speculation off)
    rounds = sum(d.verify_rounds for d in dep.decoders.values())
    accepted = sum(d.accepted_tokens for d in dep.decoders.values())
    accept_rate = (accepted / rounds - 1.0) if rounds else 0.0
    sim = PrfaasSimulator(tm, sc, w, SimConfig(
        arrival_rate=1.0, sim_time=horizon, seed=args.seed,
        link_gbps=args.link_gbps, pd_clusters=k,
        pd_shares=_parse_floats(args.pd_shares, k, "--pd-shares"),
        pd_link_gbps=_parse_floats(args.pd_link_gbps, k, "--pd-link-gbps"),
        pd_mesh_gbps=args.pd_mesh_gbps,
        block_tokens=dep.cfg.block_tokens,
        # replay decode admission at the live engine's block-boundary
        # cadence (the RegionScheduler admits at step_block boundaries)
        decode_block_tokens=dep.cfg.decode_block_size,
        spec_accept_rate=accept_rate, tbt_slo_s=dep.cfg.tbt_slo_s,
        pool_blocks=200_000, engine="event",
        # frozen: no control epochs -> per-home thresholds never move on
        # either side, so routing must agree exactly
        control_dt=0.0 if args.freeze_thresholds else 0.25))
    sim_reqs = sim.inject_trace(trace)
    sim.run()
    sim.topology.run_until_idle()

    routed = [(lr, sr) for lr, sr in zip(live_reqs, sim_reqs)
              if lr.decision is not None and sr.decision is not None]
    agree = [lr.decision.target == sr.decision.target for lr, sr in routed]
    mismatches = [
        {"rid": lr.rid, "live": lr.decision.target,
         "sim": sr.decision.target, "home": lr.home}
        for (lr, sr), ok in zip(routed, agree) if not ok]
    live_ttft = float(np.mean([lr.ttft_s for lr in live_reqs]))
    sim_ttft_v = [sr.first_token - sr.arrival for sr in sim_reqs
                  if sr.first_token > 0]
    sim_ttft = float(np.mean(sim_ttft_v)) if sim_ttft_v else float("nan")
    live_egress = dep.topology.sent_bytes
    sim_egress = sim.topology.sent_bytes
    return {
        "requests": len(routed),
        "route_agreement": (sum(agree) / len(agree)) if agree else 1.0,
        "mismatches": mismatches,
        "thresholds": {"live": {n: dep.router.threshold_for(n)
                                for n in dep.pd_names},
                       "sim": {n: sim.router.threshold_for(n)
                               for n in sim._pd_names}},
        "ttft": {"live_mean_s": live_ttft, "sim_mean_s": sim_ttft,
                 "delta_s": sim_ttft - live_ttft},
        "egress_bytes": {"live": live_egress, "sim": sim_egress,
                         "ratio": sim_egress / max(live_egress, 1.0)},
        "kv_wire_compression": ratio,
        "spec_accept_rate": accept_rate,
    }


def run_serve(args) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    require_token_only(cfg, "the serving launcher")
    k = args.pd_clusters
    shares = _parse_floats(args.pd_shares, k, "--pd-shares")
    if shares is not None:
        shares = tuple(s / sum(shares) for s in shares)
    elif k > 1:
        shares = tuple([1.0 / k] * k)
    dep_cfg = DeploymentConfig(
        threshold=args.threshold, link_gbps=args.link_gbps,
        pd_link_gbps=_parse_floats(args.pd_link_gbps, k, "--pd-link-gbps"),
        pd_mesh_gbps=args.pd_mesh_gbps, pd_clusters=k,
        decode_slots=max(4, -(-args.requests // max(1, args.batches))),
        capacity=512, wire_compression=args.wire_compression,
        adapt_thresholds=not args.freeze_thresholds,
        decode_block_size=args.decode_block_size,
        max_prefill_bucket=args.max_prefill_bucket,
        temperature=args.temperature, top_k=args.top_k,
        sample_seed=args.seed, spec_k=args.spec_k,
        spec_ngram=args.spec_ngram, tbt_slo_s=args.tbt_slo,
        calibration=args.calibration)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, args.device)
    dep = CrossDCDeployment(Model(cfg), params, dep_cfg)

    batches, trace = generate_workload(args, cfg, dep.pd_names, shares)
    live_reqs = [r for batch in batches for r in batch]
    outputs = {}
    for batch in batches:
        outputs.update(dep.submit_batch(batch))

    report = {"deployment": dep.metrics()}
    if args.cross_validate:
        report["cross_validate"] = cross_validate(args, cfg, dep, trace,
                                                  live_reqs)
    # stripped before printing: the requests and their responses by rid
    report["_requests"], report["_outputs"] = live_reqs, outputs
    return report


def main():
    args = build_parser().parse_args()
    report = run_serve(args)
    report.pop("_outputs")
    for r in report.pop("_requests"):
        print(f"req {r.rid}: len={len(r.tokens):4d} home={r.home:5s} "
              f"route={r.route:7s} cached={r.cached_tokens:4d} "
              f"kv={r.kv_bytes:9d}B ttft={r.ttft_s*1000:8.1f}ms")
    print(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
