"""Multi-region serving launcher on the port.

Drives the port's ``CrossDCDeployment`` (N PD regions fed by one PrfaaS
cluster over a ``LinkTopology``, routed by the reference's ``Router``)
under the reference launcher's sessionful synthetic workload, and prints
per-request routes and the deployment metrics.  Weights are drawn from
``--seed``.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-linear-1t \
        --smoke --requests 12 --pd-clusters 3 --pd-mesh-gbps 10 \
        --wire-compression --freeze-thresholds

The reference's ``--cross-validate`` (a replay through the cluster
simulator) belongs to a later slice of the port.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import split_even
from repro_torch.models import Model
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
    ap.add_argument("--freeze-thresholds", action="store_true",
                    help="disable congestion feedback")
    ap.add_argument("--session-prob", type=float, default=0.35,
                    help="P(request continues an open session)")
    ap.add_argument("--decode-block-size", type=int, default=8)
    ap.add_argument("--max-prefill-bucket", type=int, default=None,
                    help="pow2 bucket cap; longer prompts run as chunked "
                         "prefill interleaved between decode blocks")
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
    """Sessionful multi-region request batches (the reference launcher's
    workload generator)."""
    rng = np.random.default_rng(args.seed)
    sessions: dict = {}                    # sid -> (length, home)
    batches = []
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
            rid += 1
        batches.append(batch)
    return batches


def run_serve(args) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
        tbt_slo_s=args.tbt_slo)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, args.device)
    dep = CrossDCDeployment(Model(cfg), params, dep_cfg)
    batches = generate_workload(args, cfg, dep.pd_names, shares)
    for batch in batches:
        dep.submit_batch(batch)
    return {"deployment": dep.metrics(),
            "_requests": [r for batch in batches for r in batch]}


def main():
    args = build_parser().parse_args()
    report = run_serve(args)
    for r in report.pop("_requests"):
        print(f"req {r.rid}: len={len(r.tokens):4d} home={r.home:5s} "
              f"route={r.route:7s} cached={r.cached_tokens:4d} "
              f"kv={r.kv_bytes:9d}B ttft={r.ttft_s*1000:8.1f}ms")
    print(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
