"""Serve a small hybrid model through the two-cluster PrfaaS-PD deployment
on the port: routing by the same ``core.router.Router`` the cluster
simulator uses, real prefill on the "PrfaaS cluster", byte-accurate KV
transfer over a simulated Ethernet link (layer-wise pipelined),
continuous-batching decode on the "PD cluster", prefix-cache hits on
follow-up turns.

A copy of the reference's ``examples/serve_cross_dc.py`` with ``--device``
(default ``cuda``).  For N regions, int8 KV on the wire and simulator
cross-validation, see ``python -m repro_torch.launch.serve``.

    PYTHONPATH=src python -m repro_torch.examples.serve_cross_dc
    PYTHONPATH=src python -m repro_torch.examples.serve_cross_dc --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.params import init_params
from repro_torch.serving import CrossDCDeployment, DeploymentConfig, Request

ARCH = "kimi-linear-1t"          # the paper's case-study family


def main(argv=None, params=None):
    """Two turns of traffic; ``params``: the smoke model's tree on
    ``--device`` (else drawn from seed 0).  Returns (the turns' requests,
    the deployment, its metrics)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    dep = CrossDCDeployment(
        model, params,
        DeploymentConfig(threshold=64,       # offload prefills > 64 tokens
                         link_gbps=0.05,     # a deliberately skinny link
                         decode_slots=8, capacity=512, block_tokens=16))

    rng = np.random.default_rng(0)
    print(f"serving {ARCH} (smoke scale): threshold=64 tok, link=0.05 Gbps\n")

    # turn 1: a mixed batch of short and long prompts
    prompts = {i: rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
               for i, L in enumerate([24, 48, 150, 230, 90, 300])}
    reqs = [Request(rid=i, tokens=p, max_new_tokens=12)
            for i, p in prompts.items()]
    out = dep.submit_batch(reqs)
    print("turn 1 (cold caches):")
    for r in reqs:
        print(f"  req {r.rid}: len={len(r.tokens):4d} -> {r.route:7s} "
              f"cached={r.cached_tokens:4d} kv={r.kv_bytes:8d}B "
              f"prefill={r.prefill_s*1e3:7.1f}ms "
              f"transfer={r.transfer_s*1e3:7.1f}ms")

    # turn 2: agentic follow-ups (the same prefix + new tokens)
    follow = []
    for i, p in list(prompts.items())[:4]:
        grown = np.concatenate([p, rng.integers(0, cfg.vocab_size, (40,))
                                .astype(np.int32)])
        follow.append(Request(rid=100 + i, tokens=grown, max_new_tokens=8))
    out.update(dep.submit_batch(follow))
    print("\nturn 2 (incremental prefills after prefix-cache hits):")
    for r in follow:
        print(f"  req {r.rid}: len={len(r.tokens):4d} -> {r.route:7s} "
              f"cached={r.cached_tokens:4d} (incremental "
              f"{len(r.tokens)-r.cached_tokens})")

    m = dep.metrics()
    print(f"\nsummary: {m['requests']} requests, {m['offloaded']} offloaded, "
          f"mean TTFT {m['ttft_mean_s']*1e3:.1f} ms, "
          f"cross-DC KV {m['kv_bytes_total']} bytes, "
          f"hit rates {m['cache_hit_rate']}")
    # the deployment's inter-DC links and routing policy are the code the
    # cluster simulator runs (core.transfer.LinkTopology + core.router)
    print(f"link: {dep.link.sent_bytes:.0f} bytes on the wire, "
          f"busy {dep.link.busy_time*1e3:.1f} ms (virtual), "
          f"thresholds {m['thresholds']}")
    return reqs + follow, out, dep, m


if __name__ == "__main__":
    main()
