"""Quickstart: the PrfaaS idea in 60 seconds, on the port.

A copy of the reference's ``examples/quickstart.py`` with ``--device``
(default ``cuda``):
1. a hybrid-attention model (the paper's KDA:MLA 3:1 family) against a
   dense one: the S_kv asymmetry that makes cross-DC KV plausible;
2. the paper's measured profile through the throughput model (Eqs. 1-8),
   the grid search over (t, N_p/N_d), Table 6;
3. one real prefill of a smoke-size model, its cache shipped, then eight
   decode steps from the shipped cache.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On CUDA the prefill runs the flash and masked delta kernels and the
decode steps the flash-decode kernel.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (ThroughputModel, Workload, kv_throughput,
                              paper_h20_profile, paper_h200_profile)
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models.kvcache import cache_num_bytes
from repro_torch.params import init_params


def skv_asymmetry():
    """Part 1: {seq_len: (hybrid MiB, dense MiB)} and the hybrid's KV
    throughput at 32K in Gbps."""
    print("=" * 72)
    print("1. Why hybrid models change the PD deployment boundary (paper §2.2)")
    print("=" * 72)
    hybrid = get_config("kimi-linear-1t")
    dense = get_config("mistral-nemo-12b")
    mib = {}
    for l in (8192, 32768, 131072):
        mib[l] = (hybrid.kv_cache_bytes(l) / 2**20,
                  dense.kv_cache_bytes(l) / 2**20)
        print(f"  S_kv({l//1024:>4}K): hybrid-1T = {mib[l][0]:8.1f} MiB   "
              f"dense-12B = {mib[l][1]:8.1f} MiB")
    phi = kv_throughput(paper_h200_profile(), 32768) * 8 / 1e9
    print(f"  1T hybrid KV throughput @32K: {phi:.1f} Gbps -> commodity "
          f"Ethernet")
    return mib, phi


def table6():
    """Part 2: the grid search's plan, its rate, the homogeneous rate and
    the egress in Gbps."""
    print()
    print("=" * 72)
    print("2. Throughput model + grid search reproduces Table 6 (paper §4)")
    print("=" * 72)
    w = Workload()
    tm = ThroughputModel(paper_h200_profile(), paper_h20_profile(), w)
    sc, lam, _ = tm.grid_search(n_prfaas=4, n_pd_total=8, b_out=100e9 / 8)
    _, lam_h, _ = ThroughputModel(None, paper_h20_profile(),
                                  w).grid_search(0, 12, 0)
    egress = tm.egress_load(sc) * 8 / 1e9
    print(f"  optimal: t={sc.threshold/1000:.1f}K tokens (paper 19.4K), "
          f"N_p/N_d={sc.n_p}/{sc.n_d} (paper 3/5)")
    print(f"  PrfaaS-PD {lam:.2f} req/s vs homogeneous {lam_h:.2f} req/s "
          f"-> {lam/lam_h:.2f}x (paper 1.54x)")
    print(f"  egress {egress:.1f} Gbps of 100 Gbps (paper ~13)")
    return sc, lam, lam_h, egress


def prefill_ship_decode(device, params=None, steps: int = 8):
    """Part 3 on ``device``: a 64-token prefill of smoke kimi-linear-1t
    (``params`` given, or drawn from seed 0), its cache bytes, then
    ``steps`` greedy decode steps from the cache placed in 96-row decode
    buffers.  Returns (cache bytes, the tokens)."""
    print()
    print("=" * 72)
    print("3. Real prefill -> KV transfer -> decode (smoke-scale model)")
    print("=" * 72)
    cfg = get_smoke_config("kimi-linear-1t")
    model = Model(cfg)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                           dtype=torch.long, device=device)
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks})
        nbytes = cache_num_bytes(caches)
        print(f"  prefill produced {nbytes} KV bytes (would take "
              f"{nbytes*8/1e9*1000:.2f} ms on a 1 Gbps inter-DC link)")
        dc = prepare_decode_caches(cfg, caches, capacity=96)
        tok = torch.argmax(logits, -1)
        out = [int(tok[0])]
        lengths = torch.full((1,), 64, dtype=torch.int32, device=device)
        for i in range(steps):
            lg, dc = model.decode_step(params, tok, dc, lengths + i)
            tok = torch.argmax(lg, -1)
            out.append(int(tok[0]))
    print(f"  decoded from shipped cache: {out}")
    return nbytes, out


def main(argv=None, params=None):
    """Run the three parts; ``params``: the smoke model's tree on
    ``--device`` (else drawn from seed 0).  Returns their results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mib, phi = skv_asymmetry()
    sc, lam, lam_h, egress = table6()
    nbytes, tokens = prefill_ship_decode(torch.device(args.device), params)
    print("done.")
    return {"skv_mib": mib, "kv_gbps_32k": phi,
            "plan": (sc.threshold, sc.n_p, sc.n_d), "rate": lam,
            "rate_homogeneous": lam_h, "egress_gbps": egress,
            "kv_bytes": nbytes, "tokens": tokens}


if __name__ == "__main__":
    main()
