"""The port's ``CrossDCDeployment`` against the reference's on smoke
``kimi-linear-1t`` (float32, the reference's params carried over), with
int8 wire compression, a chunked long prompt and a session extension that
hits the prefix cache: per request the route, the cached prefix, the output
tokens and the raw and quantized wire bytes equal the reference's.
Timings are not compared.  Thresholds are frozen and the link is fat, so
the routing telemetry does not depend on measured wall times.  Plus the
port's launcher end to end on the CPU.  ``tests/test_torch_hybrid_serving.py``
runs the same checks on smoke ``zamba2-1.2b``.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import configs, shared_params
from repro.models import Model as JaxModel
from repro.serving import CrossDCDeployment as JaxDeployment
from repro.serving import DeploymentConfig as JaxDeploymentConfig
from repro.serving import Request as JaxRequest
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import (CrossDCDeployment, DeploymentConfig,
                                 Request)

torch.set_num_threads(1)
DEP = dict(threshold=64, link_gbps=100.0, decode_slots=4,
           capacity=256, decode_block_size=4, min_prefill_bucket=32,
           max_prefill_bucket=64, wire_compression=True,
           adapt_thresholds=False)


@functools.lru_cache(maxsize=None)
def _setup(arch="kimi-linear-1t"):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _batches(cfg):
    """Batch 1: short (local) and long (offloaded, one chunked) prompts.
    Batch 2: a session extension of a batch-1 prompt and a fresh one."""
    rng = np.random.default_rng(0)
    base = [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in (30, 150, 90, 12)]
    ext = np.concatenate([base[2], rng.integers(0, cfg.vocab_size, (30,))
                          .astype(np.int32)])
    fresh = rng.integers(0, cfg.vocab_size, (70,)).astype(np.int32)
    budgets = [6, 5, 7, 4, 5, 6]
    return [list(zip(range(4), base, budgets[:4])),
            list(zip((4, 5), (ext, fresh), budgets[4:]))]


def _serve(dep, req_cls, batches):
    reqs, out = [], {}
    for batch in batches:
        rs = [req_cls(rid=i, tokens=t, max_new_tokens=b,
                      home=dep.pd_names[i % len(dep.pd_names)])
              for i, t, b in batch]
        out.update(dep.submit_batch(rs))
        reqs += rs
    return reqs, out


@pytest.mark.parametrize("regions", [1, 2])
def test_deployment_matches_reference(regions, arch="kimi-linear-1t"):
    """One PD region, or two joined by a PD mesh link (requests alternate
    homes, so the session extension may find its prefix in another
    region)."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    batches = _batches(tcfg)
    kw = dict(DEP, pd_clusters=regions,
              pd_mesh_gbps=100.0 if regions > 1 else 0.0)
    jdep = JaxDeployment(JaxModel(jcfg), jparams, JaxDeploymentConfig(**kw))
    dep = CrossDCDeployment(Model(tcfg), tparams, DeploymentConfig(**kw))
    jreqs, jout = _serve(jdep, JaxRequest, batches)
    reqs, out = _serve(dep, Request, batches)
    for jr, r in zip(jreqs, reqs):
        assert (r.home, r.route, r.cached_tokens, r.kv_bytes,
                r.kv_bytes_raw, r.cross_kv_bytes) == \
            (jr.home, jr.route, jr.cached_tokens, jr.kv_bytes,
             jr.kv_bytes_raw, jr.cross_kv_bytes), r.rid
        assert out[r.rid].output_tokens == jout[jr.rid].output_tokens, r.rid
    routes = {r.route for r in reqs}
    assert routes == {"prfaas"} | set(dep.pd_names)
    assert any(r.cached_tokens > 0 for r in reqs)
    assert dep.measured_compression() == jdep.measured_compression() > 1.0
    # the link solver accumulates float bytes per time step, and its steps
    # follow measured prefill walls: equal up to float rounding
    assert dep.topology.sent_bytes == pytest.approx(jdep.topology.sent_bytes,
                                                    rel=1e-9)


def test_launcher_serves_every_request_on_cpu(arch="kimi-linear-1t"):
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu",
         "--requests", "6", "--wire-compression", "--freeze-thresholds",
         "--max-new-tokens", "3", "--max-prefill-bucket", "128"])
    report = serve.run_serve(args)
    reqs = report["_requests"]
    m = report["deployment"]
    assert m["requests"] == len(reqs) == 6
    assert {r.route for r in reqs} == {"pd", "prfaas"}
    assert m["kv_bytes_total"] > 0 and m["wire_compression"] > 1.0
    assert m["truncations"] == 0
