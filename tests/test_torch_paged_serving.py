"""The port's paged serving path against the reference's, on the CPU, with
the reference's params carried over (float32 smoke models):

  * greedy tokens through ``RegionScheduler`` over the paged layout equal
    the reference's paged tokens and the port's own dense tokens;
  * a request that resumes from another's registered prefix pages
    prefills only its uncached suffix (``tokens_prefilled``) and emits the
    reference's tokens;
  * the page pool is conserved (``allocated == freed + evicted +
    resident``) under churn that exhausts it;
  * ``CrossDCDeployment(paged_kv=True)`` pins a device-resident prefix at
    routing and serves every request as the reference does, with and
    without int8 wire admission.

Mirrors ``tests/test_paged_kv.py`` of the reference, on smoke
``mistral-nemo-12b`` (GQA); ``tests/test_torch_paged_mla.py`` runs the
first two checks on smoke ``kimi-linear-1t`` (MLA + KDA), and
``tests/test_torch_hybrid.py`` the first two and the deployment on smoke
``zamba2-1.2b`` (Mamba2 + a shared MHA block).  Tokens are
compared exactly; timings are not compared.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import configs, shared_params
from repro.core.blockpool import BlockPool as JaxBlockPool
from repro.core.prefix_cache import HybridPrefixCache as JaxPrefixCache
from repro.models import Model as JaxModel
from repro.serving import CrossDCDeployment as JaxDeployment
from repro.serving import DeploymentConfig as JaxDeploymentConfig
from repro.serving import engine as jeng
from repro.serving.api import PagePin as JaxPagePin
from repro.serving.api import Request as JaxRequest
from repro_torch.core.blockpool import BlockPool
from repro_torch.core.prefix_cache import HybridPrefixCache
from repro_torch.models import Model
from repro_torch.serving import CrossDCDeployment, DeploymentConfig
from repro_torch.serving import engine as teng
from repro_torch.serving.api import PagePin, Request

torch.set_num_threads(1)
SLOTS, CAPACITY, BLOCK, MAX_BUCKET, PAGE = 4, 384, 8, 64, 16
GQA, MLA = "mistral-nemo-12b", "kimi-linear-1t"


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


# (engine module, model, params, Request, PagePin, BlockPool, prefix cache)
def _reference(arch):
    jcfg, _, jparams, _ = _setup(arch)
    return (jeng, JaxModel(jcfg, use_kernels=False), jparams, JaxRequest,
            JaxPagePin, JaxBlockPool, JaxPrefixCache)


def _port(arch):
    _, tcfg, _, tparams = _setup(arch)
    return (teng, Model(tcfg), tparams, Request, PagePin, BlockPool,
            HybridPrefixCache)


def _scheduler(side, *, paged, pool=None, cache=None, batch=3):
    eng, model, params = side[:3]
    peng = eng.PrefillEngine(model, params, min_bucket=32,
                             max_bucket=MAX_BUCKET)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                           paged=paged, pool=pool, page_tokens=PAGE)
    if cache is not None:
        dec.on_admit = lambda req, L, ids, snap: cache.insert_device(
            [int(t) for t in req.tokens], ids, snap)
    return peng, dec, eng.RegionScheduler(peng, dec,
                                          max_prefill_batch=batch)


def _serve(side, prompts, budgets, *, paged):
    _, dec, sched = _scheduler(side, paged=paged)
    for i, (t, b) in enumerate(zip(prompts, budgets)):
        sched.submit(side[3](rid=i, tokens=t, max_new_tokens=b))
    sched.run()
    assert not sched.has_work
    return {rid: r.output_tokens for rid, r in dec.outputs.items()}, dec


def _prompts(lens, seed):
    """Random prompts over the smoke vocabulary (256 tokens)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (L,)).astype(np.int32) for L in lens]


@pytest.mark.parametrize("arch", [GQA])
def test_paged_tokens_match_dense_and_reference(arch):
    """Mixed lengths, more requests than slots, a chunked prompt past
    max_bucket: the port's paged tokens equal the reference's paged tokens
    and the port's dense tokens; the pool comes back whole."""
    prompts = _prompts([24, 40, 70, 16, 33, 64], seed=0)
    budgets = [12, 20, 9, 16, 11, 7]
    want, _ = _serve(_reference(arch), prompts, budgets, paged=True)
    got, dec = _serve(_port(arch), prompts, budgets, paged=True)
    dense, _ = _serve(_port(arch), prompts, budgets, paged=False)
    assert got == want == dense
    s = dec.pool.stats
    assert s["allocated"] > 0
    assert s["allocated"] == s["freed"] + s["evicted"] + dec.pool.resident
    assert dec.pool.resident == 0
    dec.pool.check_invariants()


def _resume(side, arch, prefix, tokens_b):
    """Request A (the prefix) runs and retires with its pages registered;
    request B resumes from them.  Returns (B's tokens, cached length,
    tokens prefilled for B, pool)."""
    flags = dict(has_full_attn=True,
                 has_linear=arch != GQA)        # kimi, zamba2: linear state
    pool = side[5](SLOTS * CAPACITY // PAGE, PAGE, 1)
    cache = side[6](pool, 0, 1, **flags)
    peng, dec, sched = _scheduler(side, paged=True, pool=pool, cache=cache)
    sched.submit(side[3](rid=0, tokens=prefix, max_new_tokens=6))
    sched.run()
    c, ids, snap = cache.match_resume([int(t) for t in tokens_b])
    pool.retain(ids)
    before = peng.tokens_prefilled
    sched.submit(side[3](rid=1, tokens=tokens_b, max_new_tokens=12,
                         device_pin=side[4](c, ids, snap)))
    sched.run()
    return (dec.outputs[1].output_tokens, c, peng.tokens_prefilled - before,
            pool)


@pytest.mark.parametrize("arch", [GQA])
def test_prefix_hit_prefills_only_the_suffix(arch):
    """B shares a page-aligned 64-token prefix with a retired A and resumes
    from A's pool pages (GQA: through the paged-prefill path; MLA: gathered
    latents + the exact-length state snapshot): only the suffix is
    prefilled, and B's tokens equal the reference's resume and the port's
    fresh dense run."""
    prefix, suffix = _prompts([64, 41], seed=3)
    tokens_b = np.concatenate([prefix, suffix])
    want, jc, jcost, _ = _resume(_reference(arch), arch, prefix, tokens_b)
    got, c, cost, pool = _resume(_port(arch), arch, prefix, tokens_b)
    assert c == jc == 64
    assert cost == jcost == len(tokens_b) - 64
    assert got == want
    dense, _ = _serve(_port(arch), [tokens_b], [12], paged=False)
    assert got == dense[0]
    pool.check_invariants()
    s = pool.stats
    assert s["allocated"] == s["freed"] + s["evicted"] + pool.resident


def _churn(side):
    """Four concurrent requests outgrow a 20-page pool (truncations), then
    a wave of prefix resumes on the same pool.  Returns (tokens and
    truncation flags, page-failure retires, pool)."""
    pool = side[5](20, PAGE, 1)
    cache = side[6](pool, 0, 1, has_full_attn=True, has_linear=False)
    _, dec, sched = _scheduler(side, paged=True, pool=pool, cache=cache,
                               batch=4)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 256, (32,)).astype(np.int32)
    for i in range(4):
        tail = rng.integers(0, 256, (int(rng.integers(6, 14)),)
                            ).astype(np.int32)
        sched.submit(side[3](rid=i, tokens=np.concatenate([prefix, tail]),
                             max_new_tokens=int(rng.integers(41, 55))))
    sched.run()
    for i in range(3):
        tail = rng.integers(0, 256, (int(rng.integers(6, 14)),)
                            ).astype(np.int32)
        toks = np.concatenate([prefix, tail])
        c, ids, snap = cache.match_resume([int(t) for t in toks])
        if c:
            pool.retain(ids)
        sched.submit(side[3](rid=10 + i, tokens=toks,
                             max_new_tokens=int(rng.integers(9, 19)),
                             device_pin=side[4](c, ids, snap) if c else None))
    sched.run()
    assert not sched.has_work
    out = {rid: (r.output_tokens, r.truncated)
           for rid, r in dec.outputs.items()}
    return out, dec.page_fail_retires, pool


def test_pool_conserved_under_churn_with_exhaustion():
    want, jfails, _ = _churn(_reference(GQA))
    got, fails, pool = _churn(_port(GQA))
    assert fails == jfails > 0, "churn must exhaust the pool"
    assert got == want and len(got) == 7
    pool.check_invariants()
    s = pool.stats
    assert s["allocated"] == s["freed"] + s["evicted"] + pool.resident


DEP = dict(decode_slots=SLOTS, capacity=CAPACITY, decode_block_size=BLOCK,
           min_prefill_bucket=32, max_prefill_bucket=64, block_tokens=PAGE,
           pool_blocks=96, paged_kv=True, link_gbps=100.0,
           adapt_thresholds=False)


def _deploy(dep, req_cls, batches):
    reqs, out = [], {}
    for batch in batches:
        rs = [req_cls(rid=i, tokens=t.copy(), max_new_tokens=b)
              for i, t, b in batch]
        out.update(dep.submit_batch(rs))
        reqs += rs
    return reqs, out


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
def test_paged_deployment_matches_reference(wire, arch=GQA):
    """A first turn, then its extension: ``_route`` pins the registered
    prefix and the home region prefills only the suffix.  Per request the
    route, cached tokens, pin, wire bytes and tokens equal the reference's;
    the region's pool stats too.  ``wire``: a low threshold offloads the
    first turn, which admits as int8 pages dequantized in the write."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    prefix, suffix, other = _prompts([64, 30, 20], seed=11)
    batches = [[(0, prefix, 4), (1, other, 5)],
               [(2, np.concatenate([prefix, suffix]), 6)]]
    kw = dict(DEP, threshold=40 if wire else 4096, wire_compression=wire)
    jdep = JaxDeployment(JaxModel(jcfg, use_kernels=False), jparams,
                         JaxDeploymentConfig(**kw))
    dep = CrossDCDeployment(Model(tcfg), tparams, DeploymentConfig(**kw))
    jreqs, jout = _deploy(jdep, JaxRequest, batches)
    before = dep.pd_prefill.tokens_prefilled
    reqs, out = _deploy(dep, Request, batches)
    for jr, r in zip(jreqs, reqs):
        jpin = None if jr.device_pin is None else jr.device_pin.cached_len
        pin = None if r.device_pin is None else r.device_pin.cached_len
        assert (r.route, r.cached_tokens, pin, r.kv_bytes, r.kv_bytes_raw) \
            == (jr.route, jr.cached_tokens, jpin, jr.kv_bytes,
                jr.kv_bytes_raw), r.rid
        assert out[r.rid].output_tokens == jout[jr.rid].output_tokens, r.rid
    assert reqs[2].device_pin.cached_len == 64
    local = sum(len(r.tokens) for r in reqs[:2] if r.route == "pd")
    assert dep.pd_prefill.tokens_prefilled - before == local + 30
    assert {r.route for r in reqs[:2]} == ({"prfaas", "pd"} if wire
                                           else {"pd"})
    m, jm = dep.metrics(), jdep.metrics()
    region, jregion = m["clusters"]["pd"], jm["clusters"]["pd"]
    assert region["pool"] == jregion["pool"]
    assert region["resident_kv_bytes"] == jregion["resident_kv_bytes"] > 0
    assert region["page_fail_retires"] == 0
    assert m["paged_kv"] is True
    pool = region["pool"]
    assert pool["allocated"] == (pool["freed"] + pool["evicted"]
                                 + pool["resident"])
    if wire:
        assert dep.decoders["pd"].wire_admission
        assert dep.measured_compression() == jdep.measured_compression() > 1
