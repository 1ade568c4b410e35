"""The port's serving path on smoke ``xlstm-350m`` (mLSTM and sLSTM, no
attention) against the reference's, on the CPU, the reference's params
carried over (float32):

  * greedy tokens through ``RegionScheduler``, paged (state slots alone:
    tables of zero columns, no pages) and dense, equal the reference's;
    and the scheduler's tokens equal the alternating loop's (one bucketed
    prefill, then admit waves that drain), as
    ``tests/test_region_scheduler.py`` holds the reference's;
  * a request that resumes from another's page-aligned state snapshot
    prefills only its suffix and emits the reference's tokens;
  * speculative decode (``spec_k`` 2, one-token n-grams), dense and
    paged: the reference's streams, rounds and accepted tokens;
  * ``CrossDCDeployment``, paged (with and without int8 wire admission)
    and dense over one and two regions, with a chunked prompt and a
    prefix-cache hit: per request the route, cached prefix, pin, wire
    bytes and tokens equal the reference's; every leaf of this model
    ships as it is, so the measured compression is the reference's 1.0;
  * the launcher on the CPU.

Tokens are compared exactly; timings are not compared.
"""
import functools

import numpy as np
import pytest
import torch

import test_torch_paged_serving as paged_serving
import test_torch_spec_parity as spec_parity
from _torch_parity import configs, shared_params
from repro.models import Model as JaxModel
from repro.serving import CrossDCDeployment as JaxDeployment
from repro.serving import DeploymentConfig as JaxDeploymentConfig
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import CrossDCDeployment, DeploymentConfig
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)
XLSTM = "xlstm-350m"
SLOTS, CAPACITY, BLOCK, MAX_BUCKET, PAGE = 4, 384, 8, 64, 16


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = configs(arch=XLSTM)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def test_paged_tokens_match_dense_and_reference():
    """Mixed lengths, more requests than slots, a chunked prompt past
    max_bucket: the port's paged tokens equal the reference's and the
    port's dense ones.  An attention-free model takes no page: the pool's
    counts are the reference's, all zero."""
    prompts = paged_serving._prompts([24, 40, 70, 16, 33, 64], seed=0)
    budgets = [12, 20, 9, 16, 11, 7]
    want, jdec = paged_serving._serve(paged_serving._reference(XLSTM),
                                      prompts, budgets, paged=True)
    got, dec = paged_serving._serve(paged_serving._port(XLSTM), prompts,
                                    budgets, paged=True)
    dense, _ = paged_serving._serve(paged_serving._port(XLSTM), prompts,
                                    budgets, paged=False)
    assert got == want == dense
    assert dec.pool.stats == jdec.pool.stats
    assert dec.pool.stats["allocated"] == dec.pool.resident == 0
    dec.pool.check_invariants()


@pytest.mark.parametrize("arch", [XLSTM])
def test_prefix_hit_prefills_only_the_suffix(arch):
    paged_serving.test_prefix_hit_prefills_only_the_suffix(arch)


def _requests(req_cls, lens, budgets, seed):
    rng = np.random.default_rng(seed)
    return [req_cls(rid=i, tokens=rng.integers(0, 256, (L,)).astype(np.int32),
                    max_new_tokens=b)
            for i, (L, b) in enumerate(zip(lens, budgets))]


def _engines(eng, model, params):
    return (eng.PrefillEngine(model, params, min_bucket=32,
                              max_bucket=MAX_BUCKET),
            eng.DecodeEngine(model, params, SLOTS, CAPACITY,
                             block_size=BLOCK))


def _alternating(eng, model, params, reqs):
    """One bucketed prefill of the whole batch, then admit waves, each
    drained."""
    peng, dec = _engines(eng, model, params)
    lengths = np.array([len(r.tokens) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), int(lengths.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.tokens)] = r.tokens
    first, caches, _ = peng.prefill(toks, lengths)
    pending = [(r, int(first[i]),
                eng.trim_request_cache(caches, i, int(lengths[i])),
                int(lengths[i])) for i, r in enumerate(reqs)]
    while pending:
        n = dec.admit_many(pending)
        pending = pending[n:]
        dec.run_until_drained()
    return {rid: r.output_tokens for rid, r in dec.outputs.items()}


def _continuous(eng, model, params, reqs):
    peng, dec = _engines(eng, model, params)
    sched = eng.RegionScheduler(peng, dec, max_prefill_batch=3)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert not sched.has_work and dec.truncations == 0
    return {rid: r.output_tokens for rid, r in dec.outputs.items()}


def test_scheduler_matches_alternating_loop_and_reference():
    """Mixed buckets, a chunked prompt of 150 tokens, more requests than
    slots: the port's continuous scheduler, its alternating loop and the
    reference's scheduler emit the same tokens."""
    jcfg, tcfg, jparams, tparams = _setup()
    lens, budgets = [24, 40, 150, 33, 90, 16, 60], [7, 12, 5, 9, 3, 8, 10]
    want = _continuous(jeng, JaxModel(jcfg), jparams,
                       _requests(JaxRequest, lens, budgets, 2))
    model = Model(tcfg)
    got = _continuous(teng, model, tparams, _requests(Request, lens, budgets,
                                                      2))
    alt = _alternating(teng, model, tparams, _requests(Request, lens, budgets,
                                                       2))
    assert sorted(got) == list(range(len(lens)))
    assert got == alt == want
    assert all(len(got[i]) == 1 + b for i, b in enumerate(budgets))


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_streams_match_reference(paged):
    """``spec_k`` 2 over repeated phrases, dense and paged: the reference's
    streams, verify rounds and accepted tokens (more than one a round)."""
    jcfg, tcfg, jparams, tparams = _setup()
    want = spec_parity._scheduled((jeng, JaxModel(jcfg, use_kernels=False),
                                   jparams, JaxRequest), paged)
    got = spec_parity._scheduled((teng, Model(tcfg), tparams, Request), paged)
    assert got[:3] == want[:3]
    assert got[2] > got[1] > 0


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (L,)).astype(np.int32) for L in lens]


def _deploy(dep, req_cls, batches, regions=1):
    reqs, out = [], {}
    for batch in batches:
        rs = [req_cls(rid=i, tokens=t.copy(), max_new_tokens=b,
                      home=dep.pd_names[i % regions])
              for i, t, b in batch]
        out.update(dep.submit_batch(rs))
        reqs += rs
    return reqs, out


def _same_requests(jreqs, jout, reqs, out):
    for jr, r in zip(jreqs, reqs):
        jpin = None if jr.device_pin is None else jr.device_pin.cached_len
        pin = None if r.device_pin is None else r.device_pin.cached_len
        assert (r.home, r.route, r.cached_tokens, pin, r.kv_bytes,
                r.kv_bytes_raw) == (jr.home, jr.route, jr.cached_tokens, jpin,
                                    jr.kv_bytes, jr.kv_bytes_raw), r.rid
        assert out[r.rid].output_tokens == jout[jr.rid].output_tokens, r.rid
        assert len(out[r.rid].output_tokens) == 1 + r.max_new_tokens


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
def test_paged_deployment_matches_reference(wire):
    """A first turn (a 64-token prompt, page-aligned, and another), then
    its extension, which pins the registered 64-token state snapshot and
    prefills only its 30-token suffix.  ``wire``: a low threshold offloads
    the first turn, whose caches ship as they are."""
    jcfg, tcfg, jparams, tparams = _setup()
    prefix, suffix, other = _prompts([64, 30, 20], seed=11)
    batches = [[(0, prefix, 4), (1, other, 5)],
               [(2, np.concatenate([prefix, suffix]), 6)]]
    kw = dict(paged_serving.DEP, threshold=40 if wire else 4096,
              wire_compression=wire)
    jdep = JaxDeployment(JaxModel(jcfg, use_kernels=False), jparams,
                         JaxDeploymentConfig(**kw))
    dep = CrossDCDeployment(Model(tcfg), tparams, DeploymentConfig(**kw))
    jreqs, jout = _deploy(jdep, JaxRequest, batches)
    before = dep.pd_prefill.tokens_prefilled
    reqs, out = _deploy(dep, Request, batches)
    _same_requests(jreqs, jout, reqs, out)
    assert reqs[2].device_pin.cached_len == 64
    local = sum(len(r.tokens) for r in reqs[:2] if r.route == "pd")
    assert dep.pd_prefill.tokens_prefilled - before == local + 30
    assert {r.route for r in reqs[:2]} == ({"prfaas", "pd"} if wire
                                           else {"pd"})
    m, jm = dep.metrics(), jdep.metrics()
    region, jregion = m["clusters"]["pd"], jm["clusters"]["pd"]
    assert region["pool"] == jregion["pool"]
    assert region["resident_kv_bytes"] == jregion["resident_kv_bytes"]
    assert region["page_fail_retires"] == 0
    pool = region["pool"]
    assert pool["allocated"] == (pool["freed"] + pool["evicted"]
                                 + pool["resident"])
    if wire:
        assert dep.decoders["pd"].wire_admission
        assert dep.measured_compression() == jdep.measured_compression() \
            == 1.0
        assert all(r.kv_bytes == r.kv_bytes_raw > 0 for r in reqs
                   if r.route == "prfaas")


@pytest.mark.parametrize("regions", [1, 2])
def test_dense_deployment_matches_reference(regions):
    """Int8 wire compression on, a 150-token chunked prompt, a session
    extension that hits the prefix cache; one region, or two joined by a
    PD mesh link."""
    jcfg, tcfg, jparams, tparams = _setup()
    base = _prompts([30, 150, 90, 12], seed=0)
    ext = np.concatenate([base[2], _prompts([30], seed=1)[0]])
    batches = [list(zip(range(4), base, [6, 5, 7, 4])),
               [(4, ext, 5), (5, _prompts([70], seed=2)[0], 6)]]
    kw = dict(threshold=64, link_gbps=100.0, decode_slots=4, capacity=256,
              decode_block_size=4, min_prefill_bucket=32,
              max_prefill_bucket=64, wire_compression=True,
              adapt_thresholds=False, pd_clusters=regions,
              pd_mesh_gbps=100.0 if regions > 1 else 0.0)
    jdep = JaxDeployment(JaxModel(jcfg), jparams, JaxDeploymentConfig(**kw))
    dep = CrossDCDeployment(Model(tcfg), tparams, DeploymentConfig(**kw))
    jreqs, jout = _deploy(jdep, JaxRequest, batches, regions)
    reqs, out = _deploy(dep, Request, batches, regions)
    _same_requests(jreqs, jout, reqs, out)
    assert {r.route for r in reqs} == {"prfaas"} | set(dep.pd_names)
    assert any(r.cached_tokens > 0 for r in reqs)
    assert dep.measured_compression() == jdep.measured_compression() == 1.0
    assert dep.topology.sent_bytes == pytest.approx(jdep.topology.sent_bytes,
                                                    rel=1e-9)


def test_launcher_serves_every_request_on_cpu():
    args = serve.build_parser().parse_args(
        ["--arch", XLSTM, "--smoke", "--device", "cpu",
         "--requests", "6", "--wire-compression", "--freeze-thresholds",
         "--max-new-tokens", "3", "--max-prefill-bucket", "128",
         "--spec-k", "2", "--spec-ngram", "1"])
    report = serve.run_serve(args)
    reqs = report["_requests"]
    m = report["deployment"]
    assert m["requests"] == len(reqs) == 6
    assert {r.route for r in reqs} == {"pd", "prfaas"}
    assert m["kv_bytes_total"] > 0 and m["wire_compression"] == 1.0
    assert m["truncations"] == 0
