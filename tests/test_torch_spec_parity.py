"""The port's speculative decode against the reference's, on the CPU
(float32 smoke models, the port's seeded weights carried to both sides):

  * ``verify_attention_ref`` equals the reference's (Q 3, GQA groups of 4,
    ragged lengths up to the buffer's end);
  * the n-gram drafter ``_draft`` proposes the reference's tokens on
    random histories with repeats;
  * ``decode_verify`` gives the reference's logits, and after
    ``commit_verify`` with accepts 0, partial and all the reference's
    caches, on kimi-linear-1t (scan verify: KDA state, conv, MLA latents),
    zamba2-1.2b (scan verify: Mamba2, the shared MHA block) and
    mistral-nemo-12b (the one-pass parallel verify, a slot at the buffer's
    end);
  * a dense and a paged scheduler run with ``spec_k=2, spec_ngram=1`` emit
    the reference's streams with its ``verify_rounds``,
    ``accepted_tokens`` and ``stats()``, and a speculative
    ``CrossDCDeployment`` gives the reference's metric keys and
    acceptance.

The port against itself (speculative = plain greedy streams on every
family and layout, the edges, the pool) is ``tests/test_torch_spec_decode.py``.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, configs, drawn_params,
                           to_jax)
from repro.kernels.ref import verify_attention_ref as jax_verify_ref
from repro.models import Model as JaxModel
from repro.serving import CrossDCDeployment as JaxDeployment
from repro.serving import DeploymentConfig as JaxDeploymentConfig
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.kernels.decode_attn import verify_attention_ref
from repro_torch.models import Model
from repro_torch.models.tree import tree_map
from repro_torch.serving import CrossDCDeployment, DeploymentConfig
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)
SLOTS, CAPACITY, BLOCK, MAX_BUCKET, PAGE = 4, 384, 8, 64, 16
SPEC_K = 2
GQA = "mistral-nemo-12b"


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    return jcfg, tcfg, jparams, tparams


def test_verify_attention_ref_matches_reference():
    rng = np.random.default_rng(0)
    B, Hq, Hkv, Q, S, D = 4, 8, 2, 3, 40, 16
    q = rng.standard_normal((B, Hq, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lens = np.array([1, 9, 38, 40], np.int32)      # the last two clamp at S
    want = np.asarray(jax_verify_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens)))
    got = verify_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ngram,k", [(1, 2), (2, 3), (3, 2)])
def test_draft_matches_reference(ngram, k):
    """Histories of a small vocabulary (so suffixes repeat), lengths from 0
    to the buffer's end."""
    rng = np.random.default_rng(ngram)
    B, C = 6, 48
    hist = rng.integers(0, 5, (B, C)).astype(np.int32)
    lens = np.array([0, 1, 5, 20, 46, 47], np.int32)
    me = types.SimpleNamespace(spec_ngram=ngram, spec_k=k)
    want = np.asarray(jeng.DecodeEngine._draft(me, jnp.asarray(hist),
                                               jnp.asarray(lens)))
    got = teng.DecodeEngine._draft(me, torch.from_numpy(hist).long(),
                                   torch.from_numpy(lens).long())
    assert got.numpy().tolist() == want.tolist()


def _random_caches(model, B, S, seed):
    """The port's decode caches of B slots, every leaf drawn from a seed
    (x 0.02, as the reference's verify test)."""
    caches = model.init_cache(B, S, "cpu")
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.from_numpy(
        (rng.standard_normal(tuple(x.shape)) * 0.02).astype(np.float32)),
        caches)


# logits (abs, rel): 1e-5; zamba2's Mamba2 and MHA layers, three steps over
# random states, reassociate its float32 sums a little further (one element
# of 3072 at 1.03e-5).  Caches: ``tests/test_torch_model.py``'s tolerance
# for decode caches against the reference (the conv leaves hold projections
# of those sums: zamba2's up to 4e-5 apart)
LOGIT_TOL = {"kimi-linear-1t": 1e-5, "zamba2-1.2b": 2e-5, GQA: 1e-5,
             "h2o-danube-1.8b": 1e-5}
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", list(LOGIT_TOL))
def test_decode_verify_and_commit_match_reference(arch):
    """The same drafts over the same caches: logits within ``LOGIT_TOL``,
    and the caches after committing accepts (0, 1, 2, 0) within
    ``CACHE_TOL`` of the reference's (rolled-back states included)."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jmodel, model = JaxModel(jcfg, use_kernels=False), Model(tcfg)
    assert model._verify_parallel == jmodel._verify_parallel == (arch == GQA)
    S, q = 64, SPEC_K + 1
    caches = _random_caches(model, SLOTS, S, seed=7)
    jcaches = to_jax(caches)
    lens = np.array([5, 17, 40, S - 2], np.int32)   # the last at the wall
    seq = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (SLOTS, q)).astype(np.int32)
    accept = np.array([0, 1, 2, 0], np.int32)

    jlogits, jver, jpend = jax.jit(jmodel.decode_verify)(
        jparams, jnp.asarray(seq), jcaches, jnp.asarray(lens))
    jcommitted = jax.jit(jmodel.commit_verify, static_argnums=4)(
        jver, jpend, jnp.asarray(lens), jnp.asarray(accept), q)
    with torch.no_grad():
        logits, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(), caches,
            torch.from_numpy(lens))
        committed = model.commit_verify(ver, pend, torch.from_numpy(accept))
    tol = LOGIT_TOL[arch]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=tol, rtol=tol)
    assert_trees_close(jcommitted, committed, **CACHE_TOL)


LENS = [24, 40, 70, 16, 33, 64]
BUDGETS = [30, 44, 25, 38, 27, 21]


def _scheduled(side, paged):
    eng, model, params, req = side
    peng = eng.PrefillEngine(model, params, min_bucket=32,
                             max_bucket=MAX_BUCKET)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                           paged=paged, page_tokens=PAGE, spec_k=SPEC_K,
                           spec_ngram=1)
    sched = eng.RegionScheduler(peng, dec, max_prefill_batch=3)
    rng = np.random.default_rng(0)
    for i, (L, b) in enumerate(zip(LENS, BUDGETS)):
        # the prompt repeats a short phrase, so the drafter lands
        phrase = rng.integers(0, 256, (8,)).astype(np.int32)
        sched.submit(req(rid=i, tokens=np.resize(phrase, L),
                         max_new_tokens=b))
    sched.run()
    assert not sched.has_work
    return ({rid: r.output_tokens for rid, r in dec.outputs.items()},
            dec.verify_rounds, dec.accepted_tokens, sched.stats())


@pytest.mark.parametrize("paged", [False, True])
def test_scheduled_streams_and_acceptance_match_reference(paged):
    jcfg, tcfg, jparams, tparams = _setup(GQA)
    want = _scheduled((jeng, JaxModel(jcfg, use_kernels=False), jparams,
                       JaxRequest), paged)
    got = _scheduled((teng, Model(tcfg), tparams, Request), paged)
    assert got[0] == want[0]
    assert got[1:3] == want[1:3] and got[2] > got[1] > 0
    stats, jstats = got[3], want[3]
    assert set(stats) == set(jstats)
    for k in ("boundaries", "max_admit_wait", "starved_boundaries",
              "tokens_out", "truncations", "accepted_tokens_per_dispatch"):
        assert stats[k] == jstats[k], k
    assert stats["accepted_tokens_per_dispatch"] == got[2] / got[1]


def _keys(tree, prefix=""):
    """The dotted key paths of a metrics dict (dicts only)."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_deployment_metrics_match_reference():
    """A speculative two-region deployment: the reference's metric keys
    (per region and overall), acceptance and tokens."""
    jcfg, tcfg, jparams, tparams = _setup(GQA)
    kw = dict(threshold=64, link_gbps=100.0, decode_slots=4, capacity=256,
              decode_block_size=4, min_prefill_bucket=32,
              max_prefill_bucket=64, adapt_thresholds=False, pd_clusters=2,
              spec_k=SPEC_K, spec_ngram=1)
    rng = np.random.default_rng(1)
    prompts = [np.resize(rng.integers(0, 256, (6,)), L).astype(np.int32)
               for L in (30, 150, 90, 12)]

    def serve(dep, req):
        out = dep.submit_batch([req(rid=i, tokens=t, max_new_tokens=9,
                                    home=dep.pd_names[i % 2])
                                for i, t in enumerate(prompts)])
        return {rid: r.output_tokens for rid, r in out.items()}, dep.metrics()

    jout, jm = serve(JaxDeployment(JaxModel(jcfg), jparams,
                                   JaxDeploymentConfig(**kw)), JaxRequest)
    out, m = serve(CrossDCDeployment(Model(tcfg), tparams,
                                     DeploymentConfig(**kw)), Request)
    assert out == jout
    assert _keys(m) == _keys(jm)
    assert m["accepted_tokens_per_dispatch"] == \
        jm["accepted_tokens_per_dispatch"] > 1.0
    for name in m["clusters"]:
        assert (m["clusters"][name]["accepted_tokens_per_dispatch"]
                == jm["clusters"][name]["accepted_tokens_per_dispatch"])
