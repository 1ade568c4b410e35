"""The port's paged KV against the reference's, on the CPU: the plain paged
kernels, paged decode steps on smoke ``mistral-nemo-12b`` (GQA), smoke
``kimi-linear-1t`` (MLA) and smoke ``zamba2-1.2b`` (Mamba2 + a shared MHA
block), paged admission and the page pool.

Inputs are made with numpy from a seed and given to both frameworks; the
reference's params are carried over with ``from_numpy_tree``.  The
reference runs as its own tests run it on the CPU: Pallas kernels in
interpret mode, or its jnp oracles (``repro.kernels.ref``).

Tolerances: kernels in float32 2e-5 abs and rel (sums in other orders);
logits 1e-4 / 1e-4 and pools 3e-4 / 1e-3 (two stacked layers of float32
sums in other orders); paged admission byte-identical.  The CUDA
kernels themselves are checked on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_identical, configs, flatten,
                           shared_params, to_torch)
from repro.kernels import ref as jref
from repro.kernels.paged_decode_attn import \
    paged_decode_attention as jax_paged_decode
from repro.kernels.paged_prefill_attn import \
    paged_prefill_attention as jax_paged_prefill
from repro.models import Model as JaxModel
from repro.models import paged as jpaged
from repro.models.kvcache import quantize_cache_for_wire as jax_quantize
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.core.blockpool import BlockPool
from repro_torch.core.prefix_cache import HybridPrefixCache
from repro_torch.kernels import build, ops
from repro_torch.kernels.paged_decode_attn import paged_decode_attention
from repro_torch.kernels.paged_prefill_attn import paged_prefill_attention
from repro_torch.models import Model
from repro_torch.models.kvcache import dequantize_cache_from_wire
from repro_torch.serving import engine as teng
from repro_torch.serving.api import PagePin, Request

torch.set_num_threads(1)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)
GQA, MLA, HYBRID = "mistral-nemo-12b", "kimi-linear-1t", "zamba2-1.2b"
PAGE = 16


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _tables(r, B, N, P):
    """Distinct physical pages per row (permutation-style tables)."""
    return np.stack([r.choice(P, size=N, replace=False)
                     for _ in range(B)]).astype(np.int32)


# ------------------------------------------------------------ plain kernels


@pytest.mark.parametrize("B,Hq,Hkv,T,N,Dk,Dv,window", [
    (1, 4, 4, 16, 8, 64, 64, 0),        # MHA
    (3, 8, 2, 16, 5, 64, 64, 0),        # GQA
    (2, 8, 1, 32, 4, 128, 128, 0),      # MQA, bigger pages
    (2, 4, 4, 8, 7, 32, 32, 0),         # small pages
    (2, 8, 1, 16, 6, 48, 32, 0),        # absorbed-MLA form: Dk != Dv
    (3, 4, 2, 16, 6, 32, 32, 24),       # sliding window
])
def test_paged_decode_plain_matches_reference(B, Hq, Hkv, T, N, Dk, Dv,
                                              window):
    r = np.random.default_rng(7)
    P = 2 * N * B + 1
    kp = r.standard_normal((Hkv, P, T, Dk)).astype(np.float32)
    vp = r.standard_normal((Hkv, P, T, Dv)).astype(np.float32)
    tables = _tables(r, B, N, P)
    lengths = r.integers(1, N * T + 1, size=B).astype(np.int32)
    q = r.standard_normal((B, Hq, Dk)).astype(np.float32)
    args = (q, kp, vp, tables, lengths)
    got = ops.paged_decode_attention(*map(torch.from_numpy, args),
                                     window=window)
    pallas = jax_paged_decode(*map(jnp.asarray, args), window=window,
                              interpret=True)
    oracle = jref.paged_decode_attention_ref(*map(jnp.asarray, args),
                                             window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


def test_paged_decode_plain_ignores_garbage_past_lengths():
    """Sink and tail rows past each length hold NaN: the plain version
    selects them away, and equals its output over zeroed garbage."""
    r = np.random.default_rng(8)
    B, Hq, Hkv, T, N, D = 2, 4, 2, 16, 4, 32
    P = B * N + 1
    kp = r.standard_normal((Hkv, P, T, D)).astype(np.float32)
    vp = r.standard_normal((Hkv, P, T, D)).astype(np.float32)
    lengths = np.array([37, 16], np.int32)
    tables = np.full((B, N), P - 1, np.int32)            # sink past the end
    tables[0, :3] = [4, 1, 6]
    tables[1, :1] = [3]
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    clean_k, clean_v = kp.copy(), vp.copy()
    for pool in (kp, vp):
        pool[:, P - 1] = np.nan
        pool[:, 6, 37 % T:] = np.nan
    for pool in (clean_k, clean_v):
        pool[:, P - 1] = 0.0
        pool[:, 6, 37 % T:] = 0.0
    got = ops.paged_decode_attention(*map(torch.from_numpy,
                                          (q, kp, vp, tables, lengths)))
    want = ops.paged_decode_attention(*map(
        torch.from_numpy, (q, clean_k, clean_v, tables, lengths)))
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Hq,Hkv,C,T,N,Ssuf,D", [
    (2, 4, 2, 16, 16, 3, 16, 32),       # the chunk is the whole suffix
    (1, 8, 2, 32, 8, 5, 80, 16),        # a later chunk of a long suffix
    (2, 4, 1, 24, 16, 2, 40, 32),       # MQA
])
def test_paged_prefill_plain_matches_reference(B, Hq, Hkv, C, T, N, Ssuf, D):
    r = np.random.default_rng(9)
    P = 2 * N * B + 1
    kp = r.standard_normal((Hkv, P, T, D)).astype(np.float32)
    vp = r.standard_normal((Hkv, P, T, D)).astype(np.float32)
    tables = _tables(r, B, N, P)
    q = r.standard_normal((B, Hq, C, D)).astype(np.float32)
    ks = r.standard_normal((B, Hkv, Ssuf, D)).astype(np.float32)
    vs = r.standard_normal((B, Hkv, Ssuf, D)).astype(np.float32)
    args = (q, kp, vp, tables, ks, vs)
    got = ops.paged_prefill_attention(*map(torch.from_numpy, args))
    pallas = jax_paged_prefill(*map(jnp.asarray, args), interpret=True)
    oracle = jref.paged_prefill_attention_ref(*map(jnp.asarray, args))
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)


def test_cpu_tensors_take_the_plain_paged_versions():
    """On the CPU the paged ops run their plain versions (no launch is
    counted); the CUDA wrappers refuse CPU tensors."""
    build.reset_launches()
    pool = torch.randn(2, 5, 4, 8)
    tables = torch.tensor([[0, 3], [1, 2]], dtype=torch.int32)
    lens = torch.tensor([7, 5], dtype=torch.int32)
    q = torch.randn(2, 4, 8)
    qc, ks = torch.randn(2, 4, 3, 8), torch.randn(2, 2, 3, 8)
    ops.paged_decode_attention(q, pool, pool, tables, lens)
    ops.paged_prefill_attention(qc, pool, pool, tables, ks, ks)
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, pool, pool, tables, lens)
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_attention(qc, pool, pool, tables, ks, ks)


@pytest.mark.parametrize("arch", [GQA, MLA, HYBRID])
def test_paged_decode_steps_match_reference(arch):
    """``decode_step`` over random page pools through random tables (the
    last slot inactive on the sink page, one slot past its table): logits,
    and the pools the steps wrote, against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    capacity, slots, pages = 64, 3, 12
    lay = jpaged.paged_layout(jcfg, capacity, PAGE, pages)
    r = np.random.default_rng(3)
    pools = {"groups": [
        {key: {name: (r.standard_normal(leaf.shape) * 0.5).astype(np.float32)
               for name, leaf in blk.items()} for key, blk in g.items()}
        for g in jpaged.init_paged_cache(jcfg, slots, lay)["groups"]]}
    tables = np.full((slots, capacity // PAGE), lay.sink, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :4] = [0, 7, 3, 11]
    lengths = np.array([40, 63, 0], np.int32)     # slot 1 steps off its table
    tokens = r.integers(0, tcfg.vocab_size, slots).astype(np.int32)
    jcache = {"groups": [{k: {n: jnp.asarray(v) for n, v in b.items()}
                          for k, b in g.items()} for g in pools["groups"]]}
    tcache = to_torch(pools)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    kw = dict(page_tokens=PAGE, capacity=capacity)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jlen, tlen = jnp.asarray(lengths), torch.from_numpy(lengths)
    for _ in range(2):
        jl, jcache = jm.decode_step(jparams, jt, jcache, jlen,
                                    tables={"seq": jnp.asarray(tables)}, **kw)
        tl, tcache = tm.decode_step(tparams, tt, tcache, tlen,
                                    tables={"seq": torch.from_numpy(tables)},
                                    **kw)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   **LOGIT_TOL)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.from_numpy(np.array(jt)).long()
        jlen, tlen = jlen + 1, tlen + 1
    # the sink page takes writes of every inactive or overflowing slot in
    # an unspecified order: compare every page but the sink
    def live(tree):
        return [(p, a[..., :lay.sink, :, :] if a.ndim >= 4 else a)
                for p, a in flatten(tree)]
    for (pa, a), (pb, b) in zip(live(jcache), live(tcache)):
        assert pa == pb
        if "state" in pa or "conv" in pa:
            a, b = a[:, :2], b[:, :2]                # active slots only
        np.testing.assert_allclose(b, a, err_msg=pa, **CACHE_TOL)


# ---------------------------------------------------------- paged admission


def _prefilled(arch, L, seed):
    """The reference's trimmed single-request prefill of an L-token prompt:
    (tokens, first token, cache)."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (L,)).astype(np.int32)
    peng = jeng.PrefillEngine(JaxModel(jcfg), jparams, min_bucket=32)
    first, caches, _ = peng.prefill(toks[None], np.array([L]))
    return toks, int(first[0]), jeng.trim_request_cache(caches, 0, L)


@pytest.mark.parametrize("arch", [GQA, MLA, HYBRID])
def test_wire_admitted_pool_byte_identical(arch):
    """An int8 wire payload of the reference's, admitted by the port's
    paged engine (dequantized inside the page write), leaves pools
    byte-identical to the reference's paged admission of the same payload
    and to the port's admission of the eagerly dequantized payload."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks, first, jcache = _prefilled(arch, 45, seed=4)
    jwire, _ = jax_quantize(jcache)
    jdec = jeng.DecodeEngine(JaxModel(jcfg), jparams, 2, 96, paged=True,
                             page_tokens=PAGE)
    jdec.admit_many([(JaxRequest(0, toks, max_new_tokens=4), first, jwire,
                      len(toks))])
    decs = []
    for payload in (to_torch(jwire),
                    dequantize_cache_from_wire(to_torch(jwire))):
        dec = teng.DecodeEngine(Model(tcfg), tparams, 2, 96, paged=True,
                                page_tokens=PAGE)
        dec.admit_many([(Request(0, toks, max_new_tokens=4), first, payload,
                         len(toks))])
        decs.append(dec)
    assert decs[0].table_seq.tolist() == jdec.table_seq.tolist()
    assert_trees_identical(jdec.caches, decs[0].caches)
    assert_trees_identical(jdec.caches, decs[1].caches)


def test_shared_prefix_pages_unchanged_while_other_slots_decode():
    """Two requests resume from one retired request's registered prefix
    pages and decode side by side: the shared pages' bytes never change
    (each slot writes only its own pages or the sink), the pins come back
    at retirement and the pool is conserved."""
    _, tcfg, _, tparams = _setup(GQA)
    pool = BlockPool(48, PAGE, 1)
    cache = HybridPrefixCache(pool, 0, 1, has_full_attn=True,
                              has_linear=False)
    model = Model(tcfg)
    peng = teng.PrefillEngine(model, tparams, min_bucket=32, max_bucket=64)
    dec = teng.DecodeEngine(model, tparams, 3, 256, block_size=4, paged=True,
                            pool=pool, page_tokens=PAGE)
    dec.on_admit = lambda req, L, ids, snap: cache.insert_device(
        [int(t) for t in req.tokens], ids, snap)
    sched = teng.RegionScheduler(peng, dec, max_prefill_batch=2)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, tcfg.vocab_size, (64,)).astype(np.int32)
    sched.submit(Request(rid=0, tokens=prefix, max_new_tokens=3))
    sched.run()

    reqs = []
    for rid in (1, 2):
        toks = np.concatenate([prefix, rng.integers(
            0, tcfg.vocab_size, (9 + rid,)).astype(np.int32)])
        c, ids, snap = cache.match_resume([int(t) for t in toks])
        assert c == 64 and len(ids) == 4
        pool.retain(ids)
        reqs.append(Request(rid=rid, tokens=toks, max_new_tokens=20,
                            device_pin=PagePin(c, ids, snap)))
    shared = torch.as_tensor(reqs[0].device_pin.seq_ids)

    def shared_bytes():
        return [leaf.index_select(2, shared).clone()
                for g in dec.caches["groups"] for blk in g.values()
                for leaf in blk.values()]

    before = shared_bytes()
    for r in reqs:
        sched.submit(r)
    while sched.has_work:
        sched.tick()
        for a, b in zip(before, shared_bytes()):
            assert torch.equal(a, b)
    assert all(len(dec.outputs[r.rid].output_tokens) == 21 for r in reqs)
    pool.check_invariants()
    s = pool.stats
    assert s["allocated"] == s["freed"] + s["evicted"] + pool.resident
    assert all(pool.get(int(b)).ref_count == 0 for b in shared)
