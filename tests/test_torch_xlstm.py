"""xLSTM in the port against the reference, on smoke ``xlstm-350m``
(float32, 2 [mLSTM, sLSTM] pairs after the smoke reduction, the
reference's params carried over):

  * the parameter tree: the reference's keys, shapes and dtypes (mLSTM's
    ``i_proj`` / ``f_proj``; sLSTM's ``w_gates``, ``r_gates``, float32
    ``b_gates`` and ``g_norm``, no q/k/v), float32 and bf16;
  * prefill logits and caches of a padded batch (mLSTM's state of dv + 1
    columns through the GLA scan's plain version, sLSTM's four leaves
    held at padded positions);
  * chunked prefill against the full prefill and the reference's chunk
    caches;
  * two decode steps against the reference's, and the first against a
    full prefill's last logits;
  * ``init_cache``, the paged layout's state slots, the zero request
    payload and ``prepare_decode_caches``, leaf by leaf, exactly;
  * a speculative verify's rollback of all four sLSTM leaves and mLSTM's
    ``state`` and ``conv``, dense and over paged slots (tables of zero
    columns): exactly the accepted steps' caches, and the reference's
    commit;
  * the wire pytree of an offloaded request, byte for byte: every leaf
    ships as it is (the reference's wire quantizes only k / v / ckv /
    kpe), so the compression ratio is 1.

The serving paths are ``tests/test_torch_xlstm_serving.py``.  Tolerances
as ``tests/test_torch_model.py``: logits 1e-4, caches 3e-4 abs / 1e-3
rel; layouts, the rollback and the wire bytes are exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, assert_trees_identical,
                           configs, flatten, shared_params, to_jax,
                           to_torch)
from repro.models import Model as JaxModel
from repro.models import paged as jpaged
from repro.models import prepare_decode_caches as jax_prepare
from repro.models.kvcache import quantize_cache_for_wire as jax_quantize
from repro.models.kvcache import wire_compression_ratio as jax_ratio
from repro.serving import engine as jeng
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models import paged as tpaged
from repro_torch.models.kvcache import (encode_request_for_wire,
                                        quantize_cache_for_wire,
                                        wire_compression_ratio)
from repro_torch.models.tree import tree_map
from repro_torch.params import init_params
from repro_torch.serving.engine import PrefillEngine, trim_request_cache

torch.set_num_threads(1)
ARCH = "xlstm-350m"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = configs(arch=ARCH)
    assert [b.mixer.kind for g in tcfg.groups for b in g.blocks] == \
        ["mlstm", "slstm"]
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _spec(tree):
    """[(path, shape, dtype name)] of a tree of either framework."""
    return [(p, a.shape, str(a.dtype)) for p, a in flatten(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype):
    jcfg, tcfg = configs(arch=ARCH)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _spec(got) == [(p, a.shape, str(np.dtype(a.dtype)))
                          for p, a in flatten(jax.tree.map(
                              lambda s: np.zeros(s.shape, s.dtype), want))]


def test_prefill_logits_and_caches_match_reference():
    """A padded batch of 97, 40 and 70 tokens: logits, mLSTM's (dk, dv +
    1) state and conv window, and sLSTM's c / n / m / h at each row's
    length."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 3, 97, 0), np.array([97, 40, 70], np.int32)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)
    assert tc["groups"][0]["b0"]["state"].shape[-1] == 17      # dv + 1
    assert sorted(tc["groups"][0]["b1"]["state"]) == ["c", "h", "m", "n"]


def test_chunked_prefill_matches_full_and_reference():
    """Four 32-token chunks of prompts of 128 and 90 tokens (the second's
    last chunk empty): the last logits equal the full prefill's, the chunk
    caches the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 2, 128, 2), np.array([128, 90], np.int32)
    model, jmodel = Model(tcfg), JaxModel(jcfg)
    full, fc = model.prefill(tparams, {"tokens": torch.from_numpy(toks).long(),
                                       "lengths": torch.from_numpy(lens)})
    C, tc, jc = 32, None, None
    last = torch.zeros((2, 1, tcfg.d_model))
    for i in range(4):
        pos = np.repeat(np.arange(i * C, (i + 1) * C, dtype=np.int32)[None],
                        2, 0)
        clen = np.clip(lens - i * C, 0, C).astype(np.int32)
        chunk = toks[:, i * C:(i + 1) * C]
        h, tc = model.prefill_chunk(tparams, {
            "tokens": torch.from_numpy(chunk).long(),
            "positions": torch.from_numpy(pos),
            "lengths": torch.from_numpy(clen)}, tc)
        _, jc = jmodel.prefill_chunk(jparams, {
            "tokens": jnp.asarray(chunk), "positions": jnp.asarray(pos),
            "lengths": jnp.asarray(clen)}, jc)
        for b in range(2):
            if i * C <= lens[b] - 1 < (i + 1) * C:
                last[b, 0] = h[b, lens[b] - 1 - i * C]
    logits = model.last_logits(tparams, last, torch.ones(2, dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)
    assert_trees_close(fc, tc, **CACHE_TOL)


def test_decode_steps_match_reference():
    """Prefill 63 tokens and decode the 64th: the logits equal the full
    prefill's last logits; then two steps against the reference's decode,
    logits and every cache leaf."""
    jcfg, tcfg, jparams, tparams = _setup()
    S = 64
    toks = _tokens(tcfg, 2, S, 1)
    model, jmodel = Model(tcfg), JaxModel(jcfg)
    full, _ = model.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    _, caches = model.prefill(tparams, {
        "tokens": torch.from_numpy(toks[:, :S - 1]).long()})
    dc = prepare_decode_caches(tcfg, caches, S + 8)
    lens = torch.full((2,), S - 1, dtype=torch.int32)
    lg, dc = model.decode_step(tparams, torch.from_numpy(toks[:, -1]).long(),
                               dc, lens)
    np.testing.assert_allclose(torch.log_softmax(lg, -1).numpy(),
                               torch.log_softmax(full, -1).numpy(),
                               atol=5e-5, rtol=0)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S - 1])})
    jdc = jax_prepare(jcfg, jc, S + 8)
    jlg, jdc = jmodel.decode_step(jparams, jnp.asarray(toks[:, -1]), jdc,
                                  jnp.asarray(lens.numpy()))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    nxt = jnp.argmax(jlg, -1).astype(jnp.int32)
    jlg, jdc = jmodel.decode_step(jparams, nxt, jdc,
                                  jnp.asarray(lens.numpy()) + 1)
    lg, dc = model.decode_step(tparams, torch.from_numpy(np.array(nxt))
                               .long(), dc, lens + 1)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert_trees_close(jdc, dc, **CACHE_TOL)


def test_cache_layouts_match_reference():
    """Dense decode buffers, the paged layout (tables of zero columns, no
    page bytes) and its per-slot state, the zero request payload, and the
    decode placement of shipped prefill caches: the reference's paths,
    shapes, dtypes and values, exactly."""
    jcfg, tcfg, jparams, _ = _setup()
    assert_trees_identical(JaxModel(jcfg).init_cache(3, 96),
                           Model(tcfg).init_cache(3, 96, "cpu"))
    lay = jpaged.paged_layout(jcfg, 96, 16, 12)
    tlay = tpaged.paged_layout(tcfg, 96, 16, 12)
    assert dataclasses.asdict(tlay) == dataclasses.asdict(lay)
    assert (tlay.seq_cols, tlay.ring_cols) == (0, 0)
    assert tpaged.page_bytes(tcfg, tlay) == 0
    assert_trees_identical(jpaged.init_paged_cache(jcfg, 3, lay),
                           tpaged.init_paged_cache(tcfg, 3, tlay, "cpu"))
    assert_trees_identical(jpaged.zero_request_payload(jcfg, 32),
                           tpaged.zero_request_payload(tcfg, 32, "cpu"))
    toks = _tokens(tcfg, 2, 40, 3)
    _, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)})
    assert_trees_identical(jax_prepare(jcfg, jc, 128),
                           prepare_decode_caches(tcfg, to_torch(jc), 128))


def _random(shape, rng):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _stepped(model, params, seq, caches, lens, accept, **kw):
    """Each slot's caches after its accepted steps alone (plain decode
    steps from ``caches``)."""
    out = []
    with torch.no_grad():
        for b in range(len(accept)):
            c = tree_map(lambda x: x.clone(), caches)
            for j in range(accept[b] + 1):
                _, c = model.decode_step(
                    params, torch.from_numpy(seq[:, j]).long(), c,
                    torch.from_numpy(lens) + j, **kw)
            out.append(c)
    return out


@pytest.mark.parametrize("accept", [(0, 1, 2, 0), (2, 2, 2, 2)],
                         ids=["partial", "all"])
def test_dense_rollback_matches_reference(accept):
    """A verify of 3 positions over random dense caches, then a commit:
    logits and caches equal the reference's, and each slot's leaves (the
    four sLSTM ones, mLSTM's state and conv) equal those of its accepted
    steps alone, bit for bit."""
    jcfg, tcfg, jparams, tparams = _setup()
    model, jmodel = Model(tcfg), JaxModel(jcfg, use_kernels=False)
    rng = np.random.default_rng(4)
    caches = tree_map(lambda x: torch.from_numpy(_random(tuple(x.shape), rng)),
                      model.init_cache(4, 64, "cpu"))
    lens = np.array([5, 20, 33, 61], np.int32)
    seq = rng.integers(0, tcfg.vocab_size, (4, 3)).astype(np.int32)
    acc = np.array(accept, np.int32)
    jlg, jver, jpend = jax.jit(jmodel.decode_verify)(
        jparams, jnp.asarray(seq), tree_map(lambda x: jnp.asarray(x.numpy()),
                                            caches), jnp.asarray(lens))
    jcom = jax.jit(jmodel.commit_verify, static_argnums=4)(
        jver, jpend, jnp.asarray(lens), jnp.asarray(acc), 3)
    stepped = _stepped(model, tparams, seq, caches, lens, acc)
    with torch.no_grad():
        lg, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(),
            tree_map(lambda x: x.clone(), caches), torch.from_numpy(lens))
        assert sorted(pend["snaps"][0]["b1"]["state"]) == ["c", "h", "m",
                                                           "n"]
        com = model.commit_verify(ver, pend, torch.from_numpy(acc))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert_trees_close(jcom, com, **CACHE_TOL)
    assert len(flatten(com)) == 6
    for b in range(4):
        for (path, got), (_, want) in zip(flatten(com), flatten(stepped[b])):
            np.testing.assert_array_equal(got[:, b], want[:, b], path)


def test_paged_rollback_matches_reference():
    """The same over the paged layout of an attention-free model: per-slot
    state leaves, tables of zero columns; accepts (2, 0, 1)."""
    jcfg, tcfg, jparams, tparams = _setup()
    capacity, slots, pages, T = 128, 3, 12, 16
    lay = jpaged.paged_layout(jcfg, capacity, T, pages)
    rng = np.random.default_rng(5)
    pools = jax.tree.map(lambda x: _random(x.shape, rng),
                         jpaged.init_paged_cache(jcfg, slots, lay))
    lens = np.array([62, 90, 7], np.int32)
    seq = rng.integers(0, tcfg.vocab_size, (slots, 3)).astype(np.int32)
    acc = np.array([2, 0, 1], np.int32)
    kw = dict(page_tokens=T, capacity=capacity)
    jm = JaxModel(jcfg, use_kernels=False)
    jtables = {"seq": jnp.zeros((slots, 0), jnp.int32),
               "ring": jnp.zeros((slots, 0), jnp.int32)}
    jlg, jver, jpend = jm.decode_verify(
        jparams, jnp.asarray(seq), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(lens), tables=jtables, **kw)
    jcom = jm.commit_verify(jver, jpend, jnp.asarray(lens), jnp.asarray(acc),
                            3, tables=jtables, **kw)
    ttables = {"seq": torch.zeros((slots, 0), dtype=torch.int32),
               "ring": torch.zeros((slots, 0), dtype=torch.int32)}
    model = Model(tcfg)
    stepped = _stepped(model, tparams, seq, to_torch(pools), lens, acc,
                       tables=ttables, **kw)
    with torch.no_grad():
        lg, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(), to_torch(pools),
            torch.from_numpy(lens), tables=ttables, **kw)
        com = model.commit_verify(ver, pend, torch.from_numpy(acc))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert_trees_close(jcom, com, **CACHE_TOL)
    for b in range(slots):
        for (path, got), (_, want) in zip(flatten(com), flatten(stepped[b])):
            np.testing.assert_array_equal(got[:, b], want[:, b], path)


@pytest.mark.parametrize("max_bucket", [None, 32], ids=["bucket", "chunks"])
def test_wire_pytree_matches_reference(max_bucket):
    """An offloaded request of a padded prefill batch (bucketed, or three
    32-token chunks), encoded in place for the wire: the reference's trim +
    wire pytree byte for byte, every leaf shipped as it is (float32 states,
    the conv window), so wire bytes = raw bytes and the ratio is 1, as
    the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 3, 70, 6), np.array([70, 33, 1], np.int32)
    _, caches, _ = PrefillEngine(Model(tcfg), tparams, min_bucket=32,
                                 max_bucket=max_bucket).prefill(toks, lens)
    for idx, L in enumerate(lens.tolist()):
        wire, nbytes, raw = encode_request_for_wire(caches, idx, L)
        trimmed = trim_request_cache(caches, idx, L)
        jtrim = jeng.trim_request_cache(to_jax(caches), idx, L)
        jwire, jbytes = jax_quantize(jtrim, use_kernel=False)
        assert nbytes == raw == jbytes
        assert_trees_identical(jwire, wire)
        assert_trees_identical(jtrim, trimmed)
        assert quantize_cache_for_wire(trimmed)[1] == jbytes
        assert wire_compression_ratio(trimmed) == jax_ratio(jtrim) == 1.0
