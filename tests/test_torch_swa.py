"""Sliding-window attention in the port against the reference, on smoke
``h2o-danube-1.8b`` (float32, window 64 after the smoke reduction, the
reference's params carried over):

  * prefill logits and caches of a padded batch whose rows cross the
    window;
  * a decode step past the window over the ring equals a full prefill's
    last logits (the reference's ``test_swa_ring_buffer_beyond_window``),
    and the reference's decode, logits and ring leaves;
  * chunked prefill with the window across chunk boundaries equals the
    full prefill, and the reference's chunk caches;
  * ``prepare_decode_caches`` ring placement equals the reference's leaf by
    leaf, for prompts shorter than, equal to and past the window, and
    capacities below and above it;
  * a speculative verify's ring save and restore over dense and paged
    rings: after a commit the rings equal the accepted steps' rings, and
    the reference's commit.

The serving paths (paged = dense, resume from the ring snapshot, wire
bytes, speculative streams) are in ``tests/test_torch_swa_serving.py``,
``tests/test_torch_paged.py``, ``tests/test_torch_spec_decode.py``,
``tests/test_torch_spec_parity.py`` and ``tests/test_torch_wire_encode.py``.

Tolerances as ``tests/test_torch_model.py``: logits 1e-4, caches 3e-4 abs
/ 1e-3 rel; the ring placement and the rollback are exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, configs, flatten,
                           shared_params, to_torch)
from repro.models import Model as JaxModel
from repro.models import paged as jpaged
from repro.models import prepare_decode_caches as jax_prepare
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models import paged as tpaged
from repro_torch.models.tree import tree_map

torch.set_num_threads(1)
ARCH = "h2o-danube-1.8b"
W = 64
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = configs(arch=ARCH)
    assert {b.mixer.window for g in tcfg.groups for b in g.blocks} == {W}
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_logits_and_caches_match_reference():
    """A padded batch of 97, 40 and 70 tokens: the flash path's window
    mask (the kernel's plain version here) gives the reference's logits
    and K/V."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 3, 97, 0), np.array([97, 40, 70], np.int32)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)


@pytest.mark.parametrize("S", [97, 64, 150])
def test_decode_past_the_window_equals_full_prefill(S):
    """Prefill S - 1 tokens, ring-place them (capacity S + 8 > window) and
    decode the last: the logits equal the full prefill's last logits (the
    ring holds exactly the window, in ring order), and the reference's
    decode step, two steps deep, ring leaves included."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks = _tokens(tcfg, 1, S, 1)
    model, jmodel = Model(tcfg), JaxModel(jcfg)
    full, _ = model.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    _, caches = model.prefill(tparams, {
        "tokens": torch.from_numpy(toks[:, :S - 1]).long()})
    dc = prepare_decode_caches(tcfg, caches, S + 8)
    assert {tuple(x.shape[2:3]) for _, x in flatten(dc)} == {(W,)}
    lens = torch.full((1,), S - 1, dtype=torch.int32)
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


def test_chunked_prefill_crosses_the_window():
    """Four 32-token chunks of prompts of 128 and 90 tokens: each chunk
    keeps the whole prior and masks it by the window, so the window
    straddles chunk boundaries; the last logits equal the full prefill's
    and the chunk caches the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 2, 128, 2), np.array([128, 90], np.int32)
    model, jmodel = Model(tcfg), JaxModel(jcfg)
    full, _ = model.prefill(tparams, {"tokens": torch.from_numpy(toks).long(),
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


@pytest.mark.parametrize("S,capacity", [(12, 40), (30, 128), (64, 128),
                                        (97, 200), (150, 160), (97, 64)])
def test_ring_placement_matches_reference(S, capacity):
    """The decode cluster's placement of shipped prefill caches: the last
    ``window`` rows at ring row ``pos % window`` where the capacity is
    above the window, zero-padded to capacity where it is not; leaf by
    leaf, exactly the reference's."""
    jcfg, tcfg, jparams, _ = _setup()
    toks = _tokens(tcfg, 2, S, 3)
    _, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks)})
    want = jax_prepare(jcfg, jc, capacity)
    got = prepare_decode_caches(tcfg, to_torch(jc), capacity)
    assert_trees_close(want, got, atol=0, rtol=0)
    rows = W if capacity > W else max(capacity, S)
    assert {a.shape[2] for _, a in flatten(got)} == {rows}


def _random(shape, rng):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("accept", [(0, 1, 2, 0), (2, 2, 2, 2)],
                         ids=["partial", "all"])
def test_dense_ring_rollback_matches_reference(accept):
    """A verify of 3 positions over random dense rings, lengths before,
    at and past the window (one ring wrapping inside the verify), then a
    commit: logits and rings equal the reference's, and each slot's ring
    equals that of its accepted steps alone (rejected rows put back)."""
    jcfg, tcfg, jparams, tparams = _setup()
    model, jmodel = Model(tcfg), JaxModel(jcfg, use_kernels=False)
    rng = np.random.default_rng(4)
    caches = tree_map(lambda x: torch.from_numpy(_random(tuple(x.shape), rng)),
                      model.init_cache(4, 256, "cpu"))
    lens = np.array([5, 63, 62, 200], np.int32)
    seq = rng.integers(0, tcfg.vocab_size, (4, 3)).astype(np.int32)
    acc = np.array(accept, np.int32)
    jlg, jver, jpend = jax.jit(jmodel.decode_verify)(
        jparams, jnp.asarray(seq), tree_map(lambda x: jnp.asarray(x.numpy()),
                                            caches), jnp.asarray(lens))
    jcom = jax.jit(jmodel.commit_verify, static_argnums=4)(
        jver, jpend, jnp.asarray(lens), jnp.asarray(acc), 3)
    with torch.no_grad():
        stepped = []
        for b in range(4):
            c = tree_map(lambda x: x.clone(), caches)
            for j in range(acc[b] + 1):
                _, c = model.decode_step(
                    tparams, torch.from_numpy(seq[:, j]).long(), c,
                    torch.from_numpy(lens) + j)
            stepped.append(c)
        lg, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(),
            tree_map(lambda x: x.clone(), caches), torch.from_numpy(lens))
        com = model.commit_verify(ver, pend, torch.from_numpy(acc))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert_trees_close(jcom, com, **CACHE_TOL)
    for b in range(4):
        for (path, got), (_, want) in zip(flatten(com), flatten(stepped[b])):
            np.testing.assert_array_equal(got[:, b], want[:, b], path)


def test_paged_ring_rollback_matches_reference():
    """The same over paged rings: random pools, each slot's ring table of
    64 / 16 pages (the last slot inactive on the sink), a verify of 3
    positions and a commit of accepts (2, 0, 1): logits and every page but
    the sink equal the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    capacity, slots, pages, T = 128, 3, 12, 16
    lay = jpaged.paged_layout(jcfg, capacity, T, pages)
    tlay = tpaged.paged_layout(tcfg, capacity, T, pages)
    assert (tlay.ring_cols, tlay.ring_tokens, tlay.seq_cols) == \
        (lay.ring_cols, lay.ring_tokens, lay.seq_cols) == (4, W, 0)
    rng = np.random.default_rng(5)
    pools = {"groups": [
        {key: {name: _random(leaf.shape, rng) for name, leaf in blk.items()}
         for key, blk in g.items()}
        for g in jpaged.init_paged_cache(jcfg, slots, lay)["groups"]]}
    ring = np.full((slots, lay.ring_cols), lay.sink, np.int32)
    ring[0] = [5, 2, 9, 1]
    ring[1] = [0, 7, 3, 11]
    lens = np.array([62, 90, 0], np.int32)
    seq = rng.integers(0, tcfg.vocab_size, (slots, 3)).astype(np.int32)
    acc = np.array([2, 0, 1], np.int32)
    kw = dict(page_tokens=T, capacity=capacity)
    jm = JaxModel(jcfg, use_kernels=False)
    jtables = {"seq": jnp.zeros((slots, 0), jnp.int32),
               "ring": jnp.asarray(ring)}
    jlg, jver, jpend = jm.decode_verify(
        jparams, jnp.asarray(seq), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(lens), tables=jtables, **kw)
    jcom = jm.commit_verify(jver, jpend, jnp.asarray(lens), jnp.asarray(acc),
                            3, tables=jtables, **kw)
    ttables = {"seq": torch.zeros((slots, 0), dtype=torch.int32),
               "ring": torch.from_numpy(ring)}
    model = Model(tcfg)
    with torch.no_grad():
        lg, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(), to_torch(pools),
            torch.from_numpy(lens), tables=ttables, **kw)
        com = model.commit_verify(ver, pend, torch.from_numpy(acc))
    np.testing.assert_allclose(lg[:2].numpy(), np.asarray(jlg)[:2],
                               **LOGIT_TOL)
    for (pa, a), (pb, b) in zip(flatten(jcom), flatten(com)):
        assert pa == pb
        np.testing.assert_allclose(b[:, :, :lay.sink], a[:, :, :lay.sink],
                                   err_msg=pa, **CACHE_TOL)
