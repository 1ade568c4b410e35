"""The port's model against the reference's on smoke ``kimi-linear-1t``
(float32, the reference's params carried over): padded prefill logits and
caches, chunked == full prefill, decode after prefill, and a variant with
the full-width model's low-rank MLA query path.

Tolerances: logits 1e-4 abs / 1e-4 rel; caches 3e-4 abs / 1e-3 rel (two
stacked repeats of KDA + MLA + MoE blocks, float32 sums in other orders).
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
from repro.models import extend_caches as jax_extend
from repro.models import prepare_decode_caches as jax_prepare
from repro_torch.models import Model, extend_caches, prepare_decode_caches
from repro_torch.params import from_numpy_tree, init_params

torch.set_num_threads(1)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _setup(q_rank):
    jcfg, tcfg = configs(q_rank=q_rank)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(params=[0, 24], ids=["q_full", "q_rank"])
def setup(request):
    return _setup(request.param)


def _batch(cfg, lens, S, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (len(lens), S)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


def test_padded_prefill_matches_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks, lens = _batch(tcfg, [48, 17, 33], 48)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)


def test_chunked_prefill_matches_full():
    """Three 16-token chunks (the q_offset attention path and the linear
    state carry) give the full prefill's logits and caches, and the
    reference's chunk caches."""
    jcfg, tcfg, jparams, tparams = _setup(0)
    toks, lens = _batch(tcfg, [48, 29], 48, seed=1)
    model = Model(tcfg)
    full_logits, full = model.prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    jmodel = JaxModel(jcfg)
    C, tc, jc = 16, None, None
    last = torch.zeros((2, 1, tcfg.d_model))
    for i in range(3):
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
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)
    # the full prefill's latent rows beyond each length are padding: compare
    # the state leaves exactly as a whole and the latent rows up to length
    for (path, a), (_, b) in zip(flatten(full), flatten(tc)):
        if path.endswith(("ckv", "kpe")):
            for row, n in enumerate(lens):
                np.testing.assert_allclose(b[:, row, :n], a[:, row, :n],
                                           **CACHE_TOL)
        else:
            np.testing.assert_allclose(b, a, **CACHE_TOL)


def test_decode_after_prefill_matches_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks, lens = _batch(tcfg, [20, 31], 32, seed=2)
    jmodel, model = JaxModel(jcfg), Model(tcfg)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(lens)})
    jc = jax_prepare(jcfg, jc, 48)
    tc = to_torch(jc)
    nxt = np.array([5, 9], np.int32)
    L = lens.copy()
    for _ in range(2):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc,
                                    jnp.asarray(L))
        tl, tc = model.decode_step(tparams, torch.from_numpy(nxt).long(), tc,
                                   torch.from_numpy(L))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        L = L + 1
    assert_trees_close(jc, tc, **CACHE_TOL)


def test_decode_cache_placement_matches_reference(setup):
    jcfg, tcfg, jparams, _ = setup
    toks, lens = _batch(tcfg, [12], 12, seed=3)
    _, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)})
    want = jax_prepare(jcfg, jc, 40)
    got = prepare_decode_caches(tcfg, to_torch(jc), 40)
    assert_trees_close(want, got, atol=0, rtol=0)
    assert_trees_close(jax_extend(jc, 9), extend_caches(to_torch(jc), 9),
                       atol=0, rtol=0)


def test_bf16_params_cross_bit_exactly():
    x = np.random.default_rng(4).standard_normal((3, 5, 7)).astype(np.float32)
    tree = {"w": jnp.asarray(x, jnp.bfloat16), "s": [jnp.asarray(x)]}
    got = from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")
    assert got["w"].dtype == torch.bfloat16
    assert (got["w"].view(torch.int16).numpy().tobytes()
            == np.asarray(tree["w"]).tobytes())
    assert got["s"][0].numpy().tobytes() == x.tobytes()


def test_init_params_has_the_reference_tree(setup):
    """Same keys, shapes and dtypes as the reference's init."""
    jcfg, tcfg, jparams, _ = setup
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ja = flatten(jax.tree.map(np.asarray, jparams))
    ta = flatten(got)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape and a.dtype == b.dtype, path
