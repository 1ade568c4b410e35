"""The port's full-attention GQA model against the reference's on smoke
``mistral-nemo-12b`` (float32, the reference's params carried over):
parameter trees, padded prefill logits and caches, prefill chunks over a
prior cache, and dense decode steps.  The paged decode steps are in
``tests/test_torch_paged.py``.

Tolerances: logits 1e-4 abs / 1e-4 rel; caches and hidden states 3e-4 /
1e-3 (two stacked layers of float32 sums in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, configs, flatten,
                           shared_params)
from repro.models import Model as JaxModel
from repro.models import prepare_decode_caches as jax_prepare
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.params import init_params

torch.set_num_threads(1)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)
GQA = "mistral-nemo-12b"


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_gqa_init_params_has_the_reference_tree(qkv_bias):
    """``init_params`` of full-width-shaped GQA blocks (q_heads * head_dim
    != d_model, with and without q/k/v biases) has the reference's keys,
    shapes and dtypes."""
    jcfg, tcfg = configs(arch=GQA)
    groups = []
    for cfg in (jcfg, tcfg):
        g = cfg.groups[0]
        blk = dataclasses.replace(g.blocks[0], mixer=dataclasses.replace(
            g.blocks[0].mixer, q_heads=6, kv_heads=2, qkv_bias=qkv_bias))
        groups.append(dataclasses.replace(
            cfg, groups=(dataclasses.replace(g, blocks=(blk,)),)))
    jcfg, tcfg = groups
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ja = flatten(jax.tree.map(np.asarray, jparams))
    ta = flatten(got)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape and a.dtype == b.dtype, path


def _batch(cfg, lens, S, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (len(lens), S)).astype(np.int32)
    return toks, np.asarray(lens, np.int32)


def test_gqa_prefill_matches_reference():
    jcfg, tcfg, jparams, tparams = _setup(GQA)
    toks, lens = _batch(tcfg, [48, 17, 33], 48)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)


def test_gqa_prefill_chunks_match_reference():
    """Two 32-token chunks: the second attends over the first's K/V."""
    jcfg, tcfg, jparams, tparams = _setup(GQA)
    toks, _ = _batch(tcfg, [64, 64], 64, seed=1)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jc = tc = None
    for i in range(2):
        pos = np.repeat(np.arange(32 * i, 32 * (i + 1), dtype=np.int32)[None],
                        2, axis=0)
        lens = np.array([32, 32], np.int32)
        chunk = toks[:, 32 * i:32 * (i + 1)]
        jh, jc = jm.prefill_chunk(jparams, {
            "tokens": jnp.asarray(chunk), "positions": jnp.asarray(pos),
            "lengths": jnp.asarray(lens)}, jc)
        th, tc = tm.prefill_chunk(tparams, {
            "tokens": torch.from_numpy(chunk).long(),
            "positions": torch.from_numpy(pos),
            "lengths": torch.from_numpy(lens)}, tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **CACHE_TOL)
        assert_trees_close(jc, tc, **CACHE_TOL)


def test_gqa_decode_steps_match_reference():
    """Dense GQA decode: prefill, place into capacity-96 buffers, three
    greedy steps; logits and caches against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(GQA)
    toks, lens = _batch(tcfg, [30, 21], 30, seed=2)
    jm, tm = JaxModel(jcfg), Model(tcfg)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lens)})
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks).long(),
                                  "lengths": torch.from_numpy(lens)})
    jc, tc = jax_prepare(jcfg, jc, 96), prepare_decode_caches(tcfg, tc, 96)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1)
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    for _ in range(3):
        jl, jc = jm.decode_step(jparams, jtok, jc, jlen)
        tl, tc = tm.decode_step(tparams, ttok, tc, tlen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jtok, ttok = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
        assert np.asarray(jtok).tolist() == ttok.tolist()
        jlen, tlen = jlen + 1, tlen + 1
    assert_trees_close(jc, tc, **CACHE_TOL)
