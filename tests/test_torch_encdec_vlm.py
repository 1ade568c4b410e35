"""The port's encoder-decoder (smoke ``seamless-m4t-medium``: a
bidirectional encoder over frame embeddings, decoder blocks with
cross-attention, sinusoidal positions) and VLM (smoke
``phi-3-vision-4.2b``: projected image patches before the tokens) against
the reference's, on the CPU in float32 with the reference's params carried
over:

  * ``sinusoidal_positions``;
  * padded prefill logits and caches, the cross leaves included;
  * ``prepare_decode_caches`` (cross leaves keep their encoder length, laid
    out so that the decode kernel reads them in place), then two
    ``decode_step``s;
  * the PrfaaS invariant of ``tests/test_models_smoke.py``: decoding the
    last token from the prefill cache of the others gives the full
    prefill's log-softmax within 5e-4;
  * the plain flash attention at ``causal=False`` with Sq != Sk against the
    reference's Pallas kernel in interpret mode;
  * ``init_params`` gives the reference's tree (keys, shapes, dtypes) for
    the four architectures added with these two;
  * the paged layout, the chunked prefill, the speculative verify, the
    serving engines and the launcher refuse these models.  (The paged
    layout and the chunked prefill raise in the reference too; its verify
    runs its scan, but none of its engines, which take only tokens, can
    call it.)

Tolerances: logits 1e-4 abs / rel, caches 3e-4 abs / 1e-3 rel (two
stacked layers of float32 sums in other orders), the flash 2e-5 (one
softmax), the positions 2^-23 x the largest position (XLA's and torch's
float32 ``exp`` give frequencies up to one ulp apart, which the angle
multiplies by the position).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, configs, flatten,
                           shared_params, to_torch)
from repro.kernels.flash_attn import flash_attention as jax_flash
from repro.models import Model as JaxModel
from repro.models import paged as jpaged
from repro.models import prepare_decode_caches as jax_prepare
from repro.models.model import sinusoidal_positions as jax_sinusoidal
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import cache_rows
from repro_torch.launch import serve
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models import paged as tpaged
from repro_torch.models.model import sinusoidal_positions
from repro_torch.params import init_params
from repro_torch.serving.engine import DecodeEngine, PrefillEngine

torch.set_num_threads(1)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
ENCDEC, VLM = "seamless-m4t-medium", "phi-3-vision-4.2b"
ARCHS = [ENCDEC, VLM]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, lens, S, seed, S_enc=20):
    """numpy inputs: right-padded tokens, their lengths, and the frames
    (encoder-decoder) or the patches (VLM)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (len(lens), S))
         .astype(np.int32), "lengths": np.asarray(lens, np.int32)}
    if cfg.encoder_groups is not None:
        b["frames"] = rng.standard_normal(
            (len(lens), S_enc, cfg.encoder_input_dim)).astype(np.float32)
    if cfg.num_image_patches:
        b["patches"] = rng.standard_normal(
            (len(lens), cfg.num_image_patches, cfg.d_model)).astype(
                np.float32)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.mark.parametrize("pos", [[[0, 1, 7, 300], [5, 2, 64, 99]],
                                 [[4096, 12000], [5000, 3000]]],
                         ids=["small", "large"])
def test_sinusoidal_positions_match_reference(pos):
    pos = np.asarray(pos, np.int32)
    atol = 2.0 ** -23 * pos.max()
    for d in (64, 1024):
        want = np.asarray(jax_sinusoidal(jnp.asarray(pos), d))
        got = sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """A right-padded batch: logits at each row's last token (after a
    VLM's patches) and every cache leaf, the cross K / V at the encoder's
    length."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    b = _batch(tcfg, [24, 15], 24, seed=0)
    jl, jc = JaxModel(jcfg).prefill(jparams, _jax(b))
    tl, tc = Model(tcfg).prefill(tparams, _torch(b))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)
    paths = [p for p, _ in flatten(tc)]
    if arch == ENCDEC:
        assert any("/cross/k" in p for p in paths)
        k = tc["groups"][0]["b0"]["cross"]["k"]
        assert k.shape[2] == b["frames"].shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """``prepare_decode_caches`` then two greedy ``decode_step``s: logits
    each step and every leaf after them; the cross leaves keep the
    encoder's length and are read by the decode kernel in place."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    b = _batch(tcfg, [20, 31], 32, seed=2)
    _, jc = JaxModel(jcfg).prefill(jparams, _jax(b))
    _, tc = Model(tcfg).prefill(tparams, _torch(b))
    jc = jax_prepare(jcfg, jc, 64)
    assert_trees_close(jc, prepare_decode_caches(tcfg, tc, 64), **CACHE_TOL)
    tc = prepare_decode_caches(tcfg, to_torch(jc), 64)
    if arch == ENCDEC:
        cross = tc["groups"][0]["b0"]["cross"]
        assert cross["k"].shape[2] == b["frames"].shape[1]
        assert cache_rows(cross["k"][0].transpose(1, 2),
                          cross["v"][0].transpose(1, 2)) is not None
    L = b["lengths"] + tcfg.num_image_patches
    nxt = np.array([5, 9], np.int32)
    jmodel, model = JaxModel(jcfg), Model(tcfg)
    for _ in range(2):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc,
                                    jnp.asarray(L))
        tl, tc = model.decode_step(tparams, torch.from_numpy(nxt).long(), tc,
                                   torch.from_numpy(L))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        L = L + 1
    assert_trees_close(jc, tc, **CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_prefill_cache_matches_prefill(arch):
    """The PrfaaS invariant on the port: the prefill cache of S - 1
    tokens, placed for decode, decodes token S - 1 to the full prefill's
    distribution (log-softmax within 5e-4, as the reference's smoke
    test), and a second step stays finite."""
    _, tcfg, _, tparams = _setup(arch)
    B, S = 2, 33
    b = _torch(_batch(tcfg, [S] * B, S, seed=4))
    del b["lengths"]
    model = Model(tcfg)
    full, _ = model.prefill(tparams, b)
    _, caches = model.prefill(tparams, {**b, "tokens": b["tokens"][:, :-1]})
    total0 = S - 1 + tcfg.num_image_patches
    dc = prepare_decode_caches(tcfg, caches, total0 + 8)
    lengths = torch.full((B,), total0, dtype=torch.int32)
    got, dc = model.decode_step(tparams, b["tokens"][:, -1], dc, lengths)
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(got, -1)).abs().max())
    assert err < 5e-4, err
    nxt, _ = model.decode_step(tparams, got.argmax(-1), dc, lengths + 1)
    assert torch.isfinite(nxt).all()


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv", [(24, 56, 4, 4), (40, 13, 4, 2)])
def test_plain_flash_noncausal_matches_reference_kernel(Sq, Sk, Hq, Hkv):
    """``causal=False`` with Sq != Sk (an encoder's self-attention, a
    cross block over the encoder's keys) against the reference's Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, Hq, Sq, 64)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, Sk, 64)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, Sk, 64)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, interpret=True, block_q=16, block_k=16)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("arch", [ENCDEC, VLM, "llama4-scout-17b-a16e",
                                  "mixtral-8x22b"])
def test_init_params_has_the_reference_tree(arch):
    """Same keys, shapes and dtypes as the reference's init (``enc_groups``,
    ``enc_norm``, ``enc_proj``, ``ln_cross`` / ``cross``, ``patch_proj``,
    the MoE's router, experts and shared expert)."""
    jcfg, tcfg = configs(arch=arch)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ja = flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
    ta = flatten(got)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, t) in zip(ja, ta):
        assert a.shape == t.shape and a.dtype == t.dtype, path


@pytest.mark.parametrize("arch", ARCHS)
def test_token_only_paths_refuse(arch):
    """The paged layout (both frameworks), the chunked prefill (both), the
    port's speculative verify, its serving engines and its launcher refuse
    an encoder or an image prefix, each with its message."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    for lay in (jpaged.paged_layout, tpaged.paged_layout):
        with pytest.raises(ValueError, match="decoder-only token models"):
            lay(tcfg, 64, 16, 8)
    chunk = {"tokens": np.zeros((1, 4), np.int32),
             "positions": np.arange(4, dtype=np.int32)[None]}
    with pytest.raises(ValueError, match="decoder-only token models"):
        JaxModel(jcfg).prefill_chunk(jparams, _jax(chunk))
    model = Model(tcfg)
    with pytest.raises(ValueError, match="decoder-only token models"):
        model.prefill_chunk(tparams, _torch(chunk))
    with pytest.raises(ValueError, match="decoder-only token models"):
        model.decode_verify(tparams, torch.zeros((1, 3), dtype=torch.long),
                            model.init_cache(1, 16, "cpu", enc_len=4),
                            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="serving engines"):
        PrefillEngine(model, tparams)
    with pytest.raises(ValueError, match="serving engines"):
        DecodeEngine(model, tparams, 2, 64)
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="serving launcher"):
        serve.run_serve(args)
