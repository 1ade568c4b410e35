"""The Lightning (``gla``) mixer kind and ring-2.5-1t in the port against
the reference, on smoke ``ring-2.5-1t`` (``reduce_for_smoke`` of
``configs/profiles.py::ring_2_5_1t``: 7 Lightning blocks and 1 MLA block
twice over, a top-2 MoE of 4 experts and a shared one; float32, the
reference's params carried over):

  * the parameter tree: the reference's keys, shapes and dtypes (a
    ``gla`` mixer has ``a_proj`` and no ``A_log`` / ``dt_bias`` /
    ``b_proj`` / ``D_skip``), float32 and bf16;
  * prefill logits and every cache leaf of a padded batch (Lightning's
    state and conv window at each row's length, MLA's latents);
  * a request's caches out of a padded bucket equal those of its prompt
    prefilled alone, unpadded;
  * two decode steps against the reference's, and a scan verify's
    commit of 0, 1 or 2 accepted drafts (the Lightning ``state`` and
    ``conv`` rolled back to each slot's accepted steps, bit for bit);
  * the wire pytree of an offloaded request, byte for byte: the MLA
    latents quantized, the Lightning state and conv window raw; and the
    reference's mixed GQA + MLA + ``gla`` test config
    (``tests/test_kv_wire.py::_mixed_config``) through a real prefill and
    the wire encode;
  * ``train_loss`` and every gradient leaf (the capacity MoE and its aux
    loss) against ``jax.value_and_grad``, at kimi's 1e-3 of a leaf's
    largest |gradient| (``tests/test_torch_train_moe.py``).

The serving paths are ``tests/test_torch_ring_serving.py``.  Tolerances
as ``tests/test_torch_model.py``: logits 1e-4, caches 3e-4 abs / 1e-3
rel; the train tests' own (``_torch_parity.assert_train_matches``); wire
bytes exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_train_matches, assert_trees_close,
                           assert_trees_identical, flatten, profile_configs,
                           reference_train_loss, shared_params, to_jax,
                           train_batch)
from repro.models import Model as JaxModel
from repro.models import prepare_decode_caches as jax_prepare
from repro.models.kvcache import quantize_cache_for_wire as jax_quantize
from repro.models.kvcache import wire_compression_ratio as jax_ratio
from repro.serving import engine as jeng
from repro_torch.configs import base as tbase
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models.kvcache import (encode_request_for_wire,
                                        quantize_cache_for_wire,
                                        wire_compression_ratio)
from repro_torch.models.tree import tree_map
from repro_torch.params import init_params, requires_grad
from repro_torch.serving.engine import PrefillEngine, trim_request_cache
from repro_torch.training import loss_and_grads
from test_kv_wire import _mixed_config as jax_mixed_config

torch.set_num_threads(1)
RING = "ring-2.5-1t"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=3e-4, rtol=1e-3)
GLA_KEYS = ["a_proj", "conv_w", "g_norm", "g_proj", "wk", "wo", "wq", "wv"]


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = profile_configs(RING)
    kinds = [b.mixer.kind for g in tcfg.groups for b in g.blocks]
    assert kinds == ["gla"] * 7 + ["mla"]
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
    jcfg, tcfg = profile_configs(RING)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _spec(got) == [(p, a.shape, str(np.dtype(a.dtype)))
                          for p, a in flatten(jax.tree.map(
                              lambda s: np.zeros(s.shape, s.dtype), want))]
    assert sorted(got["groups"][0]["stacked"]["b0"]["mixer"]) == GLA_KEYS


def test_prefill_logits_and_caches_match_reference():
    """A padded batch of 97, 40 and 70 tokens: logits, each Lightning
    block's state (B, H, dk, dv) and conv window, and the MLA latents."""
    jcfg, tcfg, jparams, tparams = _setup()
    toks, lens = _tokens(tcfg, 3, 97, 0), np.array([97, 40, 70], np.int32)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_trees_close(jc, tc, **CACHE_TOL)
    b0 = tc["groups"][0]["b0"]
    assert sorted(b0) == ["conv", "state"]
    assert b0["state"].shape == (2, 3, 2, 16, 16)       # (R, B, H, dk, dv)
    assert sorted(tc["groups"][0]["b7"]) == ["ckv", "kpe"]


def test_bucket_padding_leaves_the_state():
    """Prompts of 40, 97 and 130 tokens prefilled together in the engine's
    buckets (right-padded; the last in chunks of 64): each request's
    first token and trimmed caches equal those of its prompt prefilled
    alone, unpadded (padded positions hold the Lightning state: decay 1,
    key 0)."""
    _, tcfg, _, tparams = _setup()
    model = Model(tcfg)
    lens = np.array([40, 97, 130], np.int32)
    toks = _tokens(tcfg, 3, 130, 7)
    first, caches, _ = PrefillEngine(model, tparams, min_bucket=32,
                                     max_bucket=64).prefill(toks, lens)
    for i, L in enumerate(lens.tolist()):
        logits, alone = model.prefill(tparams, {
            "tokens": torch.from_numpy(toks[i:i + 1, :L]).long()})
        assert int(first[i]) == int(logits.argmax(-1)[0])
        assert_trees_close(alone, trim_request_cache(caches, i, L),
                           **CACHE_TOL)


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


def _stepped(model, params, seq, caches, lens, accept):
    """Each slot's caches after its accepted steps alone (plain decode
    steps from ``caches``)."""
    out = []
    with torch.no_grad():
        for b in range(len(accept)):
            c = tree_map(lambda x: x.clone(), caches)
            for j in range(accept[b] + 1):
                _, c = model.decode_step(
                    params, torch.from_numpy(seq[:, j]).long(), c,
                    torch.from_numpy(lens) + j)
            out.append(c)
    return out


@pytest.mark.parametrize("accept", [(0, 1, 2, 0), (2, 2, 2, 2)],
                         ids=["partial", "all"])
def test_verify_rollback_matches_reference(accept):
    """A scan verify of 3 positions over random dense caches, then a
    commit: logits and caches equal the reference's, and each slot's
    Lightning ``state`` and ``conv`` (and MLA rows) equal those of its
    accepted steps alone, bit for bit."""
    jcfg, tcfg, jparams, tparams = _setup()
    model, jmodel = Model(tcfg), JaxModel(jcfg, use_kernels=False)
    rng = np.random.default_rng(4)
    caches = tree_map(lambda x: torch.from_numpy(
        (rng.standard_normal(tuple(x.shape)) * 0.5).astype(np.float32)),
        model.init_cache(4, 64, "cpu"))
    lens = np.array([5, 20, 33, 61], np.int32)
    seq = rng.integers(0, tcfg.vocab_size, (4, 3)).astype(np.int32)
    acc = np.array(accept, np.int32)
    jlg, jver, jpend = jax.jit(jmodel.decode_verify)(
        jparams, jnp.asarray(seq), to_jax(caches), jnp.asarray(lens))
    jcom = jax.jit(jmodel.commit_verify, static_argnums=4)(
        jver, jpend, jnp.asarray(lens), jnp.asarray(acc), 3)
    stepped = _stepped(model, tparams, seq, caches, lens, acc)
    with torch.no_grad():
        lg, ver, pend = model.decode_verify(
            tparams, torch.from_numpy(seq).long(),
            tree_map(lambda x: x.clone(), caches), torch.from_numpy(lens))
        assert sorted(pend["snaps"][0]["b0"]) == ["conv", "state"]
        com = model.commit_verify(ver, pend, torch.from_numpy(acc))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert_trees_close(jcom, com, **CACHE_TOL)
    for b in range(4):
        rows = int(lens[b]) + int(acc[b]) + 1
        for (path, got), (_, want) in zip(flatten(com), flatten(stepped[b])):
            if path.endswith(("ckv", "kpe")):       # rows the stream reads
                got, want = got[:, b, :rows], want[:, b, :rows]
            else:
                got, want = got[:, b], want[:, b]
            np.testing.assert_array_equal(got, want, path)


def _wire_matches_reference(caches, lens):
    """Each request of a padded prefill batch encoded in place for the
    wire: the reference's trim + wire pytree byte for byte, its bytes and
    ratio.  Returns the wire pytrees."""
    wires = []
    for idx, L in enumerate(lens):
        wire, nbytes, raw = encode_request_for_wire(caches, idx, L)
        trimmed = trim_request_cache(caches, idx, L)
        jtrim = jeng.trim_request_cache(to_jax(caches), idx, L)
        jwire, jbytes = jax_quantize(jtrim, use_kernel=False)
        assert nbytes == jbytes < raw
        assert_trees_identical(jwire, wire)
        assert_trees_identical(jtrim, trimmed)
        assert quantize_cache_for_wire(trimmed)[1] == jbytes
        assert wire_compression_ratio(trimmed) == jax_ratio(jtrim) > 1.0
        wires.append(wire)
    return wires


@pytest.mark.parametrize("max_bucket", [None, 32], ids=["bucket", "chunks"])
def test_wire_pytree_matches_reference(max_bucket):
    """An offloaded ring request (bucketed, or three 32-token chunks): the
    MLA latents go int8 with their scales, the Lightning state (float32)
    and conv window ship as they are."""
    _, tcfg, _, tparams = _setup()
    toks, lens = _tokens(tcfg, 3, 70, 6), [70, 33, 1]
    _, caches, _ = PrefillEngine(Model(tcfg), tparams, min_bucket=32,
                                 max_bucket=max_bucket).prefill(
        toks, np.asarray(lens, np.int32))
    wire = _wire_matches_reference(caches, lens)[0]["groups"][0]
    assert wire["b0"]["state"].dtype == torch.float32
    assert wire["b0"]["state"].shape == (2, 1, 2, 16, 16)
    assert wire["b7"]["ckv"]["q"].dtype == torch.int8


def _port_mixed_config():
    """The port's copy of the reference's mixed test config: a GQA, an MLA
    and a ``gla`` block, twice."""
    ffn = tbase.FFNSpec(kind="dense", d_ff=64)
    blocks = (
        tbase.BlockSpec(mixer=tbase.AttentionSpec(
            kind="full", q_heads=4, kv_heads=2, head_dim=16), ffn=ffn),
        tbase.BlockSpec(mixer=tbase.AttentionSpec(
            kind="mla", q_heads=4, kv_heads=4, head_dim=16, mla_kv_rank=32,
            mla_rope_dim=16), ffn=ffn),
        tbase.BlockSpec(mixer=tbase.LinearSpec(
            kind="gla", heads=2, key_dim=16, value_dim=16), ffn=ffn),
    )
    return tbase.ModelConfig(name="mixed-test", family="hybrid", d_model=64,
                             vocab_size=256,
                             groups=(tbase.GroupSpec(blocks, repeats=2),))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_gla_config_matches_reference(dtype):
    """The reference's mixed GQA + MLA + ``gla`` config (bf16 as it is
    written, and in float32): the same config in both packages; a padded
    prefill's caches, as a whole batch and request by request, encoded for
    the wire byte for byte as the reference encodes them; in float32 the
    prefill's logits and caches against the reference's."""
    jcfg, tcfg = jax_mixed_config(), _port_mixed_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jparams, tparams = shared_params(jcfg)
    toks, lens = _tokens(tcfg, 2, 96, 3), [96, 50]
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.tensor(lens, dtype=torch.int32)})
    if dtype == "float32":
        jl, jc = jax.jit(JaxModel(jcfg).prefill)(jparams, {
            "tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert_trees_close(jc, tc, **CACHE_TOL)
    jwire, jbytes = jax_quantize(to_jax(tc), use_kernel=False)
    wire, nbytes = quantize_cache_for_wire(tc)
    assert nbytes == jbytes
    assert_trees_identical(jwire, wire)
    _wire_matches_reference(tc, lens)


def test_train_loss_and_grads_match_reference():
    """``train_loss`` (total, ce and the MoE's aux loss) and every gradient
    leaf, the Lightning mixers' through the GLA scan."""
    jcfg, tcfg, jparams, tparams = _setup()
    batch = train_batch(tcfg, 2, 48)
    ref = reference_train_loss(jcfg, jparams, batch)
    # a copy: the cached params of the other tests stay without grad
    tparams = requires_grad(tree_map(lambda x: x.detach().clone(), tparams))
    got = loss_and_grads(Model(tcfg, remat=True), tparams, batch)
    assert ref[2] > 0
    # the embedding's gradient sums the backward of all 16 blocks and the
    # routers' aux terms (its largest |gradient| ~3): float32 rounding
    # reaches ~2e-4 of that largest, so the kimi case's 1e-3 of the
    # largest applies (``test_torch_train_moe.py``)
    assert_train_matches(ref, got, of_largest=1e-3)
