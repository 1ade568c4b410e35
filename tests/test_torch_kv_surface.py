"""The paper's incremental S_kv, the wire chunks of a cache, the profile
models and the shape set on the port, against the reference's:

  * ``kv_bytes_incremental`` and ``linear_state_bytes`` equal the
    reference's on every registered architecture, every profile model and
    the cases of ``tests/test_kv_wire.py:44-86`` (the mixed config, the
    explicit ``LinearSpec`` predicate, the ``TypeError``);
  * ``flatten_cache_for_transfer``'s names and tensors equal the
    reference's on a smoke prefill cache;
  * every profile model's ``param_count`` and ``kv_cache_bytes`` equal the
    reference's, and the exported ``SHAPES`` / ``cells`` are its.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, drawn_params
from repro.configs import SHAPES as JSHAPES
from repro.configs import all_configs as jax_all_configs
from repro.configs import cells as jax_cells
from repro.configs import get_config as jax_config
from repro.configs import profiles as jprofiles
from repro.configs.base import AttentionSpec as JAttn
from repro.configs.base import BlockSpec as JBlock
from repro.configs.base import FFNSpec as JFFN
from repro.configs.base import GroupSpec as JGroup
from repro.configs.base import LinearSpec as JLinear
from repro.configs.base import ModelConfig as JConfig
from repro.models import Model as JaxModel
from repro.models import kvcache as jkv
from repro_torch.configs import (ARCH_BUILDERS, SHAPES, AttentionSpec,
                                 BlockSpec, FFNSpec, GroupSpec, LinearSpec,
                                 ModelConfig, all_configs, cells, get_config)
from repro_torch.configs import profiles
from repro_torch.models import Model
from repro_torch.models import kvcache

torch.set_num_threads(1)
LENGTHS = ((0, 512), (128, 512), (1024, 8192), (16384, 32768),
           (32768, 32768), (100000, 131072))


def _mixed(ns):
    """One full-attn + one MLA + one linear block, repeated twice, in
    either framework's config types (``ns``: their constructors)."""
    attn, block, ffn, group, linear, config = ns
    f = ffn(kind="dense", d_ff=64)
    blocks = (
        block(mixer=attn(kind="full", q_heads=4, kv_heads=2, head_dim=16),
              ffn=f),
        block(mixer=attn(kind="mla", q_heads=4, kv_heads=4, head_dim=16,
                         mla_kv_rank=32, mla_rope_dim=16), ffn=f),
        block(mixer=linear(kind="gla", heads=2, key_dim=16, value_dim=16),
              ffn=f))
    return config(name="mixed-test", family="hybrid", d_model=64,
                  vocab_size=256, groups=(group(blocks, repeats=2),))


PORT = (AttentionSpec, BlockSpec, FFNSpec, GroupSpec, LinearSpec,
        ModelConfig)
REF = (JAttn, JBlock, JFFN, JGroup, JLinear, JConfig)


def _pairs():
    out = [(jax_config(a), get_config(a)) for a in ARCH_BUILDERS]
    out += [(jprofiles.PROFILE_MODELS[n](), profiles.PROFILE_MODELS[n]())
            for n in profiles.PROFILE_MODELS]
    return out + [(_mixed(REF), _mixed(PORT))]


@pytest.mark.parametrize("dtype_bytes", [1, 2])
def test_incremental_bytes_match_reference(dtype_bytes):
    for jcfg, tcfg in _pairs():
        assert kvcache.linear_state_bytes(tcfg) == \
            jkv.linear_state_bytes(jcfg), tcfg.name
        for cached, total in LENGTHS:
            assert kvcache.kv_bytes_incremental(
                tcfg, cached, total, dtype_bytes) == \
                jkv.kv_bytes_incremental(jcfg, cached, total,
                                         dtype_bytes), (tcfg.name, cached)


def test_mixed_config_identity():
    cfg = _mixed(PORT)
    state = kvcache.linear_state_bytes(cfg)
    assert state == 2 * LinearSpec(kind="gla", heads=2, key_dim=16,
                                   value_dim=16).state_bytes()
    inc = kvcache.kv_bytes_incremental(cfg, 128, 512)
    assert inc == kvcache.kv_bytes(cfg, 512) - kvcache.kv_bytes(cfg, 128) \
        + state
    assert kvcache.kv_bytes_incremental(cfg, 0, 512) == \
        kvcache.kv_bytes(cfg, 512)


def test_explicit_predicate_not_duck_typing():
    class QHeadedLinear(LinearSpec):
        q_heads = 4                      # red herring attribute

    weird = QHeadedLinear(kind="gla", heads=2, key_dim=16, value_dim=16)
    cfg = dataclasses.replace(_mixed(PORT), groups=(GroupSpec(
        (BlockSpec(mixer=weird, ffn=FFNSpec(kind="dense", d_ff=64)),),
        repeats=1),))
    assert kvcache.linear_state_bytes(cfg) == weird.state_bytes()
    assert kvcache.kv_bytes_incremental(cfg, 64, 128) == \
        kvcache.kv_bytes(cfg, 128) - kvcache.kv_bytes(cfg, 64) \
        + weird.state_bytes()


def test_unknown_mixer_rejected():
    class Mystery:
        pass

    cfg = dataclasses.replace(_mixed(PORT), groups=(GroupSpec(
        (BlockSpec(mixer=Mystery(), ffn=FFNSpec(kind="dense", d_ff=64)),),
        repeats=1),))
    with pytest.raises(TypeError, match="unknown mixer"):
        kvcache.linear_state_bytes(cfg)


def test_kimi_incremental_resends_one_state():
    """The reference's ``TestKVByteAccounting.test_incremental_bytes``."""
    cfg = get_config("kimi-linear-1t")
    full = kvcache.kv_bytes(cfg, 32768)
    inc = kvcache.kv_bytes_incremental(cfg, 16384, 32768)
    assert inc < full
    state = sum(b.mixer.state_bytes() for *_, b in cfg.iter_blocks()
                if not hasattr(b.mixer, "q_heads"))
    assert inc == full - kvcache.kv_bytes(cfg, 16384) + state


@pytest.mark.parametrize("arch", ["kimi-linear-1t", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_flatten_cache_for_transfer_matches_reference(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": toks}
    if tcfg.encoder_groups is not None:
        batch["frames"] = rng.standard_normal(
            (2, 16, tcfg.encoder_input_dim)).astype(np.float32)
    _, jc = JaxModel(jcfg).prefill(jparams, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    _, tc = Model(tcfg).prefill(tparams, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    want = jkv.flatten_cache_for_transfer(jc)
    got = kvcache.flatten_cache_for_transfer(tc)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, t), (_, a) in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=3e-4,
                                   rtol=1e-3, err_msg=name)
    assert kvcache.cache_num_bytes(tc) == jkv.cache_num_bytes(jc)


def test_profile_models_match_reference():
    assert list(profiles.PROFILE_MODELS) == list(jprofiles.PROFILE_MODELS)
    for name, build in profiles.PROFILE_MODELS.items():
        t, j = build(), jprofiles.PROFILE_MODELS[name]()
        assert t.param_count() == j.param_count(), name
        assert t.active_param_count() == j.active_param_count(), name
        for l in (1024, 8192, 32768, 131072):
            for b in (1, 2):
                assert t.kv_cache_bytes(l, b) == j.kv_cache_bytes(l, b)


def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for assigned in (True, False):
        assert sorted(cells(all_configs(assigned))) == \
            sorted(jax_cells(jax_all_configs(assigned)))
