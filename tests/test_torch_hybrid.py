"""The port's hybrid model, smoke ``zamba2-1.2b`` (Mamba2 mixers and one
parameter-tied attention + FFN block invoked once per repeat), against the
reference on the CPU, with the reference's params carried over (float32,
nonzero Mamba2 gates, ``_torch_parity.nonzero_mamba2_gates``):

  * the smoke config, and the params tree's shared block (one unstacked
    tree under ``"shared"``);
  * each invocation of the shared block keeps its own K/V through prefill
    and decode, and those caches differ, so the parity checks can tell
    them apart;
  * ``prefill_chunk`` continuation (``tests/test_torch_model.py``'s check).

Prefill logits with the caches of every repeat, dense decode steps, cache
placement and the whole params tree are the ``zamba2`` case of
``tests/test_torch_model.py``; paged decode steps and wire-admitted pools
are cases of ``tests/test_torch_paged.py``; the serving path is held
against the reference's by ``tests/test_torch_hybrid_serving.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_model
from _torch_parity import configs, to_torch
from repro.models import Model as JaxModel
from repro.models import prepare_decode_caches as jax_prepare
from repro_torch.models import Model
from repro_torch.params import init_params

torch.set_num_threads(1)
HYBRID = "zamba2-1.2b"


def test_smoke_config_matches_reference():
    """2 repeats of [5 x mamba2, shared attention], then 2 mamba2 layers,
    in float32, field for field as the reference reduces it."""
    jcfg, tcfg = configs(arch=HYBRID)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    g0, g1 = tcfg.groups
    assert g0.repeats == 2 and g1.repeats == 2
    assert [b.mixer.kind for b in g0.blocks] == ["mamba2"] * 5 + ["full"]
    assert [b.shared for b in g0.blocks] == [False] * 5 + [True]
    assert [b.mixer.kind for b in g1.blocks] == ["mamba2"]
    assert tcfg.dtype == "float32"


def test_shared_block_is_one_unstacked_tree():
    """The shared block's params sit unstacked under ``"shared"``; Mamba2
    mixers have no ``b_proj`` and zero ``A_log`` / ``dt_bias`` /
    ``D_skip``, blocks without an FFN no ``ln2``."""
    _, tcfg = configs(arch=HYBRID)
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    g0 = got["groups"][0]
    assert set(g0["shared"]) == {"b5"} and "b5" not in g0["stacked"]
    assert g0["shared"]["b5"]["mixer"]["wq"]["w"].shape == (64, 64)
    assert got["groups"][1]["shared"] == {}
    mamba = g0["stacked"]["b0"]
    assert "ln2" not in mamba and "b_proj" not in mamba["mixer"]
    for name in ("A_log", "dt_bias", "D_skip"):
        assert mamba["mixer"][name].shape == (2, 2)
        assert not mamba["mixer"][name].any()


def test_shared_block_invocations_keep_their_own_caches():
    """Prefill, then two decode steps: each repeat's invocation of the
    shared block holds its own K/V (stacked over the repeats), and the two
    differ, in the reference and in the port alike."""
    jcfg, tcfg, jparams, tparams = test_torch_model._setup(0, HYBRID)
    toks = np.random.default_rng(2).integers(0, 256, (2, 32)).astype(np.int32)
    lens = np.array([20, 31], np.int32)
    _, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens)})
    tc = to_torch(jax_prepare(jcfg, jc, 48))
    nxt, L = np.array([5, 9], np.int32), lens.copy()
    for _ in range(2):
        _, tc = Model(tcfg).decode_step(tparams, torch.from_numpy(nxt).long(),
                                        tc, torch.from_numpy(L))
        L = L + 1
    for caches in (jc, tc):
        kv = caches["groups"][0]["b5"]
        for leaf in (kv["k"], kv["v"]):
            assert leaf.shape[0] == 2
            assert not np.allclose(np.asarray(leaf[0]), np.asarray(leaf[1]))


def test_prefill_chunks_match_reference():
    test_torch_model.test_chunked_prefill_matches_full(HYBRID)
