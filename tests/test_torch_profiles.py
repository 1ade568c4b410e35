"""Every model of the paper's Table 1/3 comparison (``configs/profiles.py::
PROFILE_MODELS``) built as a ``Model`` in the port and held against the
reference at smoke size (float32, the reference's params carried over):
the logits and every cache leaf of a padded prefill batch.

This covers the port's only runs of the ``gdn`` kind (qwen3.5-397b's
GDN:GQA 3:1 MoE), of mimo-v2-flash's SWA:GQA 5:1 MoE and of ring-2.5-1t's
Lightning (``gla``) kind beside its MLA; ``tests/test_torch_ring.py``
holds ring further.  Tolerances as ``tests/test_torch_model.py``: logits
1e-4, caches 3e-4 abs / 1e-3 rel.  Also: a one-block model of each mixer
kind ``LinearSpec`` names builds, with the reference's parameter keys,
shapes and dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, flatten, profile_configs,
                           shared_params)
from repro.configs import base as jbase
from repro.models import Model as JaxModel
from repro_torch.configs import base as tbase
from repro_torch.configs import profiles
from repro_torch.models import Model
from repro_torch.params import init_params

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(profiles.PROFILE_MODELS))
def test_padded_prefill_matches_reference(name):
    """Three rows of 97, 40 and 70 tokens in one 97-token batch: the
    logits at each row's last token and every cache leaf (linear states
    and conv windows at each row's length, MLA latents, GQA and SWA
    k / v)."""
    jcfg, tcfg = profile_configs(name)
    jparams, tparams = shared_params(jcfg)
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (3, 97)).astype(np.int32)
    lens = np.array([97, 40, 70], np.int32)
    jl, jc = JaxModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(toks),
                                              "lengths": jnp.asarray(lens)})
    tl, tc = Model(tcfg).prefill(tparams, {
        "tokens": torch.from_numpy(toks).long(),
        "lengths": torch.from_numpy(lens)})
    assert tl.shape == (3, tcfg.vocab_size) and torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert_trees_close(jc, tc, atol=3e-4, rtol=1e-3)


def _spec(tree):
    """[(path, shape, dtype name)] of a tree of either framework."""
    return [(p, a.shape, str(a.dtype)) for p, a in flatten(tree)]


@pytest.mark.parametrize("kind", ["kda", "gdn", "gla", "mamba2", "mlstm",
                                  "slstm"])
def test_every_linear_kind_builds_with_the_reference_keys(kind):
    """Every mixer kind ``LinearSpec`` names builds a ``Model``, and
    ``init_params`` gives the reference's keys, shapes and dtypes for it
    (a one-block config of that kind, bf16, with a conv unless sLSTM)."""
    def config(base):
        spec = base.LinearSpec(kind=kind, heads=2, key_dim=16, value_dim=16)
        block = base.BlockSpec(mixer=spec, ffn=base.FFNSpec(kind="dense",
                                                            d_ff=64))
        return base.ModelConfig(name=f"one-{kind}", family="hybrid",
                                d_model=64, vocab_size=256,
                                groups=(base.GroupSpec((block,), 2),))

    jcfg, tcfg = config(jbase), config(tbase)
    Model(tcfg)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _spec(got) == [(p, a.shape, str(np.dtype(a.dtype)))
                          for p, a in flatten(jax.tree.map(
                              lambda s: np.zeros(s.shape, s.dtype), want))]
