"""The port's training loss and gradients against the reference's, on the
CPU, for ``zamba2-1.2b`` at float32 smoke size (Mamba2 mixers through the
unmasked GLA op, the shared attention + FFN block invoked twice): the same
weights (the reference's init, Mamba2 gates drawn nonzero) and the same
tokens go through ``Model.train_loss`` and autograd here and through
``jax.value_and_grad(Model(cfg, use_kernels=False, remat=True)
.train_loss)`` there, at S = 48 (one CE chunk) and S = 520 (past
``CE_CHUNK``, so the padded, masked last chunk runs).  The reference's loss
and gradients are computed once per sequence length for the module.

Tolerances: the loss 1e-5 relative; every leaf's gradient within 1e-3 of
that leaf's largest |gradient| plus 1e-3 relative (float32 sums in other
orders through 14 blocks and the chunked scans' backward; the largest
difference measured is ~6e-5 of a leaf's largest).  Remat on and off give
the same gradients exactly (the same graph, recomputed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, flatten, shared_params
from repro.models import Model as JaxModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.params import from_numpy_tree, requires_grad
from repro_torch.training import loss_and_grads

torch.set_num_threads(1)
ARCH = "zamba2-1.2b"


def tokens(vocab, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (2, S + 1)).astype(
        np.int32)


def reference_loss_and_grads(jcfg, jparams, toks):
    """(total, ce, aux, grads as a numpy tree) of the reference."""
    fn = jax.jit(jax.value_and_grad(
        JaxModel(jcfg, use_kernels=False, remat=True).train_loss,
        has_aux=True))
    (total, m), grads = fn(jparams, {"tokens": jnp.asarray(toks)})
    return (float(total), float(m["ce"]), float(m["aux"]),
            jax.tree.map(np.asarray, grads))


def assert_grads_close(jgrads, tgrads, rel=1e-3):
    ja, ta = flatten(jgrads), flatten(tgrads)
    assert [p for p, _ in ja] == [p for p, _ in ta]
    for (path, a), (_, b) in zip(ja, ta):
        assert a.shape == b.shape, path
        assert np.isfinite(b).all(), path
        np.testing.assert_allclose(b, a, atol=rel * np.abs(a).max(),
                                   rtol=rel, err_msg=path)


@pytest.fixture(scope="module")
def model_setup():
    jcfg, tcfg = configs(arch=ARCH)
    jparams, _ = shared_params(jcfg)
    return jcfg, tcfg, jparams, {}


def _case(model_setup, S):
    jcfg, tcfg, jparams, cache = model_setup
    if S not in cache:
        toks = tokens(jcfg.vocab_size, S)
        cache[S] = (toks, reference_loss_and_grads(jcfg, jparams, toks))
    toks, ref = cache[S]
    tparams = requires_grad(from_numpy_tree(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return tcfg, tparams, toks, ref


@pytest.mark.parametrize("S", [48, 520])
def test_train_loss_and_grads_match_reference(model_setup, S):
    tcfg, tparams, toks, (total, ce, aux, jgrads) = _case(model_setup, S)
    loss, metrics, grads = loss_and_grads(Model(tcfg, remat=True), tparams,
                                          {"tokens": torch.from_numpy(toks)})
    assert float(loss) == pytest.approx(total, rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(ce, rel=1e-5)
    assert float(metrics["aux"]) == aux == 0.0
    assert_grads_close(jgrads, grads)


def test_remat_gives_the_same_grads(model_setup):
    tcfg, tparams, toks, _ = _case(model_setup, 48)
    batch = {"tokens": torch.from_numpy(toks)}
    l1, _, g1 = loss_and_grads(Model(tcfg, remat=True), tparams, batch)
    l2, _, g2 = loss_and_grads(Model(tcfg, remat=False), tparams, batch)
    assert float(l1) == float(l2)
    for (path, a), (_, b) in zip(flatten(g1), flatten(g2)):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_stacked_grads_keep_their_layout(model_setup):
    """Each stacked (R, ...) leaf gets one (R, ...) gradient and the shared
    block's leaves one unstacked gradient summed over its invocations."""
    tcfg, tparams, toks, _ = _case(model_setup, 48)
    _, _, grads = loss_and_grads(Model(tcfg), tparams,
                                 {"tokens": torch.from_numpy(toks)})
    for (path, g), (_, p) in zip(flatten(grads), flatten(tparams)):
        assert g.shape == p.shape and g.dtype == p.dtype, path
    shared = grads["groups"][0]["shared"]["b5"]["mixer"]["wq"]["w"]
    assert shared.ndim == 2 and float(shared.abs().sum()) > 0


def test_train_loss_rejects_moe():
    """Capacity MoE training is not ported yet: a MoE block raises, naming
    the roadmap item, rather than training the dropless serving form."""
    cfg = get_smoke_config("kimi-linear-1t")
    from repro_torch.params import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        Model(cfg).train_loss(params, {"tokens": torch.zeros(
            (1, 9), dtype=torch.long)})
