"""The port's training loss and gradients against the reference's, on the
CPU, for the reference's KDA:MLA 3:1 training recipe
(``examples/train_100m.py::hybrid_lm``) at its 8m scale: KDA mixers
through the unmasked delta-rule op, MLA blocks (Dk 48 != Dv 32) through
attention, dense SwiGLU FFNs, tied embeddings, float32.  The same weights
and tokens go through both frameworks at S = 48 and at S = 520 (past
``CE_CHUNK``); the reference's loss and gradients are computed once per
sequence length for the module.  The port's own copy of the recipe
(``repro_torch.examples.train_100m``) must build the reference's config
at both scales.

Tolerances: the loss 1e-5 relative; every leaf's gradient within 1e-3 of
that leaf's largest |gradient| plus 1e-3 relative (float32 sums in other
orders; the delta rule's backward runs through its chunks' Neumann
inverse, which amplifies rounding: the largest difference measured is ~5e-4
of a leaf's largest).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import flatten, nonzero_mamba2_gates, reference_recipe
from repro.models import Model as JaxModel
from repro_torch.examples.train_100m import hybrid_lm
from repro_torch.models import Model
from repro_torch.models.tree import tree_flatten_with_path
from repro_torch.params import from_numpy_tree, init_params, requires_grad
from repro_torch.training import loss_and_grads
from test_torch_train import (assert_grads_close, reference_loss_and_grads,
                              tokens)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hybrid():
    jcfg = reference_recipe("8m")
    jparams = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, hybrid_lm("8m"), nonzero_mamba2_gates(jparams), {}


@pytest.mark.parametrize("S", [48, 520])
def test_hybrid_train_loss_and_grads_match_reference(hybrid, S):
    jcfg, tcfg, tree, cache = hybrid
    toks = tokens(jcfg.vocab_size, S, seed=1)
    total, ce, aux, jgrads = reference_loss_and_grads(
        jcfg, jax.tree.map(jax.numpy.asarray, tree), toks)
    tparams = requires_grad(from_numpy_tree(tree, "cpu"))
    loss, metrics, grads = loss_and_grads(Model(tcfg, remat=True), tparams,
                                          {"tokens": torch.from_numpy(toks)})
    assert float(loss) == pytest.approx(total, rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(ce, rel=1e-5)
    assert_grads_close(jgrads, grads)


@pytest.mark.parametrize("scale", ["8m", "100m"])
def test_recipe_matches_reference(scale):
    """The port's copy of the recipe builds the reference's config: same
    fields, and an initial tree with the reference's paths (as
    ``jax.tree_util.keystr`` spells them) and shapes."""
    jcfg, tcfg = reference_recipe(scale), hybrid_lm(scale)
    assert repr(jcfg) == repr(tcfg).replace("repro_torch.", "repro.")
    assert tcfg.param_count() == jcfg.param_count()
    if scale == "8m":
        shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
        want = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(shapes)[0]]
        tree = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert [(p, tuple(x.shape))
                for p, x in tree_flatten_with_path(tree)] == want
