"""The port's training loss and gradients against the reference's, on the
CPU, float32, for the encoder-decoder (``seamless-m4t-medium``: frames
through ``enc_proj``, the bidirectional encoder and ``enc_norm``, the
decoder's cross-attention over them) and the VLM (``phi-3-vision-4.2b``:
``patches`` through ``patch_proj``, prepended to the tokens, their
positions left out of the loss) at smoke size.  The same numpy weights,
tokens, frames and patches (``_torch_parity.train_batch``, the reference's
``make_batch``) go through ``Model.train_loss`` and autograd here and
``jax.value_and_grad`` there; one ``make_train_step`` step with two
microbatches (the frames or patches split with the tokens) against the
reference's jitted step.

Tolerances: the loss 1e-5 relative, gradient leaves 1e-4 abs / 1e-3 rel;
the step's loss, grad norm and lr 1e-5 relative, params and moments 1e-4
abs / 1e-3 rel (``tests/test_torch_train_step.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_train_matches, assert_trees_close,
                           configs, drawn_params, reference_train_loss,
                           train_batch)
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.models import Model
from repro_torch.params import requires_grad
from repro_torch.training import loss_and_grads
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
# the leaves only the encoder or the image prefix reaches
OWN_LEAVES = {"seamless-m4t-medium": ("enc_proj", "enc_groups", "enc_norm"),
              "phi-3-vision-4.2b": ("patch_proj",)}


@pytest.mark.parametrize("arch,S", [("seamless-m4t-medium", 48),
                                    ("phi-3-vision-4.2b", 48)])
def test_train_loss_and_grads_match_reference(arch, S):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    batch = train_batch(tcfg, 2, S)
    ref = reference_train_loss(jcfg, jparams, batch)
    got = loss_and_grads(Model(tcfg, remat=True), requires_grad(tparams),
                         batch)
    assert ref[2] == float(got[1]["aux"]) == 0.0
    assert_train_matches(ref, got)
    for name in OWN_LEAVES[arch]:
        leaves = jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), got[2][name]))
        assert sum(float(np.abs(x).sum()) for x in leaves) > 0, name


def test_vlm_loss_leaves_out_the_patches():
    """The VLM's loss is the CE of its token positions alone: the same as
    the CE of the decoder's output after the patches."""
    _, tcfg = configs(arch="phi-3-vision-4.2b")
    _, tparams = drawn_params(tcfg)
    batch = train_batch(tcfg, 2, 20)
    model = Model(tcfg)
    with torch.no_grad():
        loss, m = model.train_loss(tparams, batch)
        tokens = torch.from_numpy(batch["tokens"]).long()
        x, pos, n = model._decoder_input(
            tparams, {"tokens": tokens[:, :-1],
                      "patches": torch.from_numpy(batch["patches"])})
        x, _ = model._train_groups(tparams["groups"], x, pos)
        ce = model._chunked_ce(tparams, x[:, n:], tokens[:, 1:])
    assert n == tcfg.num_image_patches
    assert float(loss) == float(m["ce"]) == float(ce)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_train_step_matches_reference(arch):
    """One train step, two microbatches: the frames or patches are split
    with the tokens and reach each microbatch's loss."""
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    # the port updates its params in place: the reference's (asynchronous)
    # step must not read a buffer it shares with them
    jparams = jax.tree.map(jnp.copy, jparams)
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jtc = jloop.TrainConfig(adamw=jopt.AdamWConfig(**adam), microbatches=2)
    ttc = tloop.TrainConfig(adamw=topt.AdamWConfig(**adam), microbatches=2)
    jstate = jloop.init_opt_state(jparams, jtc)
    tparams = requires_grad(tparams)
    tstate = tloop.init_opt_state(tparams, ttc)
    batch = train_batch(tcfg, 4, 24, seed=1)
    jstep = jax.jit(jloop.make_train_step(
        JaxModel(jcfg, use_kernels=False, remat=True), jtc))
    jparams, jstate, jm = jstep(jparams, jstate,
                                jax.tree.map(jnp.asarray, batch))
    tparams, tstate, tm = tloop.make_train_step(
        Model(tcfg, remat=True), ttc)(tparams, tstate, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
    assert_trees_close(jax.tree.map(np.asarray, jparams), tparams,
                       atol=1e-4, rtol=1e-3)
    for key in ("mu", "nu"):
        assert_trees_close(jax.tree.map(np.asarray, jstate[key]),
                           tstate[key], atol=1e-4, rtol=1e-3)
