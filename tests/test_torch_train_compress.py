"""The port's train step with int8 error-feedback gradient compression
against the reference's, on the CPU, on zamba2 at smoke size with two
microbatches.  Both frameworks compress the same float32 gradient sums
(the port's step is fed the reference's microbatch gradients), so the
int8 bytes and scales must be identical, which the bit-identical
residuals show; the updates then agree to float32 rounding (1e-6 abs /
1e-5 rel; the global norm sums leaves in another order).  An end-to-end
comparison, each framework with its own gradients (as
``tests/test_torch_train_step.py`` makes without compression), would let
an element within rounding of an int8 boundary quantize one step apart.

The reference's part runs eagerly, op by op, as the port does: jitted, XLA
may fuse the sum and the quantization and round differently.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_trees_close, flatten
from repro.distributed import collectives as jcoll
from repro.models import Model as JaxModel
from repro.training import optimizer as jopt
from repro_torch.params import from_numpy_tree
from repro_torch.training import train_loop as tloop
from test_torch_train_step import _numpy, _step_setup

torch.set_num_threads(1)


def test_compressed_train_steps_match_reference(monkeypatch):
    """Two steps, the port's step fed the reference's microbatch gradients
    (at the reference's params).  The reference's step is composed from its
    own parts (its float32 microbatch sum, ``compress_grads_with_feedback``
    and ``apply_updates``), as its ``make_train_step`` composes them."""
    (jcfg, jparams, jtc, jstate, tmodel, tparams, ttc, tstate,
     data) = _step_setup(True)
    grad_fn = jax.jit(jax.value_and_grad(
        JaxModel(jcfg, use_kernels=False, remat=True).train_loss,
        has_aux=True))
    apply = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jtc.adamw))

    def compress(mb_grads, residuals):            # eager (module doc)
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                           jparams)
        for g in mb_grads:
            acc = jax.tree.map(jnp.add, acc, g)
        return jcoll.compress_grads_with_feedback(
            jax.tree.map(lambda g: g / 2, acc), residuals)

    fed = []

    def fed_loss_and_grads(model, params, mb):
        loss, grads = fed.pop(0)
        return torch.tensor(loss), {}, from_numpy_tree(_numpy(grads), "cpu")

    monkeypatch.setattr(tloop, "loss_and_grads", fed_loss_and_grads)
    tstep = tloop.make_train_step(tmodel, ttc)
    for step in range(2):
        tokens = jnp.asarray(data.batch(step)["tokens"])
        mbs = [grad_fn(jparams, {"tokens": tokens[i:i + 2]})
               for i in (0, 2)]
        fed.extend((float(l), g) for (l, _), g in mbs)
        grads, res = compress([g for _, g in mbs], jstate["residuals"])
        inner = {k: v for k, v in jstate.items() if k != "residuals"}
        jparams, inner, jm = apply(jparams, grads, inner)
        jstate = {**inner, "residuals": res}
        tparams, tstate, tm = tstep(tparams, tstate, data.batch(step))
        assert not fed
        for (path, a), (_, b) in zip(flatten(_numpy(res)),
                                     flatten(tstate["residuals"])):
            assert a.tobytes() == b.tobytes(), (step, path)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    assert_trees_close(_numpy(jparams), tparams, atol=1e-6, rtol=1e-5)
    for key in ("mu", "nu", "master"):
        assert_trees_close(_numpy(jstate[key]), tstate[key], atol=1e-6,
                           rtol=1e-5)
