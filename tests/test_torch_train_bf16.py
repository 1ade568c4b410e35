"""The port's bf16 training gradients against the reference's, on the CPU,
for ``zamba2-1.2b`` at smoke size: the reference's init (Mamba2 gates
drawn nonzero) rounded to bf16, the same tokens, through the port's
``train_loss`` and autograd and through ``jax.value_and_grad`` of the
reference's ``train_loss``, in bf16 and, on the same weights' values, in
float32.

bf16 gradients differ from float32 ones by rounding that the depth
compounds, so the bf16 path is held to the reference's own bf16 rounding
rather than to fixed digits: the port's bf16 gradients must lie no further
(relative L2) from the reference's float32 gradients than 1.5x the
reference's bf16 gradients do (measured: 0.139 against 0.132).  On these
weights that distance is ~13 %, so a fault on the bf16 path would show.
Random weights drawn as ``init_params`` draws them (as ``chip_smoke.py``
trains) are far worse conditioned: the embedding (std 0.02) is swamped in
the bf16 residual stream and the RMSNorm above it divides the rounding by
~0.02, so there the reference's own bf16 gradients lie 1.24x their size
from its float32 ones (the port's 1.57x; at S = 256 1.12x and 1.22x).
The bf16 losses agree within 1e-3 relative, the float32 ones within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, flatten, shared_params
from repro.models import Model as JaxModel
from repro_torch.models import Model
from repro_torch.params import from_numpy_tree, requires_grad
from repro_torch.training import loss_and_grads

torch.set_num_threads(1)
ARCH = "zamba2-1.2b"
S = 48


def _rel_l2(got, want):
    d = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return (d / sum(float((b ** 2).sum()) for b in want)) ** 0.5


@pytest.fixture(scope="module")
def grads():
    """{(framework, dtype): (loss, [float32 gradient leaves])}."""
    jcfg, tcfg = configs(arch=ARCH)
    jparams, _ = shared_params(jcfg)
    w16 = jax.tree.map(lambda x: np.asarray(
        x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x), jparams)
    w32 = jax.tree.map(lambda x: np.asarray(x, np.float32)
                       if x.dtype == jnp.bfloat16 else x, w16)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, S + 1)).astype(np.int32)
    out = {}
    for dtype, w in (("bf16", w16), ("f32", w32)):
        jc, tc = (dataclasses.replace(c, dtype="bfloat16") if dtype == "bf16"
                  else c for c in (jcfg, tcfg))
        fn = jax.jit(jax.value_and_grad(
            JaxModel(jc, use_kernels=False, remat=True).train_loss,
            has_aux=True))
        (loss, _), g = fn(jax.tree.map(jnp.asarray, w),
                          {"tokens": jnp.asarray(toks)})
        out["jax", dtype] = (float(loss), [
            np.asarray(x, np.float32)
            for _, x in flatten(jax.tree.map(np.asarray, g))])
        loss, _, g = loss_and_grads(
            Model(tc, remat=True), requires_grad(from_numpy_tree(w, "cpu")),
            {"tokens": torch.from_numpy(toks)})
        out["torch", dtype] = (float(loss), [
            np.asarray(x, np.float32) for _, x in flatten(g)])
    return out


def test_bf16_loss_matches_reference(grads):
    assert grads["torch", "bf16"][0] == pytest.approx(
        grads["jax", "bf16"][0], rel=1e-3)
    assert grads["torch", "f32"][0] == pytest.approx(
        grads["jax", "f32"][0], rel=1e-5)


def test_bf16_grads_as_close_to_float32_as_the_reference(grads):
    want = grads["jax", "f32"][1]
    port = _rel_l2(grads["torch", "bf16"][1], want)
    ref = _rel_l2(grads["jax", "bf16"][1], want)
    assert all(np.isfinite(g).all() for g in grads["torch", "bf16"][1])
    assert port <= 1.5 * ref, (port, ref)
