"""The port's gated linear attention (Mamba2's mixer core) against the
reference, on the CPU, with inputs made by numpy from a seed:

  * the plain ``ops.gla`` (the CUDA kernel's plain version) against the
    reference's Pallas ``gla_chunked_fused`` in interpret mode, its
    ``ops.gla`` (the jnp chunked form the CPU model runs) and the
    sequential oracle ``ref.gla_ref`` on the masked inputs: ragged
    lengths, a nonzero initial state, S not a multiple of the chunk and
    S < 8, ``lengths=None``, at smoke (16, 16) and full (64, 128) widths;
  * ``gla_step`` against ``ref.gla_step_ref``;
  * the Mamba2 mixer's ``linear_forward`` (padded rows, carried state and
    conv window) and ``linear_decode`` against the reference's, with
    nonzero ``A_log`` / ``dt_bias`` / ``D_skip``.

Tolerances: the scan 1e-4 abs / 1e-4 rel in float32 (chunked against
sequential sums, and the Pallas wrapper's chunk of max(S, 8) against the
jnp form's min(S, 64) for S < 8, which differ only in masked padding);
the mixer 1e-4 / 1e-4.  Output rows at or past a row's length are
unspecified and not compared.  The CUDA kernel itself is checked on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nonzero_mamba2_gates
from repro.configs.base import LinearSpec as JaxLinearSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gla import gla_chunked as jax_gla_plain_kernel
from repro.kernels.gla import gla_chunked_fused as jax_gla_kernel
from repro.models import linear_attention as jlin
from repro_torch.configs.base import LinearSpec
from repro_torch.kernels import build, ops
from repro_torch.kernels.gla import CHUNK, gla_chunked_fused
from repro_torch.models import linear_attention as tlin
from repro_torch.params import from_numpy_tree

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, H, S, dk, dv):
    """q, k at the Mamba2 scale (k by dk^-0.5), decays from mild to strong,
    a nonzero initial state."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = (r.standard_normal((B, H, S, dk)) * dk ** -0.5).astype(np.float32)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    la = (-r.uniform(0.0, 1.0, (B, H, S)) ** 3 * 2.0).astype(np.float32)
    s0 = (0.5 * r.standard_normal((B, H, dk, dv))).astype(np.float32)
    return q, k, v, la, s0


def _masked(lengths, S, la, k):
    """The reference's padded-row neutralization, in numpy."""
    valid = np.arange(S)[None, :] < lengths[:, None]
    return (np.where(valid[:, None], la, 0.0).astype(np.float32),
            np.where(valid[:, None, :, None], k, 0.0).astype(np.float32))


def _valid(lengths, B, H, S):
    valid = np.arange(S)[None, :] < lengths[:, None]
    return np.broadcast_to(valid[:, None], (B, H, S))


@pytest.mark.parametrize("B,H,S,dk,dv,lens", [
    (2, 2, 96, 16, 16, (96, 41)),          # ragged, two chunks
    (2, 3, 70, 16, 16, (3, 70)),           # S not a multiple of 64
    (2, 2, 5, 16, 16, (5, 2)),             # S < 8
    (2, 2, 130, 64, 128, (130, 77)),       # the zamba2 head: dk 64, dv 128
    (1, 2, 64, 64, 128, (0,)),             # no valid row: s0 passes through
])
def test_gla_plain_matches_reference(B, H, S, dk, dv, lens):
    q, k, v, la, s0 = _inputs(0, B, H, S, dk, dv)
    lengths = np.array(lens, np.int32)
    o, st = ops.gla(*map(torch.from_numpy, (q, k, v, la, s0)),
                    lengths=torch.from_numpy(lengths))
    jargs = [jnp.asarray(x) for x in (q, k, v, la)]
    po, pst = jax_gla_kernel(*jargs, jnp.asarray(lengths), jnp.asarray(s0),
                             chunk=CHUNK, interpret=True)
    jo, jst = jops.gla(*jargs, jnp.asarray(s0),
                       lengths=jnp.asarray(lengths), chunk=CHUNK)
    mla, mk = _masked(lengths, S, la, k)
    so, sst = jref.gla_ref(jnp.asarray(q), jnp.asarray(mk), jnp.asarray(v),
                           jnp.asarray(mla), jnp.asarray(s0))
    sel = _valid(lengths, B, H, S)
    for want_o, want_st in ((po, pst), (jo, jst), (so, sst)):
        np.testing.assert_allclose(o.numpy()[sel], np.asarray(want_o)[sel],
                                   **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)
    if not lengths.any():
        np.testing.assert_array_equal(st.numpy(), s0)


@pytest.mark.parametrize("S", [70, 6, 100])
def test_gla_without_lengths_matches_reference(S):
    """``lengths=None``: every row counts (the plain chunked form alone, the
    plain version of the unmasked kernel, row 6); against the reference's
    unmasked Pallas kernel, its ``ops.gla`` and the sequential oracle."""
    B, H, dk, dv = 2, 2, 16, 24
    q, k, v, la, s0 = _inputs(1, B, H, S, dk, dv)
    o, st = ops.gla(*map(torch.from_numpy, (q, k, v, la, s0)))
    jargs = [jnp.asarray(x) for x in (q, k, v, la, s0)]
    for want_o, want_st in (jax_gla_plain_kernel(*jargs, chunk=CHUNK,
                                                 interpret=True),
                            jops.gla(*jargs, chunk=CHUNK),
                            jref.gla_ref(*jargs)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)


def test_gla_step_matches_reference():
    q, k, v, la, s0 = _inputs(2, 2, 3, 1, 16, 24)
    args = (q[:, :, 0], k[:, :, 0], v[:, :, 0], la[:, :, 0], s0)
    o, st = ops.gla_step(*map(torch.from_numpy, args))
    jo, jst = jref.gla_step_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=2e-5,
                               rtol=2e-5)


def test_cpu_tensors_take_the_plain_gla():
    """On the CPU ``ops.gla`` runs the plain version (no launch counted);
    the CUDA wrapper refuses CPU tensors instead of falling back."""
    build.reset_launches()
    x = torch.randn(1, 2, 8, 16)
    lens = torch.full((1,), 8, dtype=torch.int32)
    ops.gla(x, x, x, torch.zeros(1, 2, 8), lengths=lens)
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        gla_chunked_fused(x, x, x, torch.zeros(1, 2, 8), lens,
                          torch.zeros(1, 2, 16, 16))


# ------------------------------------------------------------- the mixer


def _mixer(dk, dv):
    """A Mamba2 mixer's params (reference init, nonzero gates) in both
    frameworks, with its spec in each."""
    kw = dict(kind="mamba2", heads=2, key_dim=dk, value_dim=dv,
              conv_kernel=4)
    jspec, tspec = JaxLinearSpec(**kw), LinearSpec(**kw)
    p = jlin.init_linear_mixer(jax.random.PRNGKey(3), 32, jspec, jnp.float32)
    tree = nonzero_mamba2_gates(jax.tree.map(np.asarray, p), seed=3)
    return (jspec, jax.tree.map(jnp.asarray, tree), tspec,
            from_numpy_tree(tree, "cpu"))


@pytest.mark.parametrize("dk,dv", [(16, 16), (16, 24)])
def test_mamba2_mixer_matches_reference(dk, dv):
    """Two prefill chunks of a right-padded batch (the second continuing
    from the first's state and conv window), then two decode steps: outputs
    and caches against the reference's."""
    jspec, jp, tspec, tp = _mixer(dk, dv)
    r = np.random.default_rng(4)
    B, S = 2, 40
    x = r.standard_normal((B, 2 * S, 32)).astype(np.float32)
    lens = [np.array([40, 40], np.int32), np.array([40, 13], np.int32)]
    jcache, tcache = {}, {}
    for i in range(2):
        xi = x[:, i * S:(i + 1) * S]
        jy, jcache = jlin.linear_forward(
            jp, jnp.asarray(xi), jspec, initial_state=jcache.get("state"),
            conv_state=jcache.get("conv"), lengths=jnp.asarray(lens[i]),
            use_kernels=False)
        ty, tcache = tlin.linear_forward(
            tp, torch.from_numpy(xi), tspec,
            initial_state=tcache.get("state"), conv_state=tcache.get("conv"),
            lengths=torch.from_numpy(lens[i]))
        sel = np.arange(S)[None, :] < lens[i][:, None]
        np.testing.assert_allclose(ty.numpy()[sel], np.asarray(jy)[sel],
                                   **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)
    for t in range(2):
        xt = r.standard_normal((B, 1, 32)).astype(np.float32)
        jy, jcache = jlin.linear_decode(jp, jnp.asarray(xt), jspec, jcache)
        ty, tcache = tlin.linear_decode(tp, torch.from_numpy(xt), tspec,
                                        tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)
