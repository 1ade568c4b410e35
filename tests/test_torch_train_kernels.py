"""The training path's kernel ops against the reference, on the CPU, with
inputs and cotangents made by numpy from a seed:

  * the plain ``ops.delta`` without ``lengths`` (the plain version of the
    unmasked CUDA kernel, row 5) against the reference's unmasked Pallas
    kernel ``delta_chunked`` in interpret mode and its ``ops.delta`` on
    the CPU (the jnp chunked form), with a nonzero initial state, at S =
    100 and S < 8 (row 6's plain version, ``ops.gla`` without
    ``lengths``, is held so in ``tests/test_torch_gla.py``);
  * their gradients (q, k, v, log_a, beta, initial state), with and
    without ``lengths``, and those of ``ops.attention`` (GQA, and MLA's
    Dk != Dv), against ``jax.vjp`` of the reference's ops under
    ``FORCE_KERNEL_ON_CPU``: its ``custom_vjp``s, whose forward is the
    Pallas kernel in interpret mode and whose backward is the VJP of the
    jnp oracle, recomputed;
  * the port's CUDA-path wiring (``ops.RecomputeGrad``) with each kernel
    swapped for its plain version: the same gradients as autograd through
    the plain version, and the unmasked kernels chosen when ``lengths`` is
    None.

Tolerances: outputs 1e-4 abs / 1e-4 rel in float32 (chunked sums in other
orders; for S < 8 the Pallas wrapper's chunk of max(S, 8) adds neutral
zero rows that the jnp form's chunk of S does not have, which changes only
the summation order); gradients 2e-4 abs / 2e-4 rel (the same, through a
backward of exponentials and, for the delta rule, the Neumann inverse).
The swapped-forward check is exact: both sides run the same plain graph
on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.delta import delta_chunked as jax_delta_kernel
from repro_torch.kernels import delta as tdelta
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import gla as tgla
from repro_torch.kernels import ops

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
GTOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(op, seed, B, H, S, dk, dv):
    """(q, k, v, log_a[, beta], s0) as numpy: the delta rule's q, k
    L2-normalized (as KDA feeds it), Mamba2-scaled k for gla, decays from
    mild to strong, a nonzero initial state."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = r.standard_normal((B, H, S, dk)).astype(np.float32)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    s0 = (0.3 * r.standard_normal((B, H, dk, dv))).astype(np.float32)
    if op == "delta":
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        k /= np.linalg.norm(k, axis=-1, keepdims=True)
        la = (-0.1 * np.abs(r.standard_normal((B, H, S)))).astype(np.float32)
        beta = r.uniform(0.1, 1.0, (B, H, S)).astype(np.float32)
        return q, k, v, la, beta, s0
    k *= dk ** -0.5
    la = (-r.uniform(0.0, 1.0, (B, H, S)) ** 3 * 2.0).astype(np.float32)
    return q, k, v, la, s0


def _port_op(op):
    return ops.delta if op == "delta" else ops.gla


def _jax_op(op):
    return jops.delta if op == "delta" else jops.gla


def _cotangents(seed, o_shape, s_shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(o_shape).astype(np.float32),
            r.standard_normal(s_shape).astype(np.float32))


@pytest.mark.parametrize("S", [100, 6])
def test_delta_without_lengths_matches_reference(S):
    """``lengths=None`` on the CPU: the plain chunked form alone (the plain
    version of the unmasked kernel, row 5), against the reference's
    unmasked Pallas kernel and its CPU ``ops.delta``.  (The gla case is
    ``tests/test_torch_gla.py::test_gla_without_lengths_matches_reference``.)"""
    B, H, dk, dv = 2, 2, 16, 24
    args = _inputs("delta", 1, B, H, S, dk, dv)
    o, st = ops.delta(*map(torch.from_numpy, args))
    jargs = [jnp.asarray(x) for x in args]
    for want_o, want_st in (jax_delta_kernel(*jargs, chunk=64,
                                             interpret=True),
                            jops.delta(*jargs, chunk=64)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **TOL)


@pytest.mark.parametrize("op", ["delta", "gla"])
@pytest.mark.parametrize("S,lens", [(100, None), (6, None), (100, (100, 37))])
def test_grads_match_reference_custom_vjp(op, S, lens, monkeypatch):
    """Gradients of every input through the port's op (autograd through the
    plain version on the CPU) against ``jax.vjp`` of the reference's op
    through its ``custom_vjp`` (Pallas forward in interpret mode, jnp VJP
    backward; masked ops with their ``_mask_padded`` inside)."""
    monkeypatch.setattr(jops, "FORCE_KERNEL_ON_CPU", True)
    B, H, dk, dv = 2, 2, 16, 24
    args = _inputs(op, 2, B, H, S, dk, dv)
    g_o, g_s = _cotangents(3, (B, H, S, dv), (B, H, dk, dv))
    kw = {} if lens is None else {"lengths": np.array(lens, np.int32)}

    def jfn(*a):
        return _jax_op(op)(*a, chunk=64, **{k: jnp.asarray(v)
                                            for k, v in kw.items()})

    (jo, jst), vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_s)))

    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    o, st = _port_op(op)(*xs, **{k: torch.from_numpy(v)
                                 for k, v in kw.items()})
    got = torch.autograd.grad((o, st), xs, (torch.from_numpy(g_o),
                                            torch.from_numpy(g_s)))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(jst), **TOL)
    if lens is None:
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    for name, g, w in zip(("q", "k", "v", "log_a", "beta", "s0")
                          if op == "delta" else ("q", "k", "v", "log_a", "s0"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GTOL)


@pytest.mark.parametrize("Hq,Hkv,S,Dk,Dv", [
    (4, 2, 40, 16, 16),          # GQA
    (4, 4, 40, 24, 16),          # MLA in MHA form: Dk = nope + rope != Dv
])
def test_attention_grads_match_reference_custom_vjp(Hq, Hkv, S, Dk, Dv,
                                                     monkeypatch):
    monkeypatch.setattr(jops, "FORCE_KERNEL_ON_CPU", True)
    r = np.random.default_rng(4)
    q = r.standard_normal((2, Hq, S, Dk)).astype(np.float32)
    k = r.standard_normal((2, Hkv, S, Dk)).astype(np.float32)
    v = r.standard_normal((2, Hkv, S, Dv)).astype(np.float32)
    g = r.standard_normal((2, Hq, S, Dv)).astype(np.float32)
    scale = Dk ** -0.5
    jo, vjp = jax.vjp(lambda *a: jops.attention(*a, causal=True, scale=scale,
                                                block_q=8, block_k=8),
                      *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.attention(*xs, causal=True, scale=scale)
    got = torch.autograd.grad(o, xs, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
    for name, a, b in zip("qkv", got, want):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GTOL)


def _swap_kernels(monkeypatch, launched):
    """Take the CUDA path on CPU tensors, each kernel wrapper replaced by
    its plain version (recording its name)."""
    def masked(plain, mask):
        def run(*a):
            *head, lengths, s0 = a
            S = head[0].shape[2]
            return plain(*mask(head, lengths, S), s0)
        return run

    def gla_mask(head, lengths, S):
        q, k, v, la = head
        la, k = tgla.mask_padded(lengths, S, la, k)
        return q, k, v, la

    def delta_mask(head, lengths, S):
        q, k, v, la, beta = head
        la, k, beta = tdelta.mask_padded(lengths, S, la, k, beta)
        return q, k, v, la, beta

    kernels = {
        (tflash, "flash_attention"): tflash.flash_attention_ref,
        (tgla, "gla_chunked"): tgla.gla_chunked_ref,
        (tgla, "gla_chunked_fused"): masked(tgla.gla_chunked_ref, gla_mask),
        (tdelta, "delta_chunked"): tdelta.delta_chunked_ref,
        (tdelta, "delta_chunked_fused"): masked(tdelta.delta_chunked_ref,
                                                delta_mask),
    }
    for (mod, name), fn in kernels.items():
        def record(*a, _name=name, _fn=fn, **kw):
            launched.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, record)
    monkeypatch.setattr(ops, "_plain", lambda use_kernel, x: not use_kernel)


@pytest.mark.parametrize("op,lens,kernel", [
    ("gla", None, "gla_chunked"),
    ("gla", (100, 37), "gla_chunked_fused"),
    ("delta", None, "delta_chunked"),
    ("delta", (100, 37), "delta_chunked_fused"),
    ("attention", None, "flash_attention"),
])
def test_recompute_grad_equals_plain_autograd(op, lens, kernel, monkeypatch):
    """The CUDA path's ``RecomputeGrad`` with its forward swapped for the
    plain version: the kernel it would launch (the unmasked one without
    ``lengths``), and the same gradients as autograd through the plain
    version, bit for bit."""
    B, H, S, dk, dv = 2, 2, 100, 16, 24
    if op == "attention":
        args = [np.random.default_rng(5).standard_normal(
            (B, H, S, dk)).astype(np.float32) for _ in range(3)]
    else:
        args = _inputs(op, 5, B, H, S, dk, dv)
    kw = {} if lens is None else {"lengths": torch.tensor(lens)}
    fn = getattr(ops, op)

    def grads():
        xs = [torch.from_numpy(a).requires_grad_() for a in args]
        out = fn(*xs, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)
                    ).sum() for o in outs)
        return torch.autograd.grad(loss, xs)

    want = grads()
    launched = []
    _swap_kernels(monkeypatch, launched)
    got = grads()
    assert launched == [kernel]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
