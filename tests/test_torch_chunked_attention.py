"""The port's chunked plain attention against the reference's, on the CPU,
float32: ``swa_banded`` and ``mea_attention``
(``src/repro/models/chunked_attention.py``) forward and gradients at
1100-1300 keys with narrow heads (GQA with G 4, Dk 192 / Dv 128, causal
and not, a window, a ``q_offset``, cross-attention with Sq != Sk and
mea's bottom-right alignment), and ``ops.attention``'s choice of plain
version (``plain_attention_route``) against the branch the reference's
``_attention_jnp`` takes, on a table of shapes.

Tolerances: outputs and gradients within 2e-5 abs / 1e-4 rel (float32
products and softmax sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import chunked_attention as jchk
from repro_torch.kernels import ops
from repro_torch.models import chunked_attention as tchk

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(B, Hq, Hkv, Sq, Sk, Dk, Dv, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, up = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, Dk), (B, Hkv, Sk, Dk), (B, Hkv, Sk, Dv), (B, Hq, Sq, Dv)))
    return q, k, v, up


def _check(jfn, tfn, q, k, v, up):
    """Outputs and the gradients of sum(out * up) for q, k, v."""
    def loss(q, k, v):
        return jnp.sum(jfn(q, k, v) * up)

    want = np.asarray(jfn(q, k, v))
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(up)).sum(), ts)
    for name, a, b in zip("qkv", jgrads, grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("Hq,Hkv,S,Dk,Dv,window,block_q", [
    (8, 2, 1100, 192, 128, 300, 512),     # GQA G 4, Dk != Dv, S % 512 != 0
    (4, 4, 1300, 32, 32, 512, 512),       # MHA, band of two blocks
    (6, 1, 1200, 16, 8, 200, 256),        # MQA, another block size
])
def test_swa_banded_matches_reference(Hq, Hkv, S, Dk, Dv, window, block_q):
    q, k, v, up = _inputs(1, Hq, Hkv, S, S, Dk, Dv)
    _check(lambda q, k, v: jchk.swa_banded(q, k, v, window=window,
                                           block_q=block_q),
           lambda q, k, v: tchk.swa_banded(q, k, v, window=window,
                                           block_q=block_q),
           q, k, v, up)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dk,Dv,causal,window,q_offset", [
    (1, 8, 2, 1100, 1100, 192, 128, True, 0, 0),     # GQA G 4, causal
    (2, 4, 4, 1200, 1200, 32, 32, False, 0, 0),      # encoder, not causal
    (1, 4, 2, 1300, 1300, 32, 16, True, 400, 0),     # a window
    (1, 4, 1, 300, 1250, 32, 32, True, 0, 950),      # a chunk after 950
    (1, 4, 4, 700, 1150, 32, 32, False, 0, 0),       # cross, Sq != Sk
    (1, 4, 2, 600, 1100, 32, 32, True, 0, 0),        # bottom-right
    (1, 4, 2, 600, 1100, 32, 32, True, 256, 100),    # window and offset
])
def test_mea_attention_matches_reference(B, Hq, Hkv, Sq, Sk, Dk, Dv, causal,
                                         window, q_offset):
    q, k, v, up = _inputs(B, Hq, Hkv, Sq, Sk, Dk, Dv, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _check(lambda q, k, v: jchk.mea_attention(q, k, v, **kw),
           lambda q, k, v: tchk.mea_attention(q, k, v, **kw),
           q, k, v, up)


def test_mea_aligns_bottom_right():
    """With q_offset 0, causal and Sq != Sk, the queries are the last Sq
    positions: the same as an explicit q_offset of Sk - Sq."""
    q, k, v, _ = _inputs(1, 2, 2, 300, 1100, 16, 16, seed=2)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    torch.testing.assert_close(
        tchk.mea_attention(q, k, v, causal=True),
        tchk.mea_attention(q, k, v, causal=True, q_offset=800),
        atol=0, rtol=0)


# (Sq, Sk, causal, window): each branch and its edges
ROUTE_SHAPES = [
    (1024, 1024, True, 0), (1024, 1024, True, 256), (512, 1024, True, 0),
    (1025, 1025, True, 0), (2048, 2048, False, 0), (2048, 2048, True, 1024),
    (2048, 2048, True, 1025), (1100, 1100, True, 550), (8192, 8192, True,
                                                         4096),
    (4096, 8192, True, 4096), (8192, 8192, False, 4096), (1600, 1600, True, 0),
    (1024, 2048, False, 0), (2048, 1024, False, 0), (300, 5000, True, 4096),
]


@pytest.mark.parametrize("Sq,Sk,causal,window", ROUTE_SHAPES)
def test_plain_route_matches_reference(monkeypatch, Sq, Sk, causal, window):
    """The reference's ``_attention_jnp`` branch, recorded by standing in
    for the three functions it may call."""
    taken = []

    def stand_in(name):
        def fn(q, k, v, **kw):
            taken.append(name)
            return q
        return fn

    monkeypatch.setattr(jops.ref, "flash_attention_ref",
                        stand_in("quadratic"))
    monkeypatch.setattr(jops.chk, "swa_banded", stand_in("swa_banded"))
    monkeypatch.setattr(jops.chk, "mea_attention", stand_in("mea"))
    jops._attention_jnp(jnp.zeros((1, 1, Sq, 1)), jnp.zeros((1, 1, Sk, 1)),
                        jnp.zeros((1, 1, Sk, 1)), causal=causal,
                        window=window)
    assert taken == [ops.plain_attention_route(Sq, Sk, causal=causal,
                                               window=window)]


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 500, 0), (True, 0, 0), (False, 0, 0), (True, 0, 200)])
def test_ops_attention_matches_reference_plain(causal, window, q_offset):
    """``ops.attention`` on CPU tensors against the reference's
    ``_attention_jnp`` past ``SMALL_SEQ`` keys, forward and gradients."""
    Sq = 1200 - q_offset
    q, k, v, up = _inputs(1, 4, 2, Sq, 1200, 32, 24, seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _check(lambda q, k, v: jops._attention_jnp(q, k, v, **kw),
           lambda q, k, v: ops.attention(q, k, v, **kw), q, k, v, up)
