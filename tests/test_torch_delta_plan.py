"""The two phases of the delta-rule kernel, on the CPU: the plain mirror
in ``repro_torch.kernels.delta`` of what ``csrc/delta_hopper.cuh`` computes
(``wy_factors``: each chunk's W, U, M, gamma, kscale and g from its own
rows; ``state_pass``: the chunks in order against the state), held
against the port's plain chunked form ``delta_chunked_ref`` and against
the reference's Pallas ``delta_chunked`` / ``delta_chunked_fused`` in
interpret mode and its ``delta_chunked_jnp``, on inputs made by numpy from
a seed: masked lengths (0, mid-chunk, full), S not a multiple of the chunk
and S < 64, a nonzero initial state, decays down to log_a = -20.  With
``emulate=True`` the mirror rounds as the kernel's tensor-core products
do (each float32 operand split into two or three bf16 parts, ``PARTS``),
and must still meet the float32 tolerances at kimi-linear's head and round
its outputs to bf16 as the float32 plain version does almost everywhere.
The kernel itself runs on the card (``tests/test_torch_gpu.py``).

Tolerances: 1e-4 abs / 1e-3 rel on outputs and state (TOL_STATE of
``chip_smoke.py``, as ``tests/test_kernels_delta.py``): the phases sum in
another order than the chunked form, and a two-part split keeps ~16 of
float32's 24 bits.  Output rows at or past a length are unspecified and
not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta import delta_chunked as jax_delta
from repro.kernels.delta import delta_chunked_fused as jax_delta_fused
from repro.models.chunked_attention import delta_chunked_jnp
from repro_torch.kernels import delta as tdelta

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(seed, B, H, S, dk, dv, la_scale=0.1):
    """(q, k, v, log_a, beta, s0) as numpy: q, k L2-normalized (as KDA
    feeds them), beta in [0.1, 1), a nonzero initial state."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = r.standard_normal((B, H, S, dk)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    la = (-la_scale * np.abs(r.standard_normal((B, H, S)))).astype(np.float32)
    beta = r.uniform(0.1, 1.0, (B, H, S)).astype(np.float32)
    s0 = (0.1 * r.standard_normal((B, H, dk, dv))).astype(np.float32)
    return q, k, v, la, beta, s0


def _phases(args, lengths=None, emulate=False, dtype=torch.float32):
    q, k, v, la, beta, s0 = (torch.from_numpy(x) for x in args)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    f = tdelta.wy_factors(q, k, v, la, beta, lens, emulate=emulate)
    return tdelta.state_pass(f, s0, emulate=emulate)


def _plain(args, lengths=None):
    q, k, v, la, beta, s0 = (torch.from_numpy(x) for x in args)
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32)
        la, k, beta = tdelta.mask_padded(lens, q.shape[2], la, k, beta)
    return tdelta.delta_chunked_ref(q, k, v, la, beta, s0)


def _valid(S, lengths, B, H):
    if lengths is None:
        return np.ones((B, H, S), bool)
    return np.broadcast_to((np.arange(S)[None, :] < np.array(lengths)[:, None])
                           [:, None], (B, H, S))


def _close(o, st, want_o, want_st, valid):
    np.testing.assert_allclose(np.asarray(o)[valid], np.asarray(want_o)[valid],
                               **TOL)
    np.testing.assert_allclose(np.asarray(st), np.asarray(want_st), **TOL)


@pytest.mark.parametrize("B,H,S,dk,dv,lengths", [
    (2, 2, 130, 32, 48, (130, 57)),    # a tail chunk, a length mid-chunk
    (2, 2, 200, 16, 16, (0, 65)),      # a length 0, a length one past a chunk
    (1, 3, 40, 16, 24, None),          # S < 64, unmasked
    (1, 2, 1, 32, 32, None),           # S = 1
    (3, 1, 63, 64, 64, (1, 63, 20)),
])
def test_phases_match_the_chunked_form(B, H, S, dk, dv, lengths):
    """wy_factors + state_pass equal delta_chunked_ref on the masked rows."""
    args = _inputs(1, B, H, S, dk, dv)
    o, st = _phases(args, lengths)
    want_o, want_st = _plain(args, lengths)
    _close(o, st, want_o, want_st, _valid(S, lengths, B, H))


@pytest.mark.parametrize("S,lengths", [(130, None), (100, (100, 37)),
                                       (40, (40, 0))])
def test_phases_match_the_reference(S, lengths):
    """The same against the reference: its Pallas kernels in interpret
    mode (``delta_chunked_fused`` with lengths, ``delta_chunked`` without)
    and, unmasked, its ``delta_chunked_jnp``."""
    B, H, dk, dv = 2, 2, 16, 24
    args = _inputs(2, B, H, S, dk, dv)
    o, st = _phases(args, lengths)
    jargs = [jnp.asarray(x) for x in args]
    if lengths is None:
        wants = [jax_delta(*jargs, chunk=64, interpret=True),
                 delta_chunked_jnp(*jargs, chunk=64)]
    else:
        wants = [jax_delta_fused(*jargs[:5], jnp.asarray(lengths, jnp.int32),
                                 jargs[5], chunk=64, interpret=True)]
    for want_o, want_st in wants:
        _close(o, st, want_o, want_st, _valid(S, lengths, B, H))


def test_phases_take_strong_decays():
    """log_a near -20: exp underflows inside a chunk, every scale stays
    <= 1 and nothing overflows."""
    args = _inputs(3, 1, 2, 150, 32, 32, la_scale=20.0)
    o, st = _phases(args, (150,))
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    want_o, want_st = _plain(args, (150,))
    _close(o, st, want_o, want_st, _valid(150, (150,), 1, 2))


def test_rows_past_a_length_never_reach_the_state():
    """NaN in every row past a length (q, k, v, log_a, beta) changes no
    valid output and no state: phase 1 neutralizes those rows by
    selection, never by multiplying them by zero."""
    B, H, S = 2, 2, 100
    lengths = (37, 64)
    args = _inputs(4, B, H, S, 16, 16)
    poisoned = [x.copy() for x in args]
    dead = ~_valid(S, lengths, B, H)
    for x in poisoned[:5]:
        x[dead] = np.nan
    o, st = _phases(poisoned, lengths)
    want_o, want_st = _phases(args, lengths)
    assert torch.isfinite(st).all()
    _close(o, st, want_o, want_st, ~dead)


def test_beta_one_throughout():
    """beta = 1 on every row: the strongest overwrite the rule takes."""
    args = list(_inputs(5, 1, 2, 130, 32, 32))
    args[4] = np.ones_like(args[4])
    o, st = _phases(args)
    want_o, want_st = _plain(args)
    _close(o, st, want_o, want_st, _valid(130, None, 1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_products_meet_the_state_tolerance_at_kimi_head(dtype):
    """The kernel's precision, emulated: kimi-linear's KDA head (dk = dv =
    128) over 512 tokens, every product split as on the tensor cores (q, k,
    v taken unsplit when they are bf16), within TOL_STATE of the float32
    chunked form on the same (bf16-rounded) inputs, state and outputs."""
    args = _inputs(6, 1, 2, 512, 128, 128)
    o, st = _phases(args, emulate=True, dtype=dtype)
    q, k, v = (torch.from_numpy(x).to(dtype).float().numpy()
               for x in args[:3])
    want_o, want_st = _plain((q, k, v) + tuple(args[3:]))
    _close(o, st, want_o, want_st, _valid(512, None, 1, 2))


@pytest.mark.parametrize("parts,bits", [(2, 16), (3, 24)])
def test_split_bf16_keeps_the_bits(parts, bits):
    """Two bf16 parts keep 16 of float32's 24 significand bits, three all
    of them; every part is a bf16 value."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (64, 64)).astype(np.float32))
    ps = tdelta.split_bf16(x, parts)
    for p in ps:
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert float(((sum(ps) - x).abs() / x.abs()).max()) <= 2.0 ** -bits
    # an operand exact in bf16 is taken in one part: the plain product
    a = ps[0][:, :32]
    assert torch.equal(tdelta.split_matmul(a, a.T, 1, 1), a @ a.T)


@pytest.mark.parametrize("parts,within", [
    (None, True),                                        # the kernel's
    ({"T": 2, "W": 2, "M": 2, "S": 2, "u": 2}, False),   # two everywhere
])
def test_split_products_round_like_float32(parts, within, monkeypatch):
    """The outputs the kernel rounds to bf16 agree with the float32 plain
    version's rounding almost everywhere: at kimi-like inputs (bf16 q, k,
    v; values up to ~10; decays down to -4) the emulated split products
    give another bf16 value in at most 2e-4 of the outputs.  Two parts
    everywhere, which meets every float32 tolerance, exceed it: on the
    H100 that kernel moved kimi-linear's bf16 prefill logits by 15 % of
    the largest through its expert routing (``chip_smoke.py``, gate 2 %)."""
    if parts is not None:
        monkeypatch.setattr(tdelta, "PARTS", parts)
    r = np.random.default_rng(9)
    B, H, S, d = 1, 8, 512, 128
    q, k, v, la, beta, s0 = _inputs(9, B, H, S, d, d)
    v = 3.0 * v
    la = (-r.uniform(0.1, 2.0, (B, H, S)) ** 2).astype(np.float32)
    beta = r.uniform(0.01, 1.0, (B, H, S)).astype(np.float32)
    args = (q, k, v, la, beta, np.zeros_like(s0))
    o, _ = _phases(args, emulate=True, dtype=torch.bfloat16)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in (q, k, v))
    want, _ = _plain((q, k, v, la, beta, np.zeros_like(s0)))
    flips = (o.to(torch.bfloat16) != want.to(torch.bfloat16)).float().mean()
    assert (float(flips) <= 2e-4) == within
