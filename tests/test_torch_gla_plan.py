"""The three phases of the bf16 gated-linear-attention core, on the CPU:
the plain mirror in ``repro_torch.kernels.gla`` of what
``csrc/gla_hopper.cuh`` computes (``chunk_factors``: each chunk's state
increment and decay from its own rows; ``state_pass``: the state entering
each chunk, elementwise; ``chunk_outputs``: each chunk's output against
it), held against the port's plain chunked form ``gla_chunked_ref``, the
reference's Pallas ``gla_chunked`` / ``gla_chunked_fused`` in interpret
mode and its sequential oracle ``ref.gla_ref``, on inputs made by numpy
from a seed: lengths 0, mid-chunk and full, S not a multiple of the chunk
and S < 8, dk 16 / 64 / 256 with dv 16 / 48 / 128 / 257, a nonzero
initial state, decays down to log_a = -20, NaN past each length.  With
``emulate=True`` the mirror rounds as the core's tensor-core products do
(each float32 operand in bf16 parts, ``PARTS``), and must still meet the
state tolerance at zamba2's Mamba2 head and round its outputs to bf16 as
the float32 plain version does almost everywhere.  The kernel itself runs
on the card (``tests/test_torch_gpu.py``).

Tolerances: 1e-4 abs / 1e-3 rel on outputs and state (TOL_STATE of
``chip_smoke.py``, as ``tests/test_torch_gla.py`` and the delta core's
mirror): the phases sum in another order than the chunked form.  Output
rows at or past a length are unspecified and not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gla import gla_chunked as jax_gla
from repro.kernels.gla import gla_chunked_fused as jax_gla_fused
from repro_torch.kernels import gla as tgla

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-3)
# bf16 outputs that round to another value than the float32 plain
# version's, at most (the card test holds the kernel to the same rate)
FLIP_GATE = 2e-4


def _inputs(seed, B, H, S, dk, dv, la_low=-2.0):
    """(q, k, v, log_a, s0) as numpy at the Mamba2 scale (k by dk^-0.5),
    decays from 0 down to ``la_low``, a nonzero initial state."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = (r.standard_normal((B, H, S, dk)) * dk ** -0.5).astype(np.float32)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    la = (la_low * r.uniform(0.0, 1.0, (B, H, S)) ** 3).astype(np.float32)
    s0 = (0.5 * r.standard_normal((B, H, dk, dv))).astype(np.float32)
    return q, k, v, la, s0


def _phases(args, lengths=None, emulate=False, dtype=torch.float32):
    q, k, v, la, s0 = (torch.from_numpy(x) for x in args)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    f = tgla.chunk_factors(q, k, v, la, lens, emulate=emulate)
    entering, st = tgla.state_pass(f, s0)
    return tgla.chunk_outputs(f, entering, emulate=emulate), st


def _plain(args, lengths=None):
    q, k, v, la, s0 = (torch.from_numpy(x) for x in args)
    if lengths is not None:
        la, k = tgla.mask_padded(torch.tensor(lengths, dtype=torch.int32),
                                 q.shape[2], la, k)
    return tgla.gla_chunked_ref(q, k, v, la, s0)


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
    (2, 2, 130, 16, 48, (130, 57)),    # a tail chunk, a length mid-chunk
    (2, 2, 200, 64, 16, (0, 65)),      # a length 0, one past a chunk
    (1, 3, 40, 16, 128, None),         # S < 64, unmasked
    (1, 2, 5, 16, 16, None),           # S < 8
    (2, 1, 70, 256, 257, (70, 33)),    # mLSTM's dk 256 and dv 257
    (3, 1, 63, 64, 128, (1, 63, 20)),  # the zamba2 head, S = 63
])
def test_phases_match_the_chunked_form(B, H, S, dk, dv, lengths):
    """chunk_factors + state_pass + chunk_outputs equal gla_chunked_ref on
    the masked rows, output and state."""
    args = _inputs(1, B, H, S, dk, dv)
    o, st = _phases(args, lengths)
    want_o, want_st = _plain(args, lengths)
    _close(o, st, want_o, want_st, _valid(S, lengths, B, H))


@pytest.mark.parametrize("S,lengths", [(130, None), (100, (100, 37)),
                                       (6, (6, 0)), (6, None)])
def test_phases_match_the_reference(S, lengths):
    """The same against the reference: its Pallas kernels in interpret
    mode (``gla_chunked_fused`` with lengths, ``gla_chunked`` without) and
    its sequential oracle ``gla_ref`` on the masked inputs."""
    B, H, dk, dv = 2, 2, 16, 24
    args = _inputs(2, B, H, S, dk, dv)
    o, st = _phases(args, lengths)
    q, k, v, la, s0 = (jnp.asarray(x) for x in args)
    if lengths is None:
        wants = [jax_gla(q, k, v, la, s0, chunk=64, interpret=True)]
        mk, mla = k, la
    else:
        lens = np.array(lengths, np.int32)
        wants = [jax_gla_fused(q, k, v, la, jnp.asarray(lens), s0, chunk=64,
                               interpret=True)]
        valid = np.arange(S)[None, :] < lens[:, None]
        mk = jnp.where(valid[:, None, :, None], k, 0.0)
        mla = jnp.where(valid[:, None], la, 0.0)
    wants.append(jref.gla_ref(q, mk, v, mla, s0))
    for want_o, want_st in wants:
        _close(o, st, want_o, want_st, _valid(S, lengths, B, H))
    if lengths is not None and 0 in lengths:
        b = lengths.index(0)
        np.testing.assert_array_equal(st[b].numpy(), args[4][b])


def test_phases_take_strong_decays():
    """log_a down to -20: exp underflows inside a chunk, every scale stays
    <= 1 and nothing overflows."""
    args = _inputs(3, 1, 2, 150, 64, 128, la_low=-20.0)
    o, st = _phases(args, (150,))
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    want_o, want_st = _plain(args, (150,))
    _close(o, st, want_o, want_st, _valid(150, (150,), 1, 2))


def test_rows_past_a_length_never_reach_the_state():
    """NaN in k, v and log_a at every row past a length changes no valid
    output and no state: the phases neutralize those rows by selection,
    never by multiplying them by zero."""
    B, H, S = 3, 2, 150
    lengths = (0, 37, 64)
    args = _inputs(4, B, H, S, 16, 48)
    poisoned = [x.copy() for x in args]
    dead = ~_valid(S, lengths, B, H)
    for x in (poisoned[1], poisoned[2]):
        x[dead] = np.nan
    poisoned[3][dead] = np.nan
    o, st = _phases(poisoned, lengths)
    want_o, want_st = _phases(args, lengths)
    assert torch.isfinite(st).all()
    _close(o, st, want_o, want_st, ~dead)
    np.testing.assert_array_equal(st[0].numpy(), args[4][0])


def test_split_products_meet_the_state_tolerance_at_zamba2_head():
    """The core's precision, emulated: zamba2's Mamba2 head (dk 64, dv 128)
    over 512 tokens, bf16 q, k, v, every float32 operand of a product in
    its bf16 parts, within TOL_STATE of the float32 chunked form on the
    same (bf16-rounded) inputs, state and outputs."""
    args = _inputs(6, 1, 2, 512, 64, 128)
    o, st = _phases(args, emulate=True, dtype=torch.bfloat16)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in args[:3])
    want_o, want_st = _plain((q, k, v) + tuple(args[3:]))
    _close(o, st, want_o, want_st, _valid(512, None, 1, 2))


@pytest.mark.parametrize("parts,within", [
    (None, True),                           # the kernel's
    ({"K": 3, "A": 2, "S": 3}, False),      # A in two parts
    ({"K": 2, "A": 2, "S": 2}, False),      # two everywhere
])
def test_split_products_round_like_float32(parts, within, monkeypatch,
                                           record_property):
    """The outputs the core rounds to bf16 agree with the float32 plain
    version's rounding almost everywhere: at zamba2's head (bf16 q, k, v,
    8 heads over 512 tokens, decays in multiples of 2^-10 so every
    cumulative sum is exact) the emulated split products give another bf16
    value in at most FLIP_GATE of the outputs (the rate is recorded as the
    test's ``flip_rate`` property).  A in two parts, or two parts
    everywhere, meet the state tolerance yet exceed it: a bf16 model's
    logits would move with them."""
    if parts is not None:
        monkeypatch.setattr(tgla, "PARTS", parts)
    q, k, v, la, s0 = _inputs(9, 1, 8, 512, 64, 128)
    la = (np.round(la * 1024) / 1024).astype(np.float32)
    args = (q, k, v, la, np.zeros_like(s0))
    o, _ = _phases(args, emulate=True, dtype=torch.bfloat16)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in (q, k, v))
    want, _ = _plain((q, k, v, la, np.zeros_like(s0)))
    flips = float((o.to(torch.bfloat16) != want.to(torch.bfloat16))
                  .float().mean())
    record_property("flip_rate", flips)
    assert (flips <= FLIP_GATE) == within, flips
