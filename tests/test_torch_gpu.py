"""Hand-written Hopper kernels of the port against their plain PyTorch
versions, on the card.

Marked ``gpu``: every test asks for the ``cuda`` fixture, which skips when
no CUDA device is present (decided inside the fixture, so every worker
collects the same tests).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (abs, rel): float32 inputs 2e-5, 2e-5 (the plain and kernel
sums run in other orders); bfloat16 outputs 2e-3, 2e-2 (a bf16 ulp is 2^-8
of the value, and the outputs of unit inputs are as small as ~0.02); the
delta rule and gated linear attention 1e-4, 1e-3 (as
``tests/test_kernels_delta.py``) for their float32 state at either input
dtype and their float32 output; quantize byte-identical; the gradients of
the differentiable ops through their kernel forward 1e-5, 1e-5 against
autograd through the plain version (the backward recomputes the same
plain version, so only the card's summation order can differ).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)
from repro_torch.kernels.delta import (PARTS, delta_chunked,
                                       delta_chunked_fused, delta_chunked_ref,
                                       kernel_parts, mask_padded)
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels import gla as kgla
from repro_torch.kernels.gla import (gla_chunked, gla_chunked_fused,
                                     gla_chunked_ref)
from repro_torch.kernels.paged_decode_attn import (
    paged_decode_attention, paged_decode_attention_ref)
from repro_torch.kernels.paged_prefill_attn import (
    paged_prefill_attention, paged_prefill_attention_ref)
from repro_torch.kernels import quantize as kq
from repro_torch.kernels.quantize import quantize_int8_fused, quantize_int8_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-3, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dk,Dv,q_offset,window", [
    (1, 2, 2, 128, 128, 32, 16, 0, 0),
    (2, 4, 2, 100, 100, 48, 32, 0, 0),
    (1, 4, 1, 64, 192, 32, 32, 128, 0),
    (2, 2, 2, 200, 200, 64, 64, 0, 48),
    (1, 4, 4, 77, 300, 192, 128, 223, 0),
    (1, 32, 32, 300, 300, 64, 64, 0, 0),      # zamba2's shared MHA block
    (1, 32, 32, 128, 384, 64, 64, 256, 0),    # its chunk after 256 tokens
    (1, 64, 64, 2048, 2048, 192, 128, 0, 0),  # the full MLA prefill
    (1, 4, 2, 2047, 2047, 192, 128, 0, 0),    # Sq not a multiple of 128
    (1, 4, 2, 300, 337, 128, 128, 37, 0),     # first tile across the diagonal
    (2, 4, 2, 300, 300, 192, 128, 0, 48),     # window 48, the Dk 192 instance
    (1, 4, 4, 260, 260, 128, 128, 0, 48),     # window 48, the Dk 128 instance
    (1, 4, 2, 300, 300, 80, 80, 0, 0),        # Dk, Dv 80: TMA zero-pads
    (2, 2, 1, 150, 170, 48, 48, 20, 0),       # Dk, Dv 48
    (1, 40, 8, 300, 300, 128, 128, 0, 0),     # llama4's GQA, G 5
    (1, 48, 8, 300, 300, 128, 128, 0, 200),   # mixtral's SWA, G 6
    (1, 8, 8, 300, 300, 96, 96, 0, 0),        # phi-3's MHA, head dim 96
])
def test_flash_matches_plain(cuda, dtype, B, Hq, Hkv, Sq, Sk, Dk, Dv,
                             q_offset, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(g, (B, Hq, Sq, Dk), dtype, cuda)
    k = _randn(g, (B, Hkv, Sk, Dk), dtype, cuda)
    v = _randn(g, (B, Hkv, Sk, Dv), dtype, cuda)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,Hq,Hkv", [
    (500, 3000, 16, 16),                      # seamless's cross-attention
    (600, 600, 16, 16),                       # its bidirectional encoder
    (130, 77, 4, 1),                          # more queries than keys
])
def test_flash_noncausal_matches_plain(cuda, dtype, Sq, Sk, Hq, Hkv):
    """The flash kernel at ``causal=False`` with Sq != Sk, head dim 64: an
    encoder's self-attention and a cross block over the encoder's keys."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(g, (2, Hq, Sq, 64), dtype, cuda)
    k = _randn(g, (2, Hkv, Sk, 64), dtype, cuda)
    v = _randn(g, (2, Hkv, Sk, 64), dtype, cuda)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=False)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,Dk,Dv,window", [
    (3, 4, 1, 100, 48, 32, 0),
    (2, 64, 1, 1000, 536, 472, 0),
    (2, 8, 2, 300, 64, 64, 50),
    (3, 32, 32, 300, 64, 64, 0),              # zamba2: one head per group
    (3, 32, 32, 300, 96, 96, 0),              # phi-3: head dim 96
    (3, 40, 8, 700, 128, 128, 0),             # llama4: G 5
    (3, 48, 8, 700, 128, 128, 0),             # mixtral: G 6
])
def test_decode_matches_plain(cuda, dtype, B, Hq, Hkv, S, Dk, Dv, window):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(g, (B, Hq, Dk), dtype, cuda)
    k = _randn(g, (B, Hkv, S, Dk), dtype, cuda)
    v = _randn(g, (B, Hkv, S, Dv), dtype, cuda)
    lengths = torch.tensor(np.linspace(1, S, B).astype(np.int32), device=cuda)
    got = decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, lengths, window=window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _delta_inputs(g, B, H, S, dk, dv, dtype, dev):
    q = torch.nn.functional.normalize(_randn(g, (B, H, S, dk), torch.float32, dev), dim=-1)
    k = torch.nn.functional.normalize(_randn(g, (B, H, S, dk), torch.float32, dev), dim=-1)
    v = _randn(g, (B, H, S, dv), torch.float32, dev)
    la = -0.1 * _randn(g, (B, H, S), torch.float32, dev).abs()
    beta = torch.rand((B, H, S), generator=g, device=dev) * 0.9 + 0.1
    s0 = _randn(g, (B, H, dk, dv), torch.float32, dev, 0.1)
    return q.to(dtype), k.to(dtype), v.to(dtype), la, beta, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,dk,dv,lens", [
    (2, 2, 130, 32, 48, (130, 57)),
    (1, 3, 64, 16, 16, (40,)),
    (2, 4, 300, 128, 128, (300, 129)),
])
def test_delta_matches_plain(cuda, dtype, B, H, S, dk, dv, lens):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, la, beta, s0 = _delta_inputs(g, B, H, S, dk, dv, dtype, cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    o, st = delta_chunked_fused(q, k, v, la, beta, lengths, s0)
    torch.cuda.synchronize()
    la_m, k_m, beta_m = mask_padded(lengths, S, la, k, beta)
    o2, st2 = delta_chunked_ref(q, k_m, v, la_m, beta_m, s0)
    valid = torch.arange(S, device=cuda)[None, :] < lengths[:, None]
    otol = (1e-4, 1e-3) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(o.float()[valid[:, None].expand(-1, H, -1)],
                               o2.float()[valid[:, None].expand(-1, H, -1)],
                               atol=otol[0], rtol=otol[1])
    torch.testing.assert_close(st, st2, atol=1e-4, rtol=1e-3)


def _delta_case(dtype, case, dev):
    """Inputs and lengths (None: the unmasked instance) of an edge case of
    the two-phase delta core."""
    g = torch.Generator(device=dev).manual_seed(21)
    shapes = {"S_1": (2, 2, 1, 64, 64), "S_63": (2, 2, 63, 64, 64),
              "lengths_0_1_65": (3, 2, 130, 32, 48),
              "length_mid_chunk": (2, 2, 300, 128, 128),
              "log_a_-20": (2, 2, 200, 64, 64),
              "beta_1": (2, 2, 200, 128, 128),
              "dk_256_dv_48": (2, 2, 150, 256, 48)}
    B, H, S, dk, dv = shapes[case]
    q, k, v, la, beta, s0 = _delta_inputs(g, B, H, S, dk, dv, dtype, dev)
    lens = {"lengths_0_1_65": (0, 1, 65), "length_mid_chunk": (300, 100),
            "dk_256_dv_48": (150, 77)}.get(case)
    if case == "log_a_-20":
        la = -20.0 + 0.5 * torch.rand(la.shape, generator=g, device=dev)
    if case == "beta_1":
        beta = torch.ones_like(beta)
    lengths = (None if lens is None
               else torch.tensor(lens, dtype=torch.int32, device=dev))
    return (q, k, v, la, beta, s0), lengths


def _delta_check(args, lengths, o, st, dtype, dev):
    """o (rows below the lengths) and state against the plain version."""
    q, k, v, la, beta, s0 = args
    S = q.shape[2]
    if lengths is None:
        o2, st2 = delta_chunked_ref(*args)
        valid = torch.ones((q.shape[0], S), dtype=torch.bool, device=dev)
    else:
        la_m, k_m, beta_m = mask_padded(lengths, S, la, k, beta)
        o2, st2 = delta_chunked_ref(q, k_m, v, la_m, beta_m, s0)
        valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    valid = valid[:, None].expand(-1, q.shape[1], -1)
    otol = (1e-4, 1e-3) if dtype == torch.float32 else TOL[dtype]
    assert torch.isfinite(st).all()
    torch.testing.assert_close(o.float()[valid], o2.float()[valid],
                               atol=otol[0], rtol=otol[1])
    torch.testing.assert_close(st, st2, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["S_1", "S_63", "lengths_0_1_65",
                                  "length_mid_chunk", "log_a_-20", "beta_1",
                                  "dk_256_dv_48"])
def test_delta_core_edge_cases_match_plain(cuda, dtype, case):
    """The two-phase core (rows 3 and 5) at the shapes and values its
    rules must take: S of 1 and 63, lengths 0, 1 and 65 and one ending
    mid-chunk, decays of -20 (exp underflows), beta = 1, dk 256 with dv 48
    (a partial column slice, phase 2 reading its record from global
    memory); masked where the case has lengths, unmasked otherwise."""
    args, lengths = _delta_case(dtype, case, cuda)
    if lengths is None:
        o, st = delta_chunked(*args)
    else:
        o, st = delta_chunked_fused(*args[:5], lengths, args[5])
    torch.cuda.synchronize()
    _delta_check(args, lengths, o, st, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_nan_past_lengths_never_reaches_the_state(cuda, dtype):
    """NaN in every row past a length (q, k, v, log_a, beta): the valid
    outputs and the state equal the plain version's on the clean inputs."""
    g = torch.Generator(device=cuda).manual_seed(22)
    B, H, S = 3, 2, 200
    args = _delta_inputs(g, B, H, S, 64, 64, dtype, cuda)
    lengths = torch.tensor((0, 70, 200), dtype=torch.int32, device=cuda)
    dead = torch.arange(S, device=cuda)[None, :] >= lengths[:, None]
    dead = dead[:, None].expand(B, H, S)
    poisoned = [x.clone() for x in args]
    for x in poisoned[:5]:
        x[dead] = float("nan")
    o, st = delta_chunked_fused(*poisoned[:5], lengths, poisoned[5])
    torch.cuda.synchronize()
    _delta_check(args, lengths, o, st, dtype, cuda)


@pytest.mark.parametrize("op", ["delta_chunked", "delta_chunked_fused"])
def test_delta_core_refuses_what_it_cannot_take(cuda, op):
    """A key dim past 256 (the core pads dk to 64, 128, 192 or 256) is
    refused before any launch."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, la, beta, s0 = _delta_inputs(g, 1, 2, 64, 264, 32,
                                          torch.bfloat16, cuda)
    build.reset_launches()
    with pytest.raises(ValueError):
        if op == "delta_chunked":
            delta_chunked(q, k, v, la, beta, s0)
        else:
            delta_chunked_fused(q, k, v, la, beta, torch.full(
                (1,), 64, dtype=torch.int32, device=cuda), s0)
    assert not build.LAUNCHES


@pytest.mark.parametrize("op", ["delta_chunked", "delta_chunked_fused"])
def test_delta_core_rounds_like_float32(cuda, op):
    """The core's own bf16 outputs against the float32 plain version's
    rounding, at the kimi-like inputs of
    ``tests/test_torch_delta_plan.py::test_split_products_round_like_float32``
    (bf16 q, k, v at kimi-linear's head over 512 tokens; values up to ~10;
    decays down to -4) with the decays rounded to multiples of 2^-10:
    another bf16 value in at most 2e-4 of the outputs.  The rounding makes
    every cumulative log decay exact in float32, so the kernel and the
    plain version share their decays; unrounded, a chunk's sums reach ~-90
    and the plain version on the card already differs from itself on the
    CPU in 5e-4 of the outputs through the order of the cumulative sum.
    Two bf16 parts everywhere met every float32 tolerance, yet moved
    kimi-linear's bf16 prefill logits by 15 % through its expert routing
    (2e-3 of the outputs here on the H100); this holds the part counts
    compiled into ``csrc/delta_hopper.cuh``, where the CPU test holds only
    their mirror."""
    B, H, S, d = 1, 8, 512, 128
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((B, H, S, d)).astype(np.float32)
               for _ in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    r = np.random.default_rng(9)
    la = (-r.uniform(0.1, 2.0, (B, H, S)) ** 2).astype(np.float32)
    la = np.round(la * 1024) / 1024
    beta = r.uniform(0.01, 1.0, (B, H, S)).astype(np.float32)
    q, k, v = (torch.from_numpy(x).to(cuda).to(torch.bfloat16)
               for x in (q, k, 3.0 * v))
    la = torch.from_numpy(la.astype(np.float32)).to(cuda)
    beta = torch.from_numpy(beta).to(cuda)
    s0 = torch.zeros((B, H, d, d), device=cuda)
    if op == "delta_chunked":
        o, _ = delta_chunked(q, k, v, la, beta, s0)
    else:
        o, _ = delta_chunked_fused(q, k, v, la, beta, torch.full(
            (B,), S, dtype=torch.int32, device=cuda), s0)
    torch.cuda.synchronize()
    want, _ = delta_chunked_ref(q.float(), k.float(), v.float(), la, beta, s0)
    flips = float((o != want.to(torch.bfloat16)).float().mean())
    assert flips <= 2e-4, flips


def test_delta_core_parts_are_the_mirrors(cuda):
    """The bf16 part counts compiled into ``csrc/delta_hopper.cuh`` are the
    ``PARTS`` that the CPU mirror in ``kernels/delta.py`` emulates."""
    assert kernel_parts() == PARTS


def _gla_inputs(g, B, H, S, dk, dv, lengths, dtype, dev):
    """Mamba2-scaled q, k (k by dk^-0.5), decays from mild to strong, a
    nonzero initial state, and NaN in k and log_a at every row past each
    length (the kernel must select them away)."""
    q = _randn(g, (B, H, S, dk), torch.float32, dev)
    k = _randn(g, (B, H, S, dk), torch.float32, dev, dk ** -0.5)
    v = _randn(g, (B, H, S, dv), torch.float32, dev)
    u = torch.rand((B, H, S), generator=g, device=dev)
    la = -2.0 * u ** 3
    s0 = _randn(g, (B, H, dk, dv), torch.float32, dev, 0.5)
    past = torch.arange(S, device=dev)[None, :] >= lengths[:, None]
    k[past[:, None].expand(-1, H, -1)] = float("nan")
    la[past[:, None].expand(-1, H, -1)] = float("nan")
    return q.to(dtype), k.to(dtype), v.to(dtype), la, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,dk,dv,lens", [
    (2, 4, 100, 64, 128, (100, 37)),       # S not a multiple of 64
    (2, 3, 100, 64, 48, (61, 100)),        # dv 48: a partial column slice
    (2, 2, 4096, 64, 128, (4096, 2500)),   # the zamba2 head at length
    (1, 2, 70, 16, 16, (0,)),              # no valid row: s0 passes through
])
def test_gla_matches_plain(cuda, dtype, B, H, S, dk, dv, lens):
    g = torch.Generator(device=cuda).manual_seed(8)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q, k, v, la, s0 = _gla_inputs(g, B, H, S, dk, dv, lengths, dtype, cuda)
    o, st = gla_chunked_fused(q, k, v, la, lengths, s0)
    torch.cuda.synchronize()
    la_m, k_m = mask_padded(lengths, S, la, k)
    o2, st2 = gla_chunked_ref(q, k_m, v, la_m, s0)
    valid = (torch.arange(S, device=cuda)[None, :] < lengths[:, None])
    valid = valid[:, None].expand(-1, H, -1)
    otol = (1e-4, 1e-3) if dtype == torch.float32 else TOL[dtype]
    assert torch.isfinite(st).all()
    torch.testing.assert_close(o.float()[valid], o2.float()[valid],
                               atol=otol[0], rtol=otol[1])
    torch.testing.assert_close(st, st2, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,lens", [(1, 4096, (4096,)),
                                      (2, 3000, (3000, 1777))])
def test_gla_at_xlstm_shapes_matches_plain(cuda, dtype, B, S, lens):
    """Row 7 at xlstm-350m's mLSTM shape: 4 heads, dk 256, dv 257 (the
    values and the normaliser's ones column, one contiguous tensor, rows of
    514 bytes in bf16), with lengths and a nonzero initial state."""
    g = torch.Generator(device=cuda).manual_seed(27)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q, k, v, la, s0 = _gla_inputs(g, B, 4, S, 256, 256, lengths, dtype,
                                  cuda)
    v = torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)
    assert v.is_contiguous() and v.shape[-1] == 257
    s0 = torch.cat([s0, s0[..., :1]], dim=-1)
    o, st = gla_chunked_fused(q, k, v, la, lengths, s0)
    torch.cuda.synchronize()
    _gla_check((q, k, v, la, s0), lengths, o, st, dtype, cuda)


def _lightning_inputs(g, B, H, S, dk, dv, dev):
    """ring-2.5-1t's Lightning mixer's inputs at its init: q, k, v the SiLU
    of unit normals (keys unscaled: q . k ~11x the Mamba2 scale's), decays
    logsigmoid(z + 4) of a unit normal z (~-0.018 a token, near 1 across
    a 64-row chunk; multiples of 2^-14, so their cumulative sums are
    exact) and the state such a history leaves (~2.3 plus noise)."""
    q, k, v = (torch.nn.functional.silu(_randn(g, (B, H, S, d),
                                               torch.float32, dev))
               .to(torch.bfloat16) for d in (dk, dk, dv))
    z = _randn(g, (B, H, S), torch.float32, dev)
    la = torch.round(torch.nn.functional.logsigmoid(z + 4.0)
                     * 2.0 ** 14) / 2.0 ** 14
    return q, k, v, la, 2.3 + _randn(g, (B, H, dk, dv), torch.float32, dev)


@pytest.mark.parametrize("B,S,lens", [(1, 4096, (4096,)),
                                      (2, 3000, (3000, 1777)),
                                      (1, 2048, None)])
def test_gla_at_ring_shapes_matches_plain(cuda, B, S, lens):
    """Rows 7 (with lengths) and 6 (without) at ring-2.5-1t's Lightning
    heads, 48 of dk 128 / dv 128 (the core's dk-128 instance), bf16, at
    Lightning's scale; with lengths, each row's state also equals the
    unmasked kernel's over that row's prompt alone (padding leaves the
    state: decay 1, key 0)."""
    g = torch.Generator(device=cuda).manual_seed(33)
    q, k, v, la, s0 = _lightning_inputs(g, B, 48, S, 128, 128, cuda)
    if lens is None:
        o, st = gla_chunked(q, k, v, la, s0)
        torch.cuda.synchronize()
        _gla_check((q, k, v, la, s0), None, o, st, torch.bfloat16, cuda)
        return
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    o, st = gla_chunked_fused(q, k, v, la, lengths, s0)
    torch.cuda.synchronize()
    _gla_check((q, k, v, la, s0), lengths, o, st, torch.bfloat16, cuda)
    for b, L in enumerate(lens):
        _, alone = gla_chunked(*(t[b:b + 1, :, :L].contiguous()
                                 for t in (q, k, v, la)), s0[b:b + 1])
        torch.testing.assert_close(st[b:b + 1], alone, atol=1e-4, rtol=1e-3)


def test_gla_op_routes_cuda_tensors_to_the_kernel(cuda):
    build.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(g, (1, 2, 16, 16), torch.float32, cuda)
    ops.gla(q, q, q, torch.zeros((1, 2, 16), device=cuda))
    ops.gla(q, q, q, torch.zeros((1, 2, 16), device=cuda),
            lengths=torch.tensor([9], device=cuda))
    assert dict(build.LAUNCHES) == {"gla_chunked": 1, "gla_chunked_fused": 1}


def _gla_check(args, lengths, o, st, dtype, dev):
    """o (rows below the lengths) and state against the plain version."""
    q, k, v, la, s0 = args
    S = q.shape[2]
    if lengths is None:
        o2, st2 = gla_chunked_ref(*args)
        valid = torch.ones((q.shape[0], S), dtype=torch.bool, device=dev)
    else:
        la_m, k_m = mask_padded(lengths, S, la, k)
        o2, st2 = gla_chunked_ref(q, k_m, v, la_m, s0)
        valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    valid = valid[:, None].expand(-1, q.shape[1], -1)
    otol = (1e-4, 1e-3) if dtype == torch.float32 else TOL[dtype]
    assert torch.isfinite(st).all()
    torch.testing.assert_close(o.float()[valid], o2.float()[valid],
                               atol=otol[0], rtol=otol[1])
    torch.testing.assert_close(st, st2, atol=1e-4, rtol=1e-3)


_GLA_CASES = {  # (B, H, S, dk, dv), lengths (None: the unmasked instance)
    "dk_256_dv_257": ((2, 2, 150, 256, 257), (150, 77)),
    "lengths_0_1_65": ((3, 2, 130, 64, 128), (0, 1, 65)),
    "length_mid_chunk": ((2, 4, 300, 64, 128), (300, 100)),
    "S_40": ((2, 2, 40, 64, 128), (40, 17)),
    "S_1": ((2, 2, 1, 64, 128), None),
    "S_63_unmasked": ((2, 2, 63, 32, 48), None),
    "B_5": ((5, 3, 200, 64, 128), (200, 1, 64, 129, 150)),
    "B_5_unmasked": ((5, 3, 200, 64, 128), None),
}


@pytest.mark.parametrize("case", list(_GLA_CASES))
def test_gla_core_edge_cases_match_plain(cuda, case):
    """The three-phase bf16 core (rows 6 and 7) at the shapes its rules
    must take: mLSTM's dk 256 with dv 257 (element loads, a partial
    column tile), lengths 0, 1 and 65 and one ending mid-chunk, S of 40
    and 1 and 63 (a single partial chunk), more than two batch rows;
    masked where the case has lengths, unmasked otherwise."""
    (B, H, S, dk, dv), lens = _GLA_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(24)
    lengths = torch.tensor(lens or (S,) * B, dtype=torch.int32, device=cuda)
    args = _gla_inputs(g, B, H, S, dk, dv, lengths, torch.bfloat16, cuda)
    if lens is None:
        o, st = gla_chunked(*args)
        lengths = None
    else:
        o, st = gla_chunked_fused(*args[:4], lengths, args[4])
    torch.cuda.synchronize()
    _gla_check(args, lengths, o, st, torch.bfloat16, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_nan_past_lengths_never_reaches_the_state(cuda, dtype):
    """NaN in every row past a length (q, k, v, log_a): the valid outputs
    and the state equal the plain version's on the clean inputs, and a
    row of length 0 returns its initial state."""
    g = torch.Generator(device=cuda).manual_seed(25)
    B, H, S = 3, 2, 200
    lengths = torch.tensor((0, 70, 200), dtype=torch.int32, device=cuda)
    args = _gla_inputs(g, B, H, S, 64, 128, torch.full(
        (B,), S, dtype=torch.int32, device=cuda), dtype, cuda)
    dead = torch.arange(S, device=cuda)[None, :] >= lengths[:, None]
    dead = dead[:, None].expand(B, H, S)
    poisoned = [x.clone() for x in args]
    for x in poisoned[:4]:
        x[dead] = float("nan")
    o, st = gla_chunked_fused(*poisoned[:4], lengths, poisoned[4])
    torch.cuda.synchronize()
    _gla_check(args, lengths, o, st, dtype, cuda)
    assert torch.equal(st[0], args[4][0])


@pytest.mark.parametrize("op,fault", [
    (op, fault) for op in ("gla_chunked", "gla_chunked_fused")
    for fault in ("dk_264", "non_contiguous", "log_a_bf16", "state_bf16")
] + [("gla_chunked_fused", "lengths_int64")])
def test_gla_core_refuses_what_it_cannot_take(cuda, op, fault):
    """A key dim past 256 (the core pads dk to 64, 128, 192 or 256), a
    non-contiguous tensor, or lengths, decays or state of another type
    are refused before any launch."""
    g = torch.Generator(device=cuda).manual_seed(26)
    B, H, S, dv = 1, 2, 64, 32
    dk = 264 if fault == "dk_264" else 64
    full = torch.full((B,), S, dtype=torch.int32, device=cuda)
    q, k, v, la, s0 = _gla_inputs(g, B, H, S, dk, dv, full, torch.bfloat16,
                                  cuda)
    lengths = full.long() if fault == "lengths_int64" else full
    if fault == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    if fault == "log_a_bf16":
        la = la.to(torch.bfloat16)
    if fault == "state_bf16":
        s0 = s0.to(torch.bfloat16)
    build.reset_launches()
    with pytest.raises((ValueError, TypeError)):
        if op == "gla_chunked":
            gla_chunked(q, k, v, la, s0)
        else:
            gla_chunked_fused(q, k, v, la, lengths, s0)
    assert not build.LAUNCHES


@pytest.mark.parametrize("op", ["gla_chunked", "gla_chunked_fused"])
def test_gla_core_rounds_like_float32(cuda, op, record_property):
    """The core's own bf16 outputs against the float32 plain version's
    rounding, at the inputs of
    ``tests/test_torch_gla_plan.py::test_split_products_round_like_float32``
    (zamba2's head, bf16 q, k, v, 8 heads over 512 tokens, decays in
    multiples of 2^-10 so that every cumulative log decay is exact in
    float32 and the kernel and the plain version share them): another bf16
    value in at most the mirror's gate, 2e-4, of the outputs (recorded as
    the test's ``flip_rate`` property).  This holds the part counts
    compiled into ``csrc/gla_hopper.cuh``, where the CPU test holds only
    their mirror."""
    B, H, S, dk, dv = 1, 8, 512, 64, 128
    r = np.random.default_rng(9)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = (r.standard_normal((B, H, S, dk)) * dk ** -0.5).astype(np.float32)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    la = (-2.0 * r.uniform(0.0, 1.0, (B, H, S)) ** 3).astype(np.float32)
    la = np.round(la * 1024) / 1024
    q, k, v = (torch.from_numpy(x).to(cuda).to(torch.bfloat16)
               for x in (q, k, v))
    la = torch.from_numpy(la.astype(np.float32)).to(cuda)
    s0 = torch.zeros((B, H, dk, dv), device=cuda)
    if op == "gla_chunked":
        o, _ = gla_chunked(q, k, v, la, s0)
    else:
        o, _ = gla_chunked_fused(q, k, v, la, torch.full(
            (B,), S, dtype=torch.int32, device=cuda), s0)
    torch.cuda.synchronize()
    want, _ = gla_chunked_ref(q.float(), k.float(), v.float(), la, s0)
    flips = float((o != want.to(torch.bfloat16)).float().mean())
    record_property("flip_rate", flips)
    assert flips <= 2e-4, flips


def test_gla_core_parts_are_the_mirrors(cuda):
    """The bf16 part counts compiled into ``csrc/gla_hopper.cuh`` are the
    ``PARTS`` that the CPU mirror in ``kernels/gla.py`` emulates."""
    assert kgla.kernel_parts() == kgla.PARTS


def _unmasked_inputs(op, g, B, H, S, dk, dv, dtype, dev):
    """Inputs of the unmasked scans (no NaN: every row is valid)."""
    if op == "delta":
        return _delta_inputs(g, B, H, S, dk, dv, dtype, dev)
    return _gla_inputs(g, B, H, S, dk, dv, torch.full(
        (B,), S, dtype=torch.int32, device=dev), dtype, dev)


_UNMASKED = {"delta": (delta_chunked, delta_chunked_ref),
             "gla": (gla_chunked, gla_chunked_ref)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op,B,H,S,dk,dv", [
    ("gla", 2, 4, 100, 64, 128),           # S not a multiple of 64
    ("gla", 2, 3, 100, 64, 48),            # dv 48: a partial column slice
    ("gla", 1, 2, 4096, 64, 128),          # the zamba2 head
    ("delta", 2, 4, 100, 64, 64),          # the KDA:MLA recipe's head
    ("delta", 2, 3, 100, 32, 48),          # a partial column slice
    ("delta", 1, 2, 4096, 128, 128),       # the kimi-linear head
])
def test_unmasked_scans_match_plain(cuda, dtype, op, B, H, S, dk, dv):
    """Rows 5 and 6: the unmasked kernels against their plain versions,
    nonzero initial state; output and state at the delta/gla tolerances."""
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _unmasked_inputs(op, g, B, H, S, dk, dv, dtype, cuda)
    kernel, plain = _UNMASKED[op]
    o, st = kernel(*args)
    torch.cuda.synchronize()
    o2, st2 = plain(*args)
    otol = (1e-4, 1e-3) if dtype == torch.float32 else TOL[dtype]
    assert torch.isfinite(o.float()).all() and torch.isfinite(st).all()
    torch.testing.assert_close(o.float(), o2.float(), atol=otol[0],
                               rtol=otol[1])
    torch.testing.assert_close(st, st2, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("op", ["delta", "gla"])
def test_unmasked_equals_masked_at_full_lengths(cuda, op):
    """The two instances of one template agree bit for bit when every row
    is valid."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, H, S = 2, 3, 300
    args = _unmasked_inputs(op, g, B, H, S, 64, 128, torch.bfloat16, cuda)
    full = torch.full((B,), S, dtype=torch.int32, device=cuda)
    o, st = _UNMASKED[op][0](*args)
    if op == "delta":
        o2, st2 = delta_chunked_fused(*args[:5], full, args[5])
    else:
        o2, st2 = gla_chunked_fused(*args[:4], full, args[4])
    assert torch.equal(o, o2) and torch.equal(st, st2)


@pytest.mark.parametrize("op,lens", [("attention", None), ("gla", None),
                                     ("gla", (300, 129)), ("delta", None),
                                     ("delta", (300, 129))])
def test_kernel_forward_grads_equal_plain_autograd(cuda, op, lens):
    """Each differentiable op on CUDA (kernel forward, plain recompute in
    the backward) gives the gradients of autograd through its plain
    version, for every input, in float32."""
    g = torch.Generator(device=cuda).manual_seed(13)
    B, H, S, dk, dv = 2, 4, 300, 64, 128
    if op == "attention":
        args = (_randn(g, (B, 8, S, 96), torch.float32, cuda),
                _randn(g, (B, 4, S, 96), torch.float32, cuda),
                _randn(g, (B, 4, S, 64), torch.float32, cuda))
    else:
        args = _unmasked_inputs(op, g, B, H, S, dk, dv, torch.float32, cuda)
    kw = {} if lens is None else {"lengths": torch.tensor(
        lens, dtype=torch.int32, device=cuda)}
    ups = None

    def grads(use_kernel):
        nonlocal ups
        xs = [a.detach().clone().requires_grad_() for a in args]
        out = getattr(ops, op)(*xs, use_kernel=use_kernel, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        if ups is None:
            ups = [_randn(g, o.shape, torch.float32, cuda) for o in outs]
        return torch.autograd.grad(outs, xs, ups)

    build.reset_launches()
    got = grads(True)
    assert sum(build.LAUNCHES.values()) == 1
    want = grads(False)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(7,), (4096, 472), (1, 1, 1000, 64),
                                   (3, 333, 17)])
def test_quantize_byte_identical(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(g, shape, torch.float32, cuda, 3.0)
    q, s = quantize_int8_fused(x)
    torch.cuda.synchronize()
    q2, s2 = quantize_int8_ref(x)
    assert torch.equal(q, q2)
    assert s.view(torch.int32).item() == s2.view(torch.int32).item()


def _same_bytes(a, b):
    """Equal shapes, dtypes and bytes (a NaN equals the same NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _wire_leaves(g, dev, dtype, case):
    """The leaves of one request as the serving paths read them in place
    from their bucket-padded caches (widths at full size, depth and
    bucket cut)."""
    if case == "mistral":              # 40 layers of GQA k / v, 8 x 128
        xs = [_randn(g, (40, 2, 512, 8, 128), dtype, dev, 3.0)
              for _ in range(2)]
        return [kq.request_leaf(x, 1, 301) for x in xs]
    if case == "kimi":                 # MLA ckv / kpe, two requests each
        ckv = _randn(g, (1, 2, 4096, 472), dtype, dev, 3.0)
        kpe = _randn(g, (1, 2, 4096, 64), dtype, dev, 3.0)
        return [kq.request_leaf(ckv, 1, 4096), kq.request_leaf(kpe, 1, 4096),
                kq.request_leaf(ckv, 0, 2500), kq.request_leaf(kpe, 0, 2500)]
    # zamba2: the shared block's k / v, six invocations each
    xs = [_randn(g, (6, 2, 1024, 32, 64), dtype, dev, 3.0) for _ in range(2)]
    return [kq.request_leaf(x, 0, 700) for x in xs]


def _check_wire(leaves):
    build.reset_launches()
    got = kq.quantize_int8_wire(leaves)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"quantize_int8_fused": 1}
    want = kq.quantize_int8_wire_ref(leaves)
    for (q, s, sd), (q2, s2, sd2) in zip(got, want):
        assert _same_bytes(q, q2)
        assert _same_bytes(s, s2) and _same_bytes(sd, sd2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mistral", "kimi", "zamba2"])
def test_wire_encode_in_place_byte_identical(cuda, case, dtype):
    """A request's leaves read in place from the padded cache, all in one
    launch pair: codes and both scales byte-identical to the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    _check_wire(_wire_leaves(g, cuda, dtype, case))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_encode_odd_sizes_and_zero_leaf(cuda, dtype):
    """Whole leaves of 7 and (3, 333, 17) elements, an all-zero leaf
    (scale 1e-30 / 127), rows of width 257 and 80 from a view that starts
    off the 16-byte grid, in one launch pair."""
    g = torch.Generator(device=cuda).manual_seed(6)
    base = _randn(g, (3 * 2 * 50 * 257 + 3,), dtype, cuda, 3.0)
    odd = base[3:].view(3, 2, 50, 257)
    assert odd.data_ptr() % 16 != 0
    h80 = _randn(g, (2, 3, 40, 2, 40), dtype, cuda, 3.0)
    leaves = [kq.whole_leaf(_randn(g, (7,), dtype, cuda, 3.0)),
              kq.whole_leaf(_randn(g, (3, 333, 17), dtype, cuda, 3.0)),
              kq.whole_leaf(torch.zeros((5, 64), dtype=dtype, device=cuda)),
              kq.request_leaf(odd, 1, 37), kq.request_leaf(odd, 0, 50),
              kq.request_leaf(h80, 2, 13)]
    _check_wire(leaves)
    (q, s, _), = kq.quantize_int8_wire([leaves[2]])
    assert not q.any() and float(s) == pytest.approx(1e-30 / 127)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_quantize_scale_keeps_nan_and_inf(cuda, bad, dtype):
    """A leaf holding one NaN or one inf: the scale (float32, and in the
    leaf's dtype) has the plain version's bytes, as ``torch.max`` and the
    reference's ``jnp.max`` propagate the value; the codes agree wherever
    x / scale is finite."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(g, (4096, 472), dtype, cuda, 3.0)
    x[1234, 77] = bad
    q, s = quantize_int8_fused(x)
    torch.cuda.synchronize()
    q2, s2 = quantize_int8_ref(x.float())
    assert _same_bytes(s, s2)
    finite = torch.isfinite(x.float() / s2)
    assert torch.equal(q[finite], q2[finite])
    (_, _, sd), = kq.quantize_int8_wire([kq.whole_leaf(x)])
    assert _same_bytes(sd, s2.to(dtype))


def test_wire_encode_refuses_other_dtypes(cuda):
    x = torch.zeros((4, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        kq.quantize_int8_wire([kq.whole_leaf(x)])


@pytest.mark.parametrize("arch", ["kimi-linear-1t", "zamba2-1.2b"])
def test_request_encode_on_cuda_equals_cpu(cuda, arch):
    """``encode_request_for_wire`` of a smoke prefill cache on the card (one
    launch pair) equals the same cache's encode on the CPU (the plain
    version through a trim), byte for byte."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.kvcache import encode_request_for_wire
    from repro_torch.models.tree import tree_leaves
    from repro_torch.params import init_params
    from repro_torch.serving.engine import PrefillEngine

    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 40))
    _, caches, _ = PrefillEngine(Model(cfg), params, min_bucket=32).prefill(
        toks.astype(np.int32), np.array([40, 23, 1], np.int32))
    cpu = [t.cpu() for t in tree_leaves(caches)]
    it = iter(cpu)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return next(it)

    caches_cpu = rebuild(caches)
    for idx, length in ((0, 40), (1, 23), (2, 1)):
        build.reset_launches()
        wire, nbytes, raw = encode_request_for_wire(caches, idx, length)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"quantize_int8_fused": 1}
        want, wbytes, wraw = encode_request_for_wire(caches_cpu, idx, length)
        assert (nbytes, raw) == (wbytes, wraw)
        for a, b in zip(tree_leaves(wire), tree_leaves(want)):
            assert _same_bytes(a.cpu(), b)


def test_ops_route_cuda_tensors_to_kernels(cuda):
    build.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, (1, 2, 16, 16), torch.float32, cuda)
    ops.attention(q, q, q)
    ops.decode_attention(q[:, :, 0], q, q,
                         torch.full((1,), 16, dtype=torch.int32, device=cuda))
    ops.quantize_wire(q)
    la = torch.zeros((1, 2, 16), device=cuda)
    ops.delta(q, q, q, la, la + 0.5)
    assert dict(build.LAUNCHES) == {"flash_attention": 1,
                                    "decode_attention": 1,
                                    "quantize_int8_fused": 1,
                                    "delta_chunked": 1}


def _paged_pools(g, dev, dtype, B, Hkv, T, N, Dk, Dv, lengths):
    """Pools of distinct random pages per row, the rest of each table on a
    sink page, and NaN everywhere a row must not read: the sink page, the
    pages no table names and the rows of each last page past its length."""
    P = B * N + 2
    sink = P - 1
    kp = _randn(g, (Hkv, P, T, Dk), dtype, dev)
    vp = _randn(g, (Hkv, P, T, Dv), dtype, dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
    tables = torch.full((B, N), sink, dtype=torch.int32)
    used = []
    for b, L in enumerate(lengths):
        live = -(-L // T)
        ids = perm[b * N:b * N + live]
        tables[b, :live] = ids.to(torch.int32)
        used += ids.tolist()
        if L % T:
            kp[:, int(ids[-1]), L % T:] = float("nan")
            vp[:, int(ids[-1]), L % T:] = float("nan")
    dead = torch.ones(P, dtype=torch.bool)
    dead[used] = False
    kp[:, dead.to(dev)] = float("nan")
    vp[:, dead.to(dev)] = float("nan")
    return kp, vp, tables.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,N,Dk,Dv,window,lengths", [
    (3, 8, 2, 16, 5, 64, 64, 0, (80, 1, 37)),
    (2, 16, 1, 16, 20, 536, 472, 0, (320, 101)),     # absorbed-MLA shape
    (2, 4, 4, 8, 7, 32, 32, 20, (56, 23)),           # sliding window
    (4, 32, 8, 16, 40, 128, 128, 0, (640, 17, 300, 16)),   # GQA shape
    (3, 32, 32, 16, 20, 64, 64, 0, (320, 1, 77)),          # zamba2 MHA
    (3, 40, 8, 16, 40, 128, 128, 0, (640, 17, 300)),       # llama4, G 5
    (3, 48, 8, 16, 40, 128, 128, 0, (640, 17, 300)),       # mixtral, G 6
])
def test_paged_decode_matches_plain(cuda, dtype, B, Hq, Hkv, T, N, Dk, Dv,
                                    window, lengths):
    g = torch.Generator(device=cuda).manual_seed(5)
    kp, vp, tables = _paged_pools(g, cuda, dtype, B, Hkv, T, N, Dk, Dv,
                                  lengths)
    q = _randn(g, (B, Hq, Dk), dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = paged_decode_attention(q, kp, vp, tables, lens, window=window)
    torch.cuda.synchronize()
    want = paged_decode_attention_ref(q, kp, vp, tables, lens, window=window)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# the bf16 decode core's group sizes on the main paths: absorbed MLA (the
# tensor cores), mistral-nemo's GQA and zamba2's MHA (the bf16 stream)
_BF16_DECODE_GROUPS = [(64, 1, 536, 472), (32, 8, 128, 128), (32, 32, 64, 64)]
# ragged lengths: empty rows, one key, partly live last tiles, rows long
# enough that a worker takes runs of two rows
_BF16_DECODE_LENGTHS = (0, 1, 37, 4096, 1029, 0, 3000, 2049)


@pytest.mark.parametrize("Hq,Hkv,Dk,Dv", _BF16_DECODE_GROUPS)
@pytest.mark.parametrize("window", [0, 45])
@pytest.mark.parametrize("layout", ["dense", "paged8", "paged16", "paged12"])
def test_decode_bf16_core_matches_plain(cuda, Hq, Hkv, Dk, Dv, window,
                                        layout):
    """The bf16 decode core (rows 2 and 8) against the plain versions at G
    = 64, 4 and 1, on ragged lengths whose runs cross rows, with NaN in
    every key row no row may read: past each length in the dense cache
    (which GQA and MHA read in place through the model's transposed
    (B, S, Hkv, D) buffers), and on sink, dead and past-length rows of the
    page pools (pages of 8, 16 and 12 tokens)."""
    from repro_torch.kernels.decode_attn import sm_count, split_plan, tile_runs

    g = torch.Generator(device=cuda).manual_seed(15)
    bf = torch.bfloat16
    lengths = _BF16_DECODE_LENGTHS
    B, S = len(lengths), 4096
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = _randn(g, (B, Hq, Dk), bf, cuda)
    if layout == "dense":
        past = (torch.arange(S, device=cuda)[None, :]
                >= lens[:, None])[:, :, None, None]
        if Hq // Hkv >= 16:    # the MLA latent: (B, 1, S, D), contiguous
            kbuf, vbuf = _randn(g, (B, S, 1, Dk), bf, cuda), \
                _randn(g, (B, S, 1, Dv), bf, cuda)
        else:
            kbuf, vbuf = _randn(g, (B, S, Hkv, Dk), bf, cuda), \
                _randn(g, (B, S, Hkv, Dv), bf, cuda)
        k_fin = kbuf.transpose(1, 2).contiguous()
        v_fin = torch.where(past, 0.0, vbuf).to(bf).transpose(1, 2)
        kbuf.masked_fill_(past, float("nan"))
        vbuf.masked_fill_(past, float("nan"))
        k, v = kbuf.transpose(1, 2), vbuf.transpose(1, 2)
        got = decode_attention(q, k, v, lens, window=window)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, k_fin, v_fin.contiguous(), lens,
                                    window=window)
    else:
        T = int(layout[5:])
        S = -(-S // T) * T
        kp, vp, tables = _paged_pools(g, cuda, bf, B, Hkv, T, S // T, Dk, Dv,
                                      lengths)
        got = paged_decode_attention(q, kp, vp, tables, lens, window=window)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, tables, lens,
                                          window=window)
    plan = split_plan(B, Hq, Hkv, Dk, Dv, S, bf, sm_count(cuda), window)
    assert plan.core == ("wgmma" if Hq // Hkv >= 16 else "stream")
    runs = tile_runs(lengths, S, window, plan.tile, plan.workers, plan.runs,
                     plan.rmin)
    if window == 0:
        assert any(len({r for r, *_ in segs}) > 1 for segs in runs), \
            "no worker takes the runs of two rows"
    assert torch.isfinite(got.float()).all()
    assert not got[lens == 0].any()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-2)


# every group size the bf16 core serves: MLA (G 64, tensor cores), granite
# MQA (G 48: one 64-row tile, 16 rows of padding), qwen2.5 GQA (G 8: the
# stream's 8-head instance), mixtral and llama4 GQA (G 6 and 5: the same
# instance, its last heads idle), mistral-nemo and h2o-danube GQA (G 4,
# head dims 128 and 80), zamba2 MHA (G 1)
_INVARIANCE_GROUPS = [(64, 1, 536, 472), (48, 1, 128, 128),
                      (16, 2, 128, 128), (48, 8, 128, 128),
                      (40, 8, 128, 128), (32, 8, 128, 128), (32, 8, 80, 80),
                      (32, 32, 64, 64)]


@pytest.mark.parametrize("Hq,Hkv,Dk,Dv", _INVARIANCE_GROUPS)
@pytest.mark.parametrize("window", [0, 45])
@pytest.mark.parametrize("layout", ["dense", "paged16"])
def test_decode_bf16_rows_are_batch_invariant(cuda, Hq, Hkv, Dk, Dv, window,
                                              layout):
    """A row's bf16 decode output is bit for bit the same whatever its
    batch-mates' lengths: row 1's length moves (empty, one key, a partial
    tile, across the others, full) and every other row keeps its bits,
    dense and paged, at every group size the core serves (the split cuts
    each row by its own length, ``decode_attn.row_runs``).  Each output
    also matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(21)
    bf = torch.bfloat16
    base = list(_BF16_DECODE_LENGTHS)
    B, S, T = len(base), 4096, 16
    q = _randn(g, (B, Hq, Dk), bf, cuda)
    if layout == "dense":
        k = _randn(g, (B, Hkv, S, Dk), bf, cuda)
        v = _randn(g, (B, Hkv, S, Dv), bf, cuda)

        def run(lens):
            return decode_attention(q, k, v, lens, window=window)

        def plain(lens):
            return decode_attention_ref(q, k, v, lens, window=window)
    else:
        N = S // T
        kp = _randn(g, (Hkv, B * N + 1, T, Dk), bf, cuda)
        vp = _randn(g, (Hkv, B * N + 1, T, Dv), bf, cuda)
        tables = torch.randperm(B * N, generator=torch.Generator().manual_seed(
            4))[:B * N].reshape(B, N).to(torch.int32).to(cuda)

        def run(lens):
            return paged_decode_attention(q, kp, vp, tables, lens,
                                          window=window)

        def plain(lens):
            return paged_decode_attention_ref(q, kp, vp, tables, lens,
                                              window=window)

    def lens_of(x):
        return torch.tensor(x, dtype=torch.int32, device=cuda)

    want = run(lens_of(base))
    torch.testing.assert_close(want.float(), plain(lens_of(base)).float(),
                               atol=2e-3, rtol=2e-2)
    others = [b for b in range(B) if b != 1]
    for L in (0, 1, 17, 1029, 2500, S):
        lens = list(base)
        lens[1] = L
        got = run(lens_of(lens))
        torch.cuda.synchronize()
        moved = [b for b in others if not torch.equal(got[b], want[b])]
        assert not moved, f"row 1 at {L} moved rows {moved}"


@pytest.mark.parametrize("layout", ["dense", "paged16"])
@pytest.mark.parametrize("L", [100, 4095, 4096, 9000, 12001])
def test_decode_over_an_swa_ring_matches_plain(cuda, layout, L):
    """h2o-danube's decode (GQA 32/8, head dim 80, window 4096) over its
    ring: a (B, 4096) ring buffer, or the slot's ring table of 4096 / 16
    pages, holding the last min(L + 1, 4096) keys at slot pos % 4096; the
    model calls the kernel with ``min(L + 1, 4096)`` keys and no window.
    The kernel equals the plain version in bf16 and float32, and the ring
    (whatever order its slots hold) equals the plain decode over the last
    window of the keys in sequence order (softmax is order-free)."""
    g = torch.Generator(device=cuda).manual_seed(22)
    W, T, Hq, Hkv, D = 4096, 16, 32, 8, 80
    B = 3
    n = min(L + 1, W)
    for dtype in (torch.float32, torch.bfloat16):
        seq_k = _randn(g, (B, Hkv, L + 1, D), dtype, cuda)
        seq_v = _randn(g, (B, Hkv, L + 1, D), dtype, cuda)
        q = _randn(g, (B, Hq, D), dtype, cuda)
        pos = torch.arange(L + 1 - n, L + 1, device=cuda)
        ring_k = torch.zeros((B, Hkv, W, D), dtype=dtype, device=cuda)
        ring_v = torch.zeros_like(ring_k)
        ring_k[:, :, pos % W] = seq_k[:, :, pos]
        ring_v[:, :, pos % W] = seq_v[:, :, pos]
        lens = torch.full((B,), n, dtype=torch.int32, device=cuda)
        if layout == "dense":
            got = decode_attention(q, ring_k, ring_v, lens)
            want = decode_attention_ref(q, ring_k, ring_v, lens)
        else:
            N = W // T
            ids = torch.randperm(B * N, generator=torch.Generator(
            ).manual_seed(L)).reshape(B, N).to(torch.int32).to(cuda)
            kp = torch.zeros((Hkv, B * N + 1, T, D), dtype=dtype, device=cuda)
            vp = torch.zeros_like(kp)
            kp[:, ids.long()] = ring_k.reshape(B, Hkv, N, T, D).transpose(0, 1)
            vp[:, ids.long()] = ring_v.reshape(B, Hkv, N, T, D).transpose(0, 1)
            got = paged_decode_attention(q, kp, vp, ids, lens)
            want = paged_decode_attention_ref(q, kp, vp, ids, lens)
        torch.cuda.synchronize()
        window_order = decode_attention_ref(
            q, seq_k[:, :, L + 1 - n:].contiguous(),
            seq_v[:, :, L + 1 - n:].contiguous(), lens)
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(got.float(), window_order.float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(600, 600, 0), (512, 5120, 4608),
                                            (1000, 9000, 8000)])
def test_flash_swa_at_head_dim_80_matches_plain(cuda, dtype, Sq, Sk,
                                                q_offset):
    """h2o-danube's prefill attention (GQA 32/8, head dim 80, window 4096),
    a whole prompt and chunks after 4608 and 8000 tokens of prior (the
    chunk path keeps the whole prior and masks it by the window), against
    the plain version."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q = _randn(g, (1, 32, Sq, 80), dtype, cuda)
    k = _randn(g, (1, 8, Sk, 80), dtype, cuda)
    v = _randn(g, (1, 8, Sk, 80), dtype, cuda)
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          window=4096)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=True, q_offset=q_offset,
                               window=4096)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 128), (32, 32, 64)])
def test_decode_reads_the_transposed_cache_in_place(cuda, dtype, Hq, Hkv, D):
    """gqa_decode's (B, S, Hkv, D) buffers through transpose(1, 2): both
    cores read them where they lie and give exactly what they give on
    contiguous copies (the same keys in the same order)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    B, S = 3, 700
    q = _randn(g, (B, Hq, D), dtype, cuda)
    kbuf, vbuf = (_randn(g, (B, S, Hkv, D), dtype, cuda) for _ in range(2))
    lens = torch.tensor([700, 1, 333], dtype=torch.int32, device=cuda)
    k, v = kbuf.transpose(1, 2), vbuf.transpose(1, 2)
    got = ops.decode_attention(q, k, v, lens)
    want = ops.decode_attention(q, k.contiguous(), v.contiguous(), lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, lens).float(), atol=atol,
        rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,D", [(16, 64), (32, 96)])
def test_cross_decode_over_the_encoder_length_matches_plain(cuda, dtype, Hq,
                                                            D):
    """A cross block's decode (``attention.cross_decode``): every query
    over all S_enc rows of the encoder's K / V, read in place from the
    prefill's (B, S_enc, Hkv, D) leaves, equal to the kernel on contiguous
    copies and close to the plain version."""
    from repro_torch.configs.base import AttentionSpec
    from repro_torch.models.attention import cross_decode

    g = torch.Generator(device=cuda).manual_seed(18)
    B, S_enc = 2, 3000
    spec = AttentionSpec(kind="full", q_heads=Hq, kv_heads=Hq, head_dim=D,
                         rope=False, is_cross=True)
    p = {"wq": {"w": _randn(g, (1024, Hq * D), dtype, cuda, 1024 ** -0.5)},
         "wo": {"w": _randn(g, (Hq * D, 1024), dtype, cuda, (Hq * D) ** -0.5)}}
    x = _randn(g, (B, 1, 1024), dtype, cuda)
    cache = {n: _randn(g, (B, S_enc, Hq, D), dtype, cuda) for n in "kv"}
    build.reset_launches()
    y, out = cross_decode(p, x, spec, cache)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == 1 and out is cache
    q = (x @ p["wq"]["w"]).reshape(B, Hq, D)
    k, v = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
    full = torch.full((B,), S_enc, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, full)
    assert torch.equal(got, ops.decode_attention(q, k.contiguous(),
                                                 v.contiguous(), full))
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, full).float(), atol=atol,
        rtol=rtol)
    # the block output: ``wo`` sums Hq * D of the attention's differences
    want, _ = cross_decode(p, x, spec, cache, use_kernels=False)
    torch.testing.assert_close(y.float(), want.float(), atol=atol * 10,
                               rtol=rtol)


@pytest.mark.parametrize("op", ["dense", "paged"])
@pytest.mark.parametrize("fault", ["head_dim_36", "value_dim_44",
                                   "misaligned_q", "misaligned_k"])
def test_bf16_decode_core_refuses_what_it_cannot_take(cuda, op, fault):
    """A bf16 decode whose head dims are not multiples of 8, or whose
    tensors are not on a 16-byte boundary, raises ValueError before any
    launch: nothing falls back to the SIMT core or the plain version."""
    g = torch.Generator(device=cuda).manual_seed(16)
    bf = torch.bfloat16
    Dk = 36 if fault == "head_dim_36" else 64
    Dv = 44 if fault == "value_dim_44" else 64
    q = _randn(g, (2, 8, Dk), bf, cuda)
    k, v = _randn(g, (2, 2, 48, Dk), bf, cuda), _randn(g, (2, 2, 48, Dv), bf,
                                                       cuda)
    kp, vp = _randn(g, (2, 4, 16, Dk), bf, cuda), _randn(g, (2, 4, 16, Dv),
                                                         bf, cuda)
    tables = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([30, 17], dtype=torch.int32, device=cuda)
    if fault == "misaligned_q":
        q = _misaligned(q)
    if fault == "misaligned_k":
        k, kp = _misaligned(k), _misaligned(kp)
    build.reset_launches()
    with pytest.raises(ValueError):
        if op == "dense":
            decode_attention(q, k, v, lens)
        else:
            paged_decode_attention(q, kp, vp, tables, lens)
    assert not build.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,C,T,N,Ssuf,D", [
    (2, 4, 2, 40, 16, 3, 40, 32),
    (1, 4, 1, 64, 16, 5, 150, 64),       # chunk past the suffix's start
    (1, 32, 8, 128, 16, 8, 256, 128),    # GQA shape
    (1, 32, 32, 128, 16, 8, 200, 64),    # zamba2 MHA, head dim 64
    (1, 8, 2, 100, 16, 3, 150, 128),     # N * T = 48: a tile across both
    (2, 8, 8, 130, 8, 9, 130, 80),       # pages of 8, head dim 80
    (1, 40, 8, 128, 16, 8, 200, 128),    # llama4's prefix hit, G 5
])
def test_paged_prefill_matches_plain(cuda, dtype, B, Hq, Hkv, C, T, N, Ssuf,
                                     D):
    g = torch.Generator(device=cuda).manual_seed(6)
    kp, vp, tables = _paged_pools(g, cuda, dtype, B, Hkv, T, N, D, D,
                                  [N * T] * B)
    q = _randn(g, (B, Hq, C, D), dtype, cuda)
    ks = _randn(g, (B, Hkv, Ssuf, D), dtype, cuda)
    vs = _randn(g, (B, Hkv, Ssuf, D), dtype, cuda)
    got = paged_prefill_attention(q, kp, vp, tables, ks, vs)
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q, kp, vp, tables, ks, vs)
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_paged_prefill_reads_only_named_pages(cuda):
    """bf16 over a pool of 64 pages of which the tables name 10: NaN in
    every other page, and the output finite and equal to the plain
    version's."""
    g = torch.Generator(device=cuda).manual_seed(10)
    bf = torch.bfloat16
    Hkv, P, T, D, B, N = 2, 64, 16, 128, 2, 5
    kp = torch.full((Hkv, P, T, D), float("nan"), dtype=bf, device=cuda)
    vp = kp.clone()
    tables = torch.tensor([[40, 3, 17, 62, 9], [8, 33, 51, 0, 27]],
                          dtype=torch.int32, device=cuda)
    named = tables.flatten().long()
    kp[:, named] = _randn(g, (Hkv, B * N, T, D), bf, cuda)
    vp[:, named] = _randn(g, (Hkv, B * N, T, D), bf, cuda)
    q = _randn(g, (B, 8, 96, D), bf, cuda)
    ks = _randn(g, (B, Hkv, 120, D), bf, cuda)
    vs = _randn(g, (B, Hkv, 120, D), bf, cuda)
    got = paged_prefill_attention(q, kp, vp, tables, ks, vs)
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q, kp, vp, tables, ks, vs)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-2)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("op", ["flash", "paged_prefill"])
@pytest.mark.parametrize("fault", ["head_dim_36", "misaligned_q",
                                   "misaligned_k"])
def test_bf16_core_refuses_what_it_cannot_take(cuda, op, fault):
    """A bf16 head dim that is not a multiple of 8, or a tensor not on a
    16-byte boundary, raises ValueError before any launch."""
    g = torch.Generator(device=cuda).manual_seed(14)
    bf = torch.bfloat16
    D = 36 if fault == "head_dim_36" else 64
    q = _randn(g, (1, 4, 32, D), bf, cuda)
    k = _randn(g, (1, 2, 48, D), bf, cuda)
    kp = _randn(g, (2, 4, 16, D), bf, cuda)
    tables = torch.tensor([[2, 0]], dtype=torch.int32, device=cuda)
    if fault == "misaligned_q":
        q = _misaligned(q)
    if fault == "misaligned_k":
        k, kp = _misaligned(k), _misaligned(kp)
    build.reset_launches()
    with pytest.raises(ValueError):
        if op == "flash":
            flash_attention(q, k, k)
        else:
            paged_prefill_attention(q, kp, kp, tables, k, k)
    assert not build.LAUNCHES


@pytest.mark.parametrize("page_tokens,ok", [(16, True), (12, False)])
def test_bf16_decode_engine_refuses_pages_the_core_cannot_take(
        cuda, page_tokens, ok):
    """A bf16 paged decode engine on the card whose model runs the
    paged-prefill kernel refuses, when it is built, a page size the bf16
    core does not take, not at its first prefix-hit suffix prefill."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.params import init_params
    from repro_torch.serving.engine import DecodeEngine

    cfg = dataclasses.replace(get_smoke_config("mistral-nemo-12b"),
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)

    def build_engine():
        return DecodeEngine(Model(cfg), params, 2, 48, paged=True,
                            page_tokens=page_tokens)

    if ok:
        build_engine()
    else:
        with pytest.raises(ValueError):
            build_engine()


def test_paged_ops_route_cuda_tensors_to_kernels(cuda):
    build.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(7)
    kp = _randn(g, (2, 5, 16, 16), torch.float32, cuda)
    tables = torch.tensor([[0, 3], [1, 2]], dtype=torch.int32, device=cuda)
    q = _randn(g, (2, 4, 16), torch.float32, cuda)
    ops.paged_decode_attention(q, kp, kp, tables,
                               torch.tensor([20, 9], device=cuda))
    qc = _randn(g, (2, 4, 8, 16), torch.float32, cuda)
    ks = _randn(g, (2, 2, 8, 16), torch.float32, cuda)
    ops.paged_prefill_attention(qc, kp, kp, tables, ks, ks)
    assert dict(build.LAUNCHES) == {"paged_decode_attention": 1,
                                    "paged_prefill_attention": 1}


# -------------------------------------------------- the decode block as a graph

_DECODE_LENS = ([19, 40, 33, 7], [50, 12, 28, 61])  # two waves of four


def _decode_engines(cuda, arch, paged):
    """A smoke model on the card and a maker of its decode engines."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.params import init_params
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine

    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    model = Model(cfg)

    def make(graphs, **sampling):
        return DecodeEngine(model, params, 4, 128, block_size=4, paged=paged,
                            page_tokens=16, graphs=graphs, **sampling)

    return cfg, PrefillEngine(model, params, min_bucket=32), make


def _wave(cfg, peng, lens, seed, rid0):
    """Admission entries of one prefilled wave of prompts."""
    from repro_torch.serving.api import Request
    from repro_torch.serving.engine import trim_request_cache

    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (len(lens), max(lens))).astype(np.int32)
    first, caches, _ = peng.prefill(toks, np.asarray(lens, np.int32))
    return [(Request(rid=rid0 + i, tokens=toks[i, :L], max_new_tokens=9 + i),
             int(first[i]), trim_request_cache(caches, i, L), L)
            for i, L in enumerate(lens)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["kimi-linear-1t", "mistral-nemo-12b",
                                  "zamba2-1.2b", "h2o-danube-1.8b",
                                  "xlstm-350m"])
def test_replayed_block_matches_eager(cuda, arch, paged):
    """The captured block, replayed, emits the eager block's tokens, two
    waves of admissions with budgets ending mid-block; one capture
    (``warmup_block``) serves every block."""
    cfg, peng, make = _decode_engines(cuda, arch, paged)
    waves = [_wave(cfg, peng, lens, w, 10 * w)
             for w, lens in enumerate(_DECODE_LENS)]
    outs = []
    for graphs in (True, False):
        dec = make(graphs)
        dec.warmup_block()
        for wave in waves:
            assert dec.admit_many(wave) == len(wave)
            dec.run_until_drained()
        assert dec.block_compiles == (1 if graphs else 0)
        outs.append({rid: r.output_tokens for rid, r in dec.outputs.items()})
    assert len(outs[0]) == 8 and outs[0] == outs[1]


def test_replays_add_the_captured_launches(cuda):
    """A capture launches nothing; each replay adds the launches the capture
    recorded, which are those of one eager block."""
    cfg, peng, make = _decode_engines(cuda, "kimi-linear-1t", True)
    dec = make(True)
    build.reset_launches()
    dec.warmup_block()               # an eager block, then the capture
    torch.cuda.synchronize()
    eager = dict(build.LAUNCHES)
    assert set(eager) == {"paged_decode_attention"}
    assert dict(dec._graph_launches) == eager
    dec.admit_many(_wave(cfg, peng, _DECODE_LENS[0], 0, 0))
    build.reset_launches()
    n = dec.run_until_drained()
    assert n >= 2 and dec.block_compiles == 1
    assert dict(build.LAUNCHES) == {k: n * v for k, v in eager.items()}


def test_capture_that_syncs_the_host_raises(cuda):
    """A block that syncs the host cannot be captured: the capture raises,
    no graph is kept, and nothing falls back to the eager loop."""
    cfg, peng, make = _decode_engines(cuda, "mistral-nemo-12b", False)
    dec = make(True)
    decode_step = dec.model.decode_step

    def syncing(*args, **kw):
        logits, caches = decode_step(*args, **kw)
        float(logits[0, 0])          # a host read of a device value
        return logits, caches

    dec.model.decode_step = syncing
    with pytest.raises(RuntimeError):
        dec.warmup_block()
    assert dec.block_compiles == 0 and dec._graph is None


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["kimi-linear-1t", "zamba2-1.2b"])
def test_sampled_replay_matches_eager(cuda, arch, paged):
    """At temperature 0.8, top-k 50 the replayed graph reads the step
    counter from its static buffer: its samples equal the eager block's,
    and differ from a second seed's."""
    cfg, peng, make = _decode_engines(cuda, arch, paged)
    waves = [_wave(cfg, peng, lens, w, 10 * w)
             for w, lens in enumerate(_DECODE_LENS)]
    outs = []
    for graphs, seed in ((True, 3), (False, 3), (True, 4)):
        dec = make(graphs, temperature=0.8, top_k=50, seed=seed)
        dec.warmup_block()
        for wave in waves:
            assert dec.admit_many(wave) == len(wave)
            dec.run_until_drained()
        assert dec.block_compiles == (1 if graphs else 0)
        outs.append({rid: r.output_tokens for rid, r in dec.outputs.items()})
    assert len(outs[0]) == 8 and outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_sample_hash_is_the_same_on_the_card(cuda):
    """The sampler's integer noise is bit-identical on the CPU and the
    card (and so are the tokens it picks from the same logits)."""
    from repro_torch.serving.engine import sample_hash, sample_tokens

    for seed, step in ((0, 0), (7, 123456), (2 ** 40 + 5, 2 ** 33 + 9)):
        cpu = sample_hash(seed, torch.tensor(step), 8, 163840)
        dev = sample_hash(seed, torch.tensor(step, device=cuda), 8, 163840)
        assert torch.equal(cpu, dev.cpu())
    logits = torch.randn((8, 4096), generator=torch.Generator()
                         .manual_seed(0))
    kw = dict(temperature=0.8, top_k=50, seed=1)
    assert torch.equal(
        sample_tokens(logits, torch.tensor(5), **kw),
        sample_tokens(logits.to(cuda), torch.tensor(5, device=cuda),
                      **kw).cpu())


def test_calibration_sweep_launches_the_flash_kernel(cuda, tmp_path):
    """The sweep's attention is the hand-written flash kernel on the card
    (bf16), and its points lie in (0, 1]."""
    from repro_torch.analysis import calibrate

    build.reset_launches()
    out = calibrate.sweep(str(tmp_path / "cal.json"), cuda, torch.bfloat16,
                          smoke=True, lens=(256, 1024))
    assert build.LAUNCHES["flash_attention"] > 0
    assert all(0.0 < p["mfu"] <= 1.0 for p in out["points"])
    assert calibrate.load_calibration(str(tmp_path / "cal.json")).points


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["kimi-linear-1t", "mistral-nemo-12b",
                                  "zamba2-1.2b", "h2o-danube-1.8b",
                                  "xlstm-350m"])
def test_spec_replay_matches_eager(cuda, arch, paged):
    """The speculative block (``spec_k=2``, one-token n-grams), replayed,
    emits the eager block's tokens over two waves of admissions, with one
    capture (``warmup_block``) for every block; in float32 (the smoke
    configs), where the decode cores are row-independent, those are the
    plain graph's greedy tokens."""
    cfg, peng, make = _decode_engines(cuda, arch, paged)
    waves = [_wave(cfg, peng, lens, w, 10 * w)
             for w, lens in enumerate(_DECODE_LENS)]
    outs = []
    for graphs, spec_k in ((True, 2), (False, 2), (True, 0)):
        dec = make(graphs, spec_k=spec_k, spec_ngram=1)
        dec.warmup_block()
        for wave in waves:
            assert dec.admit_many(wave) == len(wave)
            dec.run_until_drained()
        if spec_k:
            assert dec.spec_compiles == (1 if graphs else 0)
            assert dec.block_compiles == 0
            assert dec.accepted_tokens >= dec.verify_rounds > 0
        else:
            assert dec.block_compiles == 1 and dec.spec_compiles == 0
        outs.append({rid: r.output_tokens for rid, r in dec.outputs.items()})
    assert len(outs[0]) == 8 and outs[0] == outs[1]
    assert outs[0] == outs[2]


def test_spec_block_syncs_the_host_once(cuda):
    """The speculative block's device work never syncs the host (replayed
    and run eagerly under ``torch.cuda.set_sync_debug_mode("error")``),
    and a ``step_block`` copies from the device to the host once: the
    block's predictions and accept counts."""
    from torch.profiler import ProfilerActivity, profile

    cfg, peng, make = _decode_engines(cuda, "kimi-linear-1t", True)
    dec = make(True, spec_k=2, spec_ngram=1)
    dec.warmup_block()
    dec.admit_many(_wave(cfg, peng, _DECODE_LENS[0], 0, 0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec._graph.replay()
        dec._run_spec_block()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.step_block()
        torch.cuda.synchronize()
    d2h = sum(e.count for e in prof.key_averages()
              if e.key.startswith("Memcpy DtoH"))
    assert d2h == 1


def test_verify_attention_matches_plain(cuda):
    """``ops.verify_attention`` on the card (three calls of the decode
    kernel) against its one-pass plain version at mistral-nemo's GQA
    shape, bf16, ragged lengths up to the buffer's end."""
    g = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    q = _randn(g, (8, 32, 3, 128), bf, cuda)
    k = _randn(g, (8, 8, 4096, 128), bf, cuda)
    v = _randn(g, (8, 8, 4096, 128), bf, cuda)
    lens = torch.tensor([4096, 3001, 2500, 1800, 1024, 700, 97, 4094],
                        dtype=torch.int32, device=cuda)
    build.reset_launches()
    got = ops.verify_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"decode_attention": 3}
    from repro_torch.kernels.decode_attn import verify_attention_ref
    want = verify_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[bf][0], rtol=TOL[bf][1])


def test_moe_dropless_is_repeatable(cuda):
    """The prefill MoE's combine adds in a fixed order: three calls at
    kimi-linear-1t's expert widths (d_model 7168, d_ff 2048, top-8 of 32
    experts + 1 shared, bf16) on 4096 rows give the same bits."""
    from repro_torch.configs.base import FFNSpec
    from repro_torch.models.layers import apply_moe_dropless

    g = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    d, f, E = 7168, 2048, 32
    spec = FFNSpec(kind="moe", d_ff=f, activation="swiglu", num_experts=E,
                   top_k=8, shared_experts=1)
    p = {"router": _randn(g, (d, E), torch.float32, cuda, d ** -0.5),
         "w1": _randn(g, (E, d, f), bf, cuda, d ** -0.5),
         "w3": _randn(g, (E, d, f), bf, cuda, d ** -0.5),
         "w2": _randn(g, (E, f, d), bf, cuda, f ** -0.5),
         "shared": {"w1": _randn(g, (d, f), bf, cuda, d ** -0.5),
                    "w3": _randn(g, (d, f), bf, cuda, d ** -0.5),
                    "w2": _randn(g, (f, d), bf, cuda, f ** -0.5)}}
    x = _randn(g, (4096, d), bf, cuda)
    with torch.no_grad():
        ys = [apply_moe_dropless(p, x, spec) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def test_moe_capacity_is_repeatable(cuda):
    """The training MoE (capacity drop, fixed-order combine) and its
    gradients give the same bits call after call: three forward and
    backward passes at mixtral-8x22b's expert widths (d_model 6144, d_ff
    16384, top-2 of 8, bf16) on 4096 rows, capacity factor 0.5 so pairs
    are dropped, plus the load-balance loss."""
    from repro_torch.configs.base import FFNSpec
    from repro_torch.models.layers import (_route, _sorted_pairs, apply_moe,
                                           capacity_plan, moe_aux_loss)

    g = torch.Generator(device=cuda).manual_seed(1)
    bf = torch.bfloat16
    d, f, E = 6144, 16384, 8
    spec = FFNSpec(kind="moe", d_ff=f, activation="swiglu", num_experts=E,
                   top_k=2, capacity_factor=0.5)
    p = {"router": _randn(g, (d, E), torch.float32, cuda, d ** -0.5),
         "w1": _randn(g, (E, d, f), bf, cuda, d ** -0.5),
         "w3": _randn(g, (E, d, f), bf, cuda, d ** -0.5),
         "w2": _randn(g, (E, f, d), bf, cuda, f ** -0.5)}
    for w in p.values():
        w.requires_grad_()
    x = _randn(g, (4096, d), bf, cuda).requires_grad_()
    up = _randn(g, (4096, d), bf, cuda)
    with torch.no_grad():
        keep, _ = capacity_plan(_sorted_pairs(*_route(p, x, 2))[1], 4096,
                                spec)
    assert not bool(keep.all())
    runs = []
    for _ in range(3):
        y = apply_moe(p, x, spec)
        aux = moe_aux_loss(p, x, spec)
        loss = (y.float() * up.float()).sum() + aux
        runs.append([y.detach(), aux.detach(), *torch.autograd.grad(
            loss, [x, *p.values()])])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.fixture
def card_mesh(cuda):
    """The (1, 1) ("data", "model") mesh of one card, on a world-1 NCCL
    group, destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh("cuda")
    yield mesh
    dist.destroy_process_group()


def _sharded_case(name):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.examples.train_100m import hybrid_lm
    if name == "hybrid":
        return hybrid_lm("100m"), ("delta_chunked", "flash_attention")
    cfg = get_config("zamba2-1.2b")
    cfg = dataclasses.replace(cfg, dtype="float32", groups=(
        dataclasses.replace(cfg.groups[0], repeats=1),) + cfg.groups[1:])
    return cfg, ("gla_chunked", "flash_attention")


@pytest.mark.parametrize("name", ["zamba2", "hybrid"])
def test_sharded_step_matches_one_device(card_mesh, name):
    """One step of ``spmd.make_sharded_train_step`` on the card's (1, 1)
    mesh against one of the one-device ``make_train_step``, from the same
    params and batch, float32, two microbatches of 1 x 512 tokens:
    zamba2-1.2b at every width, one [5 x Mamba2, shared block] unit and
    its tail, and the KDA:MLA recipe at 100m.  The loss and grad norm
    within 1e-5 relative and every param within 1e-4 abs / 1e-3 rel (as
    ``tests/test_torch_train_step.py``); the scan and flash kernels
    launched inside the sharded step."""
    from repro_torch.distributed import spmd
    from repro_torch.models import Model
    from repro_torch.models.tree import tree_flatten_with_path, tree_map
    from repro_torch.params import init_params, requires_grad
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                      TrainConfig, init_opt_state,
                                      make_train_step)

    cfg, need = _sharded_case(name)
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tc = TrainConfig(microbatches=2, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20))
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                   global_batch=2)).batch(0)
    model = Model(cfg, remat=True)
    sharded = tree_map(lambda x: x.clone(), params)
    one = requires_grad(params)
    one, _, m_one = make_train_step(model, tc)(
        one, init_opt_state(one, tc), batch)
    state = spmd.shard_opt_state(init_opt_state(sharded, tc), card_mesh)
    sharded = requires_grad(spmd.shard_params(sharded, card_mesh))
    build.reset_launches()
    sharded, _, m_sh = spmd.make_sharded_train_step(model, tc, card_mesh)(
        sharded, state, batch)
    torch.cuda.synchronize()
    for kernel in need:
        assert build.LAUNCHES.get(kernel, 0) > 0, kernel
    for key in ("loss", "grad_norm", "lr"):
        assert float(m_sh[key]) == pytest.approx(float(m_one[key]),
                                                 rel=1e-5), key
    got = dict(tree_flatten_with_path(spmd.gather_tree(sharded)))
    for path, want in tree_flatten_with_path(one):
        torch.testing.assert_close(got[path].detach(), want.detach(),
                                   atol=1e-4, rtol=1e-3, msg=path)
