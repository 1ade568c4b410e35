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
from repro_torch.kernels.delta import (delta_chunked, delta_chunked_fused,
                                       delta_chunked_ref, mask_padded)
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.gla import (gla_chunked, gla_chunked_fused,
                                     gla_chunked_ref)
from repro_torch.kernels.paged_decode_attn import (
    paged_decode_attention, paged_decode_attention_ref)
from repro_torch.kernels.paged_prefill_attn import (
    paged_prefill_attention, paged_prefill_attention_ref)
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
@pytest.mark.parametrize("B,Hq,Hkv,S,Dk,Dv,window", [
    (3, 4, 1, 100, 48, 32, 0),
    (2, 64, 1, 1000, 536, 472, 0),
    (2, 8, 2, 300, 64, 64, 50),
    (3, 32, 32, 300, 64, 64, 0),              # zamba2: one head per group
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


def test_gla_op_routes_cuda_tensors_to_the_kernel(cuda):
    build.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(9)
    q = _randn(g, (1, 2, 16, 16), torch.float32, cuda)
    ops.gla(q, q, q, torch.zeros((1, 2, 16), device=cuda))
    ops.gla(q, q, q, torch.zeros((1, 2, 16), device=cuda),
            lengths=torch.tensor([9], device=cuda))
    assert dict(build.LAUNCHES) == {"gla_chunked": 1, "gla_chunked_fused": 1}


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
# enough that the workers' runs cross row boundaries
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
    runs = tile_runs(lengths, S, window, plan.tile, plan.workers)
    if window == 0:
        assert any(len(segs) > 1 for segs in runs), "no run crosses a row"
    assert torch.isfinite(got.float()).all()
    assert not got[lens == 0].any()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                               rtol=2e-2)


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
