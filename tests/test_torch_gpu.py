"""Hand-written Hopper kernels of the port against their plain PyTorch
versions, on the card.

Marked ``gpu``: every test asks for the ``cuda`` fixture, which skips when
no CUDA device is present (decided inside the fixture, so every worker
collects the same tests).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (abs, rel): float32 inputs 2e-5, 2e-5 (the plain and kernel
sums run in other orders); bfloat16 outputs 2e-3, 2e-2 (a bf16 ulp is 2^-8
of the value, and the outputs of unit inputs are as small as ~0.02); the
delta rule 1e-4, 1e-3 (as ``tests/test_kernels_delta.py``) for its float32
state at either input dtype and its float32 output; quantize
byte-identical.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)
from repro_torch.kernels.delta import (delta_chunked_fused, delta_chunked_ref,
                                       mask_padded)
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
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
                                    "delta_chunked_fused": 1}
