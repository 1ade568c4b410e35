"""Per-tensor symmetric int8 wire encode: the plain PyTorch version and the
CUDA kernel's wrapper.

The kernel (``csrc/quantize.cu``) replaces the TPU kernel
``src/repro/kernels/quantize.py::quantize_int8_fused``; the plain version
follows ``src/repro/kernels/ref.py::quantize_int8_ref``.  The two are
byte-identical: same max, IEEE divide, round-half-even and clip.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build


def quantize_int8_ref(x):
    """x float32 -> (q int8 of x's shape, scale float32 0-d tensor)."""
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_fused(x):
    """The CUDA kernel: same contract as :func:`quantize_int8_ref` on a
    contiguous float32 CUDA tensor."""
    name = "quantize_int8_fused"
    _build.require_cuda(name, x)
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: takes float32, got {x.dtype}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((1,), dtype=torch.float32, device=x.device)
    amax = torch.empty((1,), dtype=torch.int32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = _build.library()
    err = lib.prfaas_quantize_int8(x.data_ptr(), q.data_ptr(),
                                   scale.data_ptr(), amax.data_ptr(),
                                   x.numel(), sms, _build.stream_ptr(x))
    _build.check(name, err)
    _build.LAUNCHES[name] += 1
    return q, scale.reshape(())
