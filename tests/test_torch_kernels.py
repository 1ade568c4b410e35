"""The port's plain kernel versions against the reference's Pallas kernels
(interpret mode on the CPU) and the reference's jnp oracles, on inputs made
with numpy from a seed; plus the port's dispatch and import rules.

Tolerances: float32 2e-5 (sums in other orders); the delta rule 1e-4 abs /
1e-3 rel, as ``tests/test_kernels_delta.py``; quantize byte-identical.
The CUDA kernels themselves are checked on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attention as jax_decode_kernel
from repro.kernels.delta import delta_chunked_fused as jax_delta_kernel
from repro.kernels.flash_attn import flash_attention as jax_flash_kernel
from repro.kernels.quantize import quantize_int8_fused as jax_quant_kernel
from repro_torch.kernels import build, ops
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.delta import CHUNK, delta_chunked_fused
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.quantize import quantize_int8_fused

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, *wants, atol=2e-5, rtol=2e-5):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,Dk,Dv,q_offset,window", [
    (1, 4, 2, 64, 64, 32, 16, 0, 0),       # GQA, Dk != Dv
    (2, 4, 4, 40, 104, 48, 32, 64, 0),     # chunk queries over a prior
    (1, 2, 1, 96, 96, 16, 16, 0, 24),      # MQA, sliding window
])
def test_flash_plain_matches_reference(B, Hq, Hkv, Sq, Sk, Dk, Dv, q_offset,
                                       window):
    r = _rng(0)
    q = r.standard_normal((B, Hq, Sq, Dk)).astype(np.float32)
    k = r.standard_normal((B, Hkv, Sk, Dk)).astype(np.float32)
    v = r.standard_normal((B, Hkv, Sk, Dv)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    pallas = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              interpret=True, block_q=32, block_k=32, **kw)
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    _close(got.numpy(), pallas, oracle)


@pytest.mark.parametrize("B,Hq,Hkv,S,Dk,Dv,window", [
    (3, 4, 1, 80, 48, 32, 0),              # absorbed-MLA shape: MQA, Dk != Dv
    (2, 4, 2, 64, 16, 16, 20),
])
def test_decode_plain_matches_reference(B, Hq, Hkv, S, Dk, Dv, window):
    r = _rng(1)
    q = r.standard_normal((B, Hq, Dk)).astype(np.float32)
    k = r.standard_normal((B, Hkv, S, Dk)).astype(np.float32)
    v = r.standard_normal((B, Hkv, S, Dv)).astype(np.float32)
    lengths = np.array([S, 1, 37][:B], np.int32)          # ragged
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lengths),
                               window=window)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths))
    pallas = jax_decode_kernel(*args, window=window, block_k=32,
                               interpret=True)
    oracle = jref.decode_attention_ref(*args, window=window)
    _close(got.numpy(), pallas, oracle)


def _delta_inputs(seed, B, H, S, dk, dv):
    r = _rng(seed)
    q = r.standard_normal((B, H, S, dk)).astype(np.float32)
    k = r.standard_normal((B, H, S, dk)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = r.standard_normal((B, H, S, dv)).astype(np.float32)
    la = (-0.1 * np.abs(r.standard_normal((B, H, S)))).astype(np.float32)
    beta = r.uniform(0.1, 1.0, (B, H, S)).astype(np.float32)
    s0 = (0.1 * r.standard_normal((B, H, dk, dv))).astype(np.float32)
    return q, k, v, la, beta, s0


@pytest.mark.parametrize("B,H,S,dk,dv,lens", [
    (2, 2, 96, 16, 16, (96, 41)),
    (2, 3, 70, 32, 48, (3, 70)),
])
def test_delta_fused_plain_matches_reference(B, H, S, dk, dv, lens):
    q, k, v, la, beta, s0 = _delta_inputs(2, B, H, S, dk, dv)
    lengths = np.array(lens, np.int32)
    o, st = ops.delta(*map(torch.from_numpy, (q, k, v, la, beta, s0)),
                      lengths=torch.from_numpy(lengths))
    jargs = [jnp.asarray(x) for x in (q, k, v, la, beta)]
    po, pst = jax_delta_kernel(*jargs, jnp.asarray(lengths), jnp.asarray(s0),
                               chunk=CHUNK, interpret=True)
    jo, jst = jops.delta(*jargs, jnp.asarray(s0),
                         lengths=jnp.asarray(lengths), chunk=CHUNK)
    valid = np.arange(S)[None, :] < lengths[:, None]          # (B, S)
    sel = np.broadcast_to(valid[:, None], (B, H, S))
    for want in (po, jo):
        np.testing.assert_allclose(o.numpy()[sel], np.asarray(want)[sel],
                                   atol=1e-4, rtol=1e-3)
    _close(st.numpy(), pst, jst, atol=1e-4, rtol=1e-3)


def test_delta_step_matches_reference():
    q, k, v, la, beta, s0 = _delta_inputs(3, 2, 3, 1, 16, 24)
    args = (q[:, :, 0], k[:, :, 0], v[:, :, 0], la[:, :, 0], beta[:, :, 0],
            s0)
    o, st = ops.delta_step(*map(torch.from_numpy, args))
    jo, jst = jref.delta_step_ref(*map(jnp.asarray, args))
    _close(o.numpy(), jo)
    _close(st.numpy(), jst)


@pytest.mark.parametrize("shape", [(7, 33), (1, 1, 100, 32), (256, 128),
                                   (1,)])
def test_quantize_plain_byte_identical(shape):
    x = (3.0 * _rng(4).standard_normal(shape)).astype(np.float32)
    q, s = ops.quantize_wire(torch.from_numpy(x))
    for jq, js in (jref.quantize_int8_ref(jnp.asarray(x)),
                   jax_quant_kernel(jnp.asarray(x), interpret=True)):
        assert q.dtype == torch.int8 and tuple(q.shape) == shape
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU every op runs its plain version (no launch is counted);
    the CUDA wrappers themselves refuse CPU tensors instead of falling
    back."""
    build.reset_launches()
    x = torch.randn(1, 2, 8, 16)
    lens = torch.full((1,), 8, dtype=torch.int32)
    ops.attention(x, x, x)
    ops.decode_attention(x[:, :, 0], x, x, lens)
    ops.quantize_wire(x)
    ops.delta(x, x, x, torch.zeros(1, 2, 8), torch.ones(1, 2, 8))
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(x[:, :, 0].contiguous(), x, x, lens)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_fused(x)
    with pytest.raises(ValueError, match="CUDA"):
        delta_chunked_fused(x, x, x, torch.zeros(1, 2, 8),
                            torch.ones(1, 2, 8), lens,
                            torch.zeros(1, 2, 16, 16))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.params; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
