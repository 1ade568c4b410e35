"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, into an object with a plain C interface; the objects are linked
into one shared library loaded with ``ctypes``.  The library is built at
first use into ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and concurrent processes never load a half-written file.

Nothing here runs at import: ``library()`` builds on the first call, and
raises when there is no ``nvcc`` (the CPU tests never call it).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attn.cu", "decode_attn.cu", "delta.cu", "quantize.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel wrapper; a wrapper adds one where it launches
LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "prfaas_flash_attention": [_P] * 4 + [_I] * 10 + [_F, _I, _P],
    "prfaas_decode_attention": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _I, _P],
    "prfaas_delta_fused": [_P] * 9 + [_I] * 6 + [_P],
    "prfaas_quantize_int8": [_P, _P, _P, _P, _L, _I, _P],
}

_lib = None


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source tree is not built yet) and return
    the library path.  The ptxas report (registers, shared memory, spills
    per kernel) is kept beside it as ``<lib>.log``."""
    lib = BUILD_DIR / f"libprfaas_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src}\n{out}")
            if p.returncode != 0:
                for _, _, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            objs.append(str(obj))
        part = Path(tmp) / lib.name
        res = subprocess.run([nvcc, "-shared", "-o", str(part), *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        os.replace(Path(tmp) / "build.log", str(lib) + ".log")
        os.replace(part, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.prfaas_error_string.argtypes = [ctypes.c_int]
        lib.prfaas_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, err: int):
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().prfaas_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def require_cuda(name: str, *tensors):
    """Validate what every kernel wrapper needs: CUDA, contiguous, one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: kernel takes CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
