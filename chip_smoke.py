#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout (it imports ``src/repro_torch``, never JAX or
the reference package ``src/repro``).  Phases, each fatal on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one process
     per source, all at once);
  3. hold each of the nine kernels against its plain PyTorch version on
     the card at the main paths' full-width shapes, and time kernel, plain
     version and (for the attention kernels) PyTorch's SDPA as a yardstick
     (flash and paged prefill also give their achieved TFLOP/s and share of
     the bound, and are checked also at mistral-nemo's dense GQA chunks
     and zamba2's paged MHA suffix, so at each bf16 core instance a main
     path runs; the dense and paged decode at the three group sizes the
     main paths run, MLA, GQA and MHA, and the paged one also at zamba2's
     decode block, 8 rows of 4000 tokens), after printing the ptxas
     registers and spills of the bf16 decode core's instances;
     then each differentiable op (attention, gla and delta, with and
     without lengths) at the training paths' shapes and types: its kernel
     forward against the plain version's outputs, and its gradients
     against autograd through the plain version (the same plain backward
     on both sides, so a check of the wiring);
  4. drive the main paths, each with every kernel launch counted from 0,
     through ``CrossDCDeployment`` serving prompts of 100-12000 tokens
     through both routes with int8 wire compression and chunked prefill,
     then a later turn of one session:
       * ``kimi-linear-1t`` at its published widths (depth cut to one
         [KDA, KDA, KDA, MLA] unit and the MoE to 32 of its 352 experts, so
         the bf16 weights, ~17.8 GB, fit the card), with the dense KV
         layout and then with paged KV;
       * ``mistral-nemo-12b`` at full width and depth (40 layers, ~24.5 GB
         of bf16 weights), paged, where the later turn resumes from the
         device pages of its cached prefix and prefills only its suffix;
       * ``zamba2-1.2b`` at full width and depth (32 Mamba2 layers and a
         shared attention + FFN block invoked 6 times, ~2.5 GB of bf16
         weights), dense and then paged, with a page-aligned 4992-token
         session whose later turn, paged, pins 4992 cached tokens (pool
         pages and the Mamba2 state snapshot) and prefills 600;
     random weights from a seed, each model's weights freed before the
     next one's load;
  5. compare logits through the kernels with those through the plain
     versions (largest difference within 2 % of the largest |logit|): one
     prefill batch of kimi in bf16; one prefill batch and one paged decode
     step of mistral-nemo-12b and of zamba2-1.2b, recorded in bf16 and held
     in float32 (over their 38-40 layers bf16 rounding flips compound by
     themselves: ~2 % on mistral-nemo, ~11 % on zamba2's prefill, on an
     H100), and zamba2's bf16 prefill logits through the kernels no
     further from the float32 plain logits than 1.5x the plain bf16
     logits' distance; time the MLA paged decode's whole-pool [ckv, kpe]
     concatenation against a decode step; and profile one paged decode
     block of mistral-nemo-12b and of zamba2-1.2b, and one 4096-token
     prefill of each (``torch.profiler``: device busy time, the largest
     kernels and the flash and decode kernels' shares);
  6. the training path on ``zamba2-1.2b`` at full width and depth: four
     AdamW steps of 2 x 2048 tokens in two microbatches with remat
     through ``make_train_step`` (the Mamba2 mixers on the unmasked GLA
     kernel, row 6), one more profiled; then the loss and gradients of one
     2048-token row through the kernels against the plain versions, bf16
     recorded and float32 gated, and the bf16 gradients through the
     kernels no further from the float32 ones than 1.5x the plain bf16
     gradients' distance;
  7. the reference's KDA:MLA 3:1 training recipe at its 100m scale
     (``repro_torch.examples.train_100m``): 30 steps of 8 x 1024 tokens
     through ``TrainLoop`` with checkpoints in a temporary directory (the
     KDA mixers on the unmasked delta kernel, row 5); its loss must fall.

The last lines are the main paths' summary, the ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, when there is no CUDA device or no
port beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12           # dense bf16 tensor-core peak
F32_FLOP_S = 67e12             # float32 outside the tensor cores

# tolerances of the kernel-vs-plain checks
TOL_BF16 = (2e-3, 2e-2)        # bf16 outputs (abs, rel)
TOL_STATE = (1e-4, 1e-3)       # the delta rule's float32 state (abs, rel)
# gradients through a kernel's forward vs autograd through its plain
# version (the same plain backward, float32): fraction of the largest
TOL_GRAD = 1e-5
# a float32 train step's loss and global gradient norm, kernels vs plain
# versions (relative)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
# the same step in bf16: the relative L2 distance of the gradients through
# the kernels from the float32 plain gradients of the same weights, as a
# multiple of that of the bf16 plain gradients
TOL_BF16_GRAD_RATIO = 1.5
# the same for zamba2's bf16 prefill logits: their relative L2 distance
# from the float32 plain logits through the kernels, as a multiple of that
# through the plain versions
TOL_BF16_LOGIT_RATIO = 1.5
# first-token logits through kernels vs plain versions, bf16 model: the
# largest difference may be this fraction of the largest |logit|
TOL_LOGITS = 2e-2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float, flop_s: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the decode kernels' check shapes (rows 2 and 8): lengths of the 8 rows,
# and the group sizes the main paths run (tag, Hq, Hkv, Dk, Dv, scale)
CHECK_LENGTHS = (16384, 12001, 9000, 5601, 3800, 1501, 701, 101)
DECODE_GROUPS = (("MLA", 64, 1, 536, 472, 192 ** -0.5),
                 ("GQA", 32, 8, 128, 128, 128 ** -0.5),
                 ("MHA", 32, 32, 64, 64, 64 ** -0.5))


def _decode_case(torch, close, atol_needed, name, run, plain, q, k, v, lens,
                 scale, extra, tables=None):
    """One decode shape: the kernel against its plain version, its time,
    the plain version's, SDPA's over the same (or, paged, the gathered)
    cache with the G query heads of a cache head as G query rows, and the
    bound from the live bytes (each live key's K and V rows once, q, the
    output, lengths and ``extra``) and FLOPs."""
    import torch.nn.functional as F

    o = run()
    torch.cuda.synchronize()
    o_ref = plain()
    e = close(name, o, o_ref, *TOL_BF16)
    B, Hq, Dk = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    if tables is not None:
        from repro_torch.kernels.paged_decode_attn import gather_pages
        Hkv = k.shape[0]
        k, v = gather_pages(k, tables), gather_pages(v, tables)
    S = k.shape[2]
    keys = int(lens.sum())
    qg = q.reshape(B, Hkv, Hq // Hkv, Dk)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None])[:, None, None]
    bnd = _bound(_nbytes(q, o, lens, *extra) + keys * Hkv * (Dk + Dv) * 2,
                 2 * Hq * keys * (Dk + Dv), BF16_FLOP_S)
    entry = dict(
        max_abs_err=e, atol_needed=atol_needed(o, o_ref),
        ms=_ms(run, 20), plain_ms=_ms(plain, 3),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=_ms(lambda: F.scaled_dot_product_attention(
            qg, k, v, attn_mask=mask, scale=scale), 10))
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    return entry


def _decode_entry(source, replaces, shapes):
    """A decode kernel's line: the MLA shape's numbers (the table's row),
    every shape under ``shapes``."""
    mla = shapes["MLA"]
    return dict(source=source, replaces=replaces,
                max_abs_err=max(c["max_abs_err"] for c in shapes.values()),
                atol_needed=max(c["atol_needed"] for c in shapes.values()),
                **{key: mla[key] for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "shape")},
                shapes=shapes)


def ptxas_report(log_path, needle: str):
    """Registers, stack and spills of each kernel in the ptxas report the
    build keeps beside the library (``-Xptxas -v``), for the entry
    functions whose (demangled) name contains ``needle``."""
    import re
    import shutil
    entries, name = [], None
    for line in Path(log_path).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries.append({"mangled": name})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entries[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    if shutil.which("c++filt") and entries:
        names = subprocess.run(["c++filt"], input="\n".join(
            e["mangled"] for e in entries), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for e, n in zip(entries, names):
            e["name"] = n
    out = []
    for e in entries:
        n = e.pop("name", e["mangled"])
        e.pop("mangled")
        if needle in n:
            out.append({"name": n, **e})
    return out


def check_kernels(torch, dev):
    """Phase 3: each kernel vs its plain version at main-path shapes.
    Returns {name: entry} without the launch counts."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    from repro_torch.kernels.delta import (delta_chunked_fused,
                                           delta_chunked_ref, mask_padded)
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref)
    from repro_torch.kernels.quantize import (quantize_int8_fused,
                                              quantize_int8_ref)

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def atol_needed(got, want, rtol=TOL_BF16[1]):
        """The least atol with which ``got`` passes at ``rtol``."""
        d = (got.float() - want.float()).abs() - rtol * want.float().abs()
        return max(0.0, float(d.max()))

    def close(name, got, want, atol, rtol):
        if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
            fail(f"{name} disagrees with its plain version: max abs error "
                 f"{err(got, want):.3e} (atol {atol}, rtol {rtol}; atol "
                 f"needed {atol_needed(got, want, rtol):.3e})")
        return err(got, want)

    out = {}

    # flash: MLA prefill in MHA form, Hq = Hkv = 64, Dk = 192, Dv = 128
    H, Dk, Dv = 64, 192, 128
    q, k, v = randn(1, H, 2048, Dk), randn(1, H, 2048, Dk), randn(1, H, 2048, Dv)
    scale = Dk ** -0.5
    o = flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    o_ref = flash_attention_ref(q, k, v, causal=True, scale=scale)
    e1 = close("flash_attention", o, o_ref, *TOL_BF16)
    # a chunk of 2048 queries over 4096 prior keys (q_offset path)
    qc = randn(1, H, 2048, Dk)
    kc, vc = randn(1, H, 6144, Dk), randn(1, H, 6144, Dv)
    oc = flash_attention(qc, kc, vc, causal=True, scale=scale, q_offset=4096)
    torch.cuda.synchronize()
    oc_ref = flash_attention_ref(qc, kc, vc, causal=True, scale=scale,
                                 q_offset=4096)
    e2 = close("flash_attention (q_offset)", oc, oc_ref, *TOL_BF16)
    checked = {"mla": e1, "mla_q_offset_4096": e2}
    needed = [atol_needed(o, o_ref), atol_needed(oc, oc_ref)]
    del qc, kc, vc, oc, oc_ref
    # mistral-nemo's dense GQA prefill chunks (Hq 32 over Hkv 8, D 128: the
    # core's 128-key tile), the first and one at q_offset 4096
    for off in (0, 4096):
        qg = randn(1, 32, 4096, 128)
        kg, vg = randn(1, 8, off + 4096, 128), randn(1, 8, off + 4096, 128)
        og = flash_attention(qg, kg, vg, causal=True, q_offset=off)
        torch.cuda.synchronize()
        og_ref = flash_attention_ref(qg, kg, vg, causal=True, q_offset=off)
        checked[f"gqa_q_offset_{off}"] = close(
            f"flash_attention (GQA, q_offset {off})", og, og_ref, *TOL_BF16)
        needed.append(atol_needed(og, og_ref))
        del qg, kg, vg, og, og_ref
    S = 2048
    pairs = S * (S + 1) // 2
    flops = 2 * H * pairs * (Dk + Dv)
    bnd = _bound(_nbytes(q, k, v, o), flops, BF16_FLOP_S)
    t = _ms(lambda: flash_attention(q, k, v, causal=True, scale=scale), 10)
    out["flash_attention"] = dict(
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:119",
        max_abs_err=max(checked.values()), atol_needed=max(needed),
        checked=checked, ms=t, tflops=flops / t / 1e9, bound_share=bnd[0] / t,
        plain_ms=_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                 scale=scale), 3),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), 10),
        shape="q (1,64,2048,192) k (1,64,2048,192) v (1,64,2048,128) bf16, "
              "causal; checked also at 2048 queries over 6144 keys, "
              "q_offset 4096, and at mistral-nemo's GQA chunk q "
              "(1,32,4096,128) over k, v (1,8,4096|8192,128), q_offset 0 "
              "and 4096")

    # decode (row 2) at the three group sizes the main paths run: absorbed
    # MLA (Hq 64 over Hkv 1, Dk 536, Dv 472: the table's row), GQA (32 over
    # 8 heads of 128) and zamba2's MHA (32 heads of 64), the last two read
    # in place through the model's (B, S, Hkv, D) buffers as gqa_decode
    # passes them
    B, S = 8, 16384
    lens = torch.tensor(CHECK_LENGTHS, dtype=torch.int32, device=dev)
    shapes = {}
    for tag, Hq, Hkv, Dk, Dv, scale in DECODE_GROUPS:
        qd = randn(B, Hq, Dk)
        if Hkv == 1:
            kd, vd = randn(B, 1, S, Dk), randn(B, 1, S, Dv)
        else:
            kd = randn(B, S, Hkv, Dk).transpose(1, 2)
            vd = randn(B, S, Hkv, Dv).transpose(1, 2)
        shapes[tag] = _decode_case(
            torch, close, atol_needed, f"decode_attention ({tag})",
            lambda: decode_attention(qd, kd, vd, lens, scale=scale),
            lambda: decode_attention_ref(qd, kd, vd, lens, scale=scale),
            qd, kd, vd, lens, scale, extra=())
        shapes[tag]["shape"] = (
            f"q ({B},{Hq},{Dk}) k ({B},{Hkv},{S},{Dk}) v ({B},{Hkv},{S},"
            f"{Dv}) bf16{'' if Hkv == 1 else ' (transposed (B,S,Hkv,D) buffers)'}"
            f", lengths 16384..101")
        del qd, kd, vd
    out["decode_attention"] = _decode_entry(
        "src/repro_torch/csrc/decode_attn.cu",
        "src/repro/kernels/decode_attn.py:94", shapes)

    # delta: KDA prefill, H = 56, dk = dv = 128, ragged lengths
    B, H, S, d = 2, 56, 4096, 128
    qn = F.normalize(randn(B, H, S, d, dtype=torch.float32), dim=-1).to(bf)
    kn = F.normalize(randn(B, H, S, d, dtype=torch.float32), dim=-1).to(bf)
    vn = randn(B, H, S, d)
    la = -0.1 * randn(B, H, S, dtype=torch.float32).abs()
    beta = torch.rand((B, H, S), generator=g, device=dev) * 0.9 + 0.1
    s0 = randn(B, H, d, d, dtype=torch.float32, scale=0.1)
    dl = torch.tensor([4096, 2500], dtype=torch.int32, device=dev)
    o, st = delta_chunked_fused(qn, kn, vn, la, beta, dl, s0)
    torch.cuda.synchronize()

    def plain_delta():
        la_m, k_m, b_m = mask_padded(dl, S, la, kn, beta)
        return delta_chunked_ref(qn, k_m, vn, la_m, b_m, s0)

    o2, st2 = plain_delta()
    valid = (torch.arange(S, device=dev)[None, :] < dl[:, None])[:, None]
    valid = valid.expand(B, H, S)
    e_o = close("delta_chunked_fused (o)", o[valid], o2[valid], *TOL_BF16)
    close("delta_chunked_fused (state)", st, st2, *TOL_STATE)
    rows = int(dl.sum()) * H
    chunks = sum(-(-int(n) // 64) for n in dl.tolist()) * H
    per_chunk = 4 * 64 * 64 * d + 6 * 64 * d * d + 2 * 64 * 64 * d
    bnd = _bound(rows * (4 * d * 2 + 2 * 4) + _nbytes(s0, st, dl),
                 chunks * per_chunk, BF16_FLOP_S)
    out["delta_chunked_fused"] = dict(
        source="src/repro_torch/csrc/delta.cu",
        replaces="src/repro/kernels/delta.py:218",
        max_abs_err=e_o, atol_needed=atol_needed(o[valid], o2[valid]),
        ms=_ms(lambda: delta_chunked_fused(qn, kn, vn, la, beta, dl, s0), 5),
        plain_ms=_ms(plain_delta, 2),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="q,k,v (2,56,4096,128) bf16, state (2,56,128,128) f32, "
              "lengths 4096, 2500")

    # quantize: one wire leaf (4096, 472) float32
    x = randn(4096, 472, dtype=torch.float32, scale=3.0)
    qq, sc = quantize_int8_fused(x)
    torch.cuda.synchronize()
    qr, sr = quantize_int8_ref(x)
    if not (torch.equal(qq, qr) and
            sc.view(torch.int32).item() == sr.view(torch.int32).item()):
        fail("quantize_int8_fused is not byte-identical to its plain version")
    bnd = _bound(x.numel() * 5 + 4, 3 * x.numel(), F32_FLOP_S)
    out["quantize_int8_fused"] = dict(
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:78",
        max_abs_err=err(qq, qr), atol_needed=0.0,
        ms=_ms(lambda: quantize_int8_fused(x), 50),
        plain_ms=_ms(lambda: quantize_int8_ref(x), 20),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="x (4096,472) f32 -> int8 + scale, byte-identical")

    out.update(check_gla_kernel(torch, dev, g, randn, close, atol_needed))
    out.update(check_paged_kernels(torch, dev, g, randn, close, atol_needed))
    out.update(check_unmasked_kernels(torch, dev, g, randn, close,
                                      atol_needed))
    return out


def check_gla_kernel(torch, dev, g, randn, close, atol_needed):
    """Phase 3, gated linear attention: the zamba2 Mamba2 prefill shape (H
    = 32, dk = 64, dv = 128), ragged lengths and a nonzero initial state,
    against its plain version."""
    from repro_torch.kernels.gla import (gla_chunked_fused, gla_chunked_ref,
                                         mask_padded)

    B, H, S, dk, dv = 2, 32, 4096, 64, 128
    q = randn(B, H, S, dk)
    k = randn(B, H, S, dk, scale=dk ** -0.5)
    v = randn(B, H, S, dv)
    la = -2.0 * torch.rand((B, H, S), generator=g, device=dev) ** 3
    s0 = randn(B, H, dk, dv, dtype=torch.float32, scale=0.5)
    lens = torch.tensor([4096, 2500], dtype=torch.int32, device=dev)
    o, st = gla_chunked_fused(q, k, v, la, lens, s0)
    torch.cuda.synchronize()

    def plain():
        la_m, k_m = mask_padded(lens, S, la, k)
        return gla_chunked_ref(q, k_m, v, la_m, s0)

    o2, st2 = plain()
    valid = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None]
    valid = valid.expand(B, H, S)
    e_o = close("gla_chunked_fused (o)", o[valid], o2[valid], *TOL_BF16)
    close("gla_chunked_fused (state)", st, st2, *TOL_STATE)
    rows = int(lens.sum()) * H
    chunks = sum(-(-int(n) // 64) for n in lens.tolist()) * H
    # causal pairs of q k^T and A v, then q S and the state update
    per_chunk = 64 * 65 // 2 * 2 * (dk + dv) + 2 * (2 * 64 * dk * dv)
    bnd = _bound(rows * ((2 * dk + 2 * dv) * 2 + 4) + _nbytes(s0, st, lens),
                 chunks * per_chunk, BF16_FLOP_S)
    return {"gla_chunked_fused": dict(
        source="src/repro_torch/csrc/gla.cu",
        replaces="src/repro/kernels/gla.py:185",
        max_abs_err=e_o, atol_needed=atol_needed(o[valid], o2[valid]),
        ms=_ms(lambda: gla_chunked_fused(q, k, v, la, lens, s0), 10),
        plain_ms=_ms(plain, 3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="q,k (2,32,4096,64) v (2,32,4096,128) bf16, log_a f32, state "
              "(2,32,64,128) f32 nonzero, lengths 4096, 2500")}


def check_unmasked_kernels(torch, dev, g, randn, close, atol_needed):
    """Phase 3, rows 5 and 6: the unmasked scans of training, each against
    its plain version with a nonzero initial state.  gla_chunked at
    zamba2's Mamba2 head (H = 32, dk = 64, dv = 128) and a 2048-token
    training row, delta_chunked at row 3's kimi KDA shape, so the masked
    and unmasked delta kernels compare directly."""
    import torch.nn.functional as F

    from repro_torch.kernels.delta import delta_chunked, delta_chunked_ref
    from repro_torch.kernels.gla import gla_chunked, gla_chunked_ref

    out = {}
    B, H, S, dk, dv = 2, 32, 2048, 64, 128
    q = randn(B, H, S, dk)
    k = randn(B, H, S, dk, scale=dk ** -0.5)
    v = randn(B, H, S, dv)
    la = -2.0 * torch.rand((B, H, S), generator=g, device=dev) ** 3
    s0 = randn(B, H, dk, dv, dtype=torch.float32, scale=0.5)
    o, st = gla_chunked(q, k, v, la, s0)
    torch.cuda.synchronize()
    o2, st2 = gla_chunked_ref(q, k, v, la, s0)
    e_o = close("gla_chunked (o)", o, o2, *TOL_BF16)
    close("gla_chunked (state)", st, st2, *TOL_STATE)
    chunks = B * H * (-(-S // 64))
    per_chunk = 64 * 65 // 2 * 2 * (dk + dv) + 2 * (2 * 64 * dk * dv)
    bnd = _bound(B * H * S * ((2 * dk + 2 * dv) * 2 + 4) + _nbytes(s0, st),
                 chunks * per_chunk, BF16_FLOP_S)
    out["gla_chunked"] = dict(
        source="src/repro_torch/csrc/gla.cu",
        replaces="src/repro/kernels/gla.py:126",
        max_abs_err=e_o, atol_needed=atol_needed(o, o2),
        ms=_ms(lambda: gla_chunked(q, k, v, la, s0), 10),
        plain_ms=_ms(lambda: gla_chunked_ref(q, k, v, la, s0), 3),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="q,k (2,32,2048,64) v (2,32,2048,128) bf16, log_a f32, state "
              "(2,32,64,128) f32 nonzero, no lengths")
    del q, k, v, la, s0, o, o2

    B, H, S, d = 2, 56, 4096, 128
    qn = F.normalize(randn(B, H, S, d, dtype=torch.float32), dim=-1).to(
        torch.bfloat16)
    kn = F.normalize(randn(B, H, S, d, dtype=torch.float32), dim=-1).to(
        torch.bfloat16)
    vn = randn(B, H, S, d)
    la = -0.1 * randn(B, H, S, dtype=torch.float32).abs()
    beta = torch.rand((B, H, S), generator=g, device=dev) * 0.9 + 0.1
    s0 = randn(B, H, d, d, dtype=torch.float32, scale=0.1)
    o, st = delta_chunked(qn, kn, vn, la, beta, s0)
    torch.cuda.synchronize()
    o2, st2 = delta_chunked_ref(qn, kn, vn, la, beta, s0)
    e_o = close("delta_chunked (o)", o, o2, *TOL_BF16)
    close("delta_chunked (state)", st, st2, *TOL_STATE)
    chunks = B * H * (S // 64)
    per_chunk = 4 * 64 * 64 * d + 6 * 64 * d * d + 2 * 64 * 64 * d
    bnd = _bound(B * H * S * (4 * d * 2 + 2 * 4) + _nbytes(s0, st),
                 chunks * per_chunk, BF16_FLOP_S)
    out["delta_chunked"] = dict(
        source="src/repro_torch/csrc/delta.cu",
        replaces="src/repro/kernels/delta.py:155",
        max_abs_err=e_o, atol_needed=atol_needed(o, o2),
        ms=_ms(lambda: delta_chunked(qn, kn, vn, la, beta, s0), 5),
        plain_ms=_ms(lambda: delta_chunked_ref(qn, kn, vn, la, beta, s0), 2),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="q,k,v (2,56,4096,128) bf16, state (2,56,128,128) f32, no "
              "lengths")
    return out


def check_grads(torch, dev):
    """Phase 3b: each differentiable op on CUDA at the shapes and types the
    training paths give it, against its plain version.  ``zamba2_train``
    runs flash in MHA form (1, 32, 2048, 64) and gla_chunked at (1, 32,
    2048, dk 64 / dv 128) in bf16, and ``zamba2_train_check`` both again in
    float32; ``hybrid_train`` runs flash in MLA form (4, 8, 1024, Dk 96 /
    Dv 64) and delta_chunked at (4, 8, 1024, 64) in float32 (a microbatch
    of four rows).  The masked instances get the same shapes with ragged
    lengths.

    * Forward: the kernel's outputs against the plain version's, within
      TOL_STATE in float32 and TOL_BF16 (the state TOL_STATE) in bf16,
      only the rows below the lengths where there are any.  This is what
      holds the kernels at these shapes.
    * Gradients, float32: the ``autograd.Function``'s against autograd
      through the plain version for a random upstream gradient, within
      TOL_GRAD of the largest |gradient|.  Both sides recompute the plain
      version from the same inputs in the backward, so this checks only
      the wiring: the inputs saved, the upstream passed on, each gradient
      returned to its input.

    Returns {case: {"fwd_max_abs_err": {dtype: x}, "fwd_atol_needed":
    {dtype: x}, "grad_rel_diff": x}}."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def unit(*shape):
        x = randn(*shape)
        return x / x.norm(dim=-1, keepdim=True)

    gla_args = (randn(1, 32, 2048, 64), randn(1, 32, 2048, 64, scale=0.125),
                randn(1, 32, 2048, 128),
                -2.0 * torch.rand((1, 32, 2048), generator=g,
                                  device=dev) ** 3,
                randn(1, 32, 64, 128, scale=0.5))
    delta_args = (unit(4, 8, 1024, 64), unit(4, 8, 1024, 64),
                  randn(4, 8, 1024, 64),
                  -0.1 * randn(4, 8, 1024).abs(),
                  torch.rand((4, 8, 1024), generator=g, device=dev) * 0.9
                  + 0.1, randn(4, 8, 64, 64, scale=0.1))

    def lens(*n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    # case: (op, float32 inputs, lengths, forward dtypes)
    cases = {
        "attention_mha": ("attention", (randn(1, 32, 2048, 64),
                                        randn(1, 32, 2048, 64),
                                        randn(1, 32, 2048, 64)), None,
                          ("f32", "bf16")),
        "attention_mla": ("attention", (randn(4, 8, 1024, 96),
                                        randn(4, 8, 1024, 96),
                                        randn(4, 8, 1024, 64)), None,
                          ("f32",)),
        "gla": ("gla", gla_args, None, ("f32", "bf16")),
        "gla_lengths": ("gla", tuple(torch.cat([a, a]) for a in gla_args),
                        lens(2048, 1400), ("f32",)),
        "delta": ("delta", delta_args, None, ("f32",)),
        "delta_lengths": ("delta", delta_args, lens(1024, 700, 1024, 333),
                          ("f32",)),
    }
    out = {}
    for name, (op, args, lengths, dtypes) in cases.items():
        kw = {} if lengths is None else {"lengths": lengths}
        entry = out[name] = {"fwd_max_abs_err": {}, "fwd_atol_needed": {}}
        for dtype in dtypes:
            # q, k, v take the model's dtype; decays, beta and the state
            # stay float32
            xs = tuple(a.to(torch.bfloat16) if dtype == "bf16" and i < 3
                       else a for i, a in enumerate(args))
            with torch.no_grad():
                got, want = (getattr(ops, op)(*xs, use_kernel=u, **kw)
                             for u in (True, False))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs, needs = [], []
            for i, (a, b) in enumerate(zip(got, want)):
                if i == 0 and lengths is not None:
                    valid = (torch.arange(a.shape[2], device=dev)[None, :]
                             < lengths[:, None])[:, None, :, None]
                    a, b = (x.masked_select(valid) for x in (a, b))
                atol, rtol = (TOL_BF16 if dtype == "bf16" and i == 0
                              else TOL_STATE)
                a, b = a.float(), b.float()
                err = float((a - b).abs().max())
                need = max(0.0, float(((a - b).abs() - rtol * b.abs()).max()))
                if not (torch.isfinite(a).all() and need <= atol):
                    fail(f"{name} ({dtype}) output {i} through its kernel "
                         f"disagrees with its plain version: max abs error "
                         f"{err:.3e} (atol {atol}, rtol {rtol}; atol needed "
                         f"{need:.3e})")
                errs.append(err)
                needs.append(need)
            entry["fwd_max_abs_err"][dtype] = max(errs)
            entry["fwd_atol_needed"][dtype] = max(needs)
        ups = []

        def grads(use_kernel):
            xs = [a.detach().clone().requires_grad_() for a in args]
            res = getattr(ops, op)(*xs, use_kernel=use_kernel, **kw)
            res = res if isinstance(res, tuple) else (res,)
            if not ups:
                ups.extend(randn(*r.shape) for r in res)
            return torch.autograd.grad(res, xs, ups)

        got, want = grads(True), grads(False)
        worst = 0.0
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            diff = float((a - b).abs().max())
            if not (torch.isfinite(a).all() and diff <= TOL_GRAD * scale):
                fail(f"gradient of {name} through its kernel differs from "
                     f"autograd through the plain version: {diff:.3e} "
                     f"against {scale:.3e}")
            worst = max(worst, diff / max(scale, 1e-30))
        entry["grad_rel_diff"] = worst
        del got, want
    return out


def _paged_tables(torch, dev, g, lens, T, N, P):
    """Distinct random pages per row for its live keys, the rest of each
    row on the sink page P - 1."""
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32)
    tables = torch.full((len(lens), N), P - 1, dtype=torch.int32, device=dev)
    at = 0
    for b, L in enumerate(lens):
        live = -(-L // T)
        tables[b, :live] = perm[at:at + live]
        at += live
    return tables


def check_paged_kernels(torch, dev, g, randn, close, atol_needed):
    """Phase 3, paged kernels: paged decode at the MLA and the GQA shapes,
    paged prefill at the GQA shape, each against its plain version, timed
    beside SDPA over the equivalent dense gathered cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode_attn import (
        gather_pages, paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.paged_prefill_attn import (
        paged_prefill_attention, paged_prefill_attention_ref)

    out = {}
    T, P = 16, 8193
    lens_l = list(CHECK_LENGTHS)
    B, N = len(lens_l), 16384 // T
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    shapes = {}
    for tag, Hq, Hkv, Dk, Dv, scale in DECODE_GROUPS:
        kp, vp = randn(Hkv, P, T, Dk), randn(Hkv, P, T, Dv)
        tables = _paged_tables(torch, dev, g, lens_l, T, N, P)
        q = randn(B, Hq, Dk)
        runs = [(tag, lens, lens_l)]
        if tag == "MHA":
            # zamba2's decode block: 8 slots at 4000 tokens
            l4 = [4000] * B
            runs.append(("MHA_zamba2_8x4000",
                         torch.tensor(l4, dtype=torch.int32, device=dev), l4))
        for name, ln, ll in runs:
            tb = tables if ll is lens_l else _paged_tables(
                torch, dev, g, ll, T, N, P)
            shapes[name] = _decode_case(
                torch, close, atol_needed, f"paged_decode_attention ({name})",
                lambda: paged_decode_attention(q, kp, vp, tb, ln,
                                               scale=scale),
                lambda: paged_decode_attention_ref(q, kp, vp, tb, ln,
                                                   scale=scale),
                q, kp, vp, ln, scale, extra=(tb,), tables=tb)
            shapes[name]["shape"] = (
                f"q ({B},{Hq},{Dk}), pools ({Hkv},{P},{T},{Dk}) / ({Hkv},{P},"
                f"{T},{Dv}) bf16, tables ({B},{N}) permuted, lengths "
                + ("16384..101" if ll is lens_l else f"{ll[0]} x {B}"))
        del kp, vp
    out["paged_decode_attention"] = _decode_entry(
        "src/repro_torch/csrc/paged_decode_attn.cu",
        "src/repro/kernels/paged_decode_attn.py:112", shapes)

    # paged prefill: a 2048-query suffix chunk over 512 prior pages
    Hq, Hkv, D, C, Np = 32, 8, 128, 2048, 512
    kp, vp = randn(Hkv, P, T, D), randn(Hkv, P, T, D)
    tables = _paged_tables(torch, dev, g, [Np * T], T, Np, P)
    q = randn(1, Hq, C, D)
    errs, needed = [], []
    for Ssuf in (2048, 4096):
        ks, vs = randn(1, Hkv, Ssuf, D), randn(1, Hkv, Ssuf, D)
        o = paged_prefill_attention(q, kp, vp, tables, ks, vs)
        torch.cuda.synchronize()
        o_ref = paged_prefill_attention_ref(q, kp, vp, tables, ks, vs)
        errs.append(close(f"paged_prefill_attention (Ssuf {Ssuf})", o,
                          o_ref, *TOL_BF16))
        needed.append(atol_needed(o, o_ref))
    checked = {f"gqa_suffix_{n}": e for n, e in zip((2048, 4096), errs)}
    # zamba2's prefix-hit suffix chunk: MHA (32 heads of 64, the core's
    # 128-key tile) over the 312 pages of its 4992-token prefix, one chunk
    # of 1024 (the 600-token turn's bucket)
    kz, vz = randn(32, 1024, T, 64), randn(32, 1024, T, 64)
    tz = _paged_tables(torch, dev, g, [312 * T], T, 312, 1024)
    qz, ksz, vsz = (randn(1, 32, 1024, 64) for _ in range(3))
    o = paged_prefill_attention(qz, kz, vz, tz, ksz, vsz)
    torch.cuda.synchronize()
    o_ref = paged_prefill_attention_ref(qz, kz, vz, tz, ksz, vsz)
    checked["mha_d64_zamba2"] = close(
        "paged_prefill_attention (zamba2 MHA, D 64)", o, o_ref, *TOL_BF16)
    errs.append(checked["mha_d64_zamba2"])
    needed.append(atol_needed(o, o_ref))
    del kz, vz, tz, qz, ksz, vsz, o, o_ref
    ks, vs = randn(1, Hkv, C, D), randn(1, Hkv, C, D)
    prior = Np * T
    pairs = C * prior + C * (C + 1) // 2
    bnd = _bound(_nbytes(q, q, tables, ks, vs) + prior * Hkv * 2 * D * 2,
                 2 * Hq * pairs * 2 * D, BF16_FLOP_S)
    kd = torch.cat([gather_pages(kp, tables), ks], 2).repeat_interleave(
        Hq // Hkv, dim=1)
    vd = torch.cat([gather_pages(vp, tables), vs], 2).repeat_interleave(
        Hq // Hkv, dim=1)
    mask = (torch.arange(prior + C, device=dev)[None, :]
            <= prior + torch.arange(C, device=dev)[:, None])
    t = _ms(lambda: paged_prefill_attention(q, kp, vp, tables, ks, vs), 5)
    out["paged_prefill_attention"] = dict(
        source="src/repro_torch/csrc/paged_prefill_attn.cu",
        replaces="src/repro/kernels/paged_prefill_attn.py:129",
        max_abs_err=max(errs), atol_needed=max(needed), checked=checked,
        ms=t, tflops=2 * Hq * pairs * 2 * D / t / 1e9,
        bound_share=bnd[0] / t,
        plain_ms=_ms(lambda: paged_prefill_attention_ref(
            q, kp, vp, tables, ks, vs), 2),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), 5),
        shape="q (1,32,2048,128) over 512 prior pages of 16 (pools "
              "(8,8193,16,128)) + suffix of 2048 keys, bf16, timed; checked "
              "also with a 4096-key suffix and at zamba2's q (1,32,1024,64) "
              "over 312 pages of 16 (pools (32,1024,16,64)) + 1024 suffix "
              "keys; SDPA on the gathered cache with K/V repeated to 32 "
              "heads and a boolean mask")
    return out


def main_path(torch, dev, cfg, params, *, paged: bool, session_len=5000):
    """Phase 4: the PrfaaS serving loop, every kernel launch counted from 0:
    prompts of 100-12000 tokens through both routes with int8 wire
    compression, then a 600-token later turn of the ``session_len``-token
    session.  Paged: each region's decode engine runs on pool pages it
    shares with its prefix cache, and the later turn resumes from the
    device pages of its prefix where the architecture allows (page-aligned
    state snapshots for linear mixers, so never on kimi's 5000-token
    prompt, and on zamba2's 4992-token one)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serving import (CrossDCDeployment, DeploymentConfig,
                                     Request)

    dep = CrossDCDeployment(Model(cfg), params, DeploymentConfig(
        threshold=2048, pd_clusters=1, wire_compression=True,
        decode_slots=8, capacity=16384, decode_block_size=8,
        min_prefill_bucket=128, max_prefill_bucket=4096, paged_kv=paged))
    rng = np.random.default_rng(0)
    lens = [100, 700, 1500, 2500, 3800, session_len, 9000, 12000, 300]
    prompts = [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
               for L in lens]
    # a later turn of the session: its prefix is cached
    ext = np.concatenate([prompts[5], rng.integers(0, cfg.vocab_size, (600,))
                          .astype(np.int32)])
    batches = [[Request(rid=i, tokens=t, max_new_tokens=16)
                for i, t in enumerate(prompts)],
               [Request(rid=len(prompts), tokens=ext, max_new_tokens=16)]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = {}
    prefilled = []
    for batch in batches:
        before = dep.pd_prefill.tokens_prefilled
        out.update(dep.submit_batch(batch))
        prefilled.append(dep.pd_prefill.tokens_prefilled - before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    reqs = [r for b in batches for r in b]
    for r in reqs:
        resp = out.get(r.rid)
        if resp is None or len(resp.output_tokens) != 1 + r.max_new_tokens:
            fail(f"request {r.rid} not answered with its tokens")
    routes = {}
    for r in reqs:
        routes[r.route] = routes.get(r.route, 0) + 1
    if set(routes) != {"pd", "prfaas"}:
        fail(f"both routes must be taken, got {routes}")
    if not any(r.cached_tokens > 0 for r in reqs):
        fail("the session extension found no cached prefix")
    wire_raw = sum(r.kv_bytes_raw for r in reqs if r.route == "prfaas")
    wire_q = sum(r.kv_bytes for r in reqs if r.route == "prfaas")
    ratio = dep.measured_compression()
    if not (wire_q > 0 and ratio > 1.0):
        fail(f"wire bytes {wire_q}, compression {ratio}")
    for r in reqs:
        toks = np.asarray(out[r.rid].output_tokens)
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {r.rid} emitted out-of-vocabulary tokens")
    m = dep.metrics()
    summary = {
        "arch": cfg.name, "layers": cfg.n_layers, "paged_kv": paged,
        "requests": len(reqs), "routes": routes,
        "prompt_tokens": [len(r.tokens) for r in reqs],
        "cached_tokens": [r.cached_tokens for r in reqs],
        "chunked": sum(1 for r in reqs if len(r.tokens) > 4096),
        "tokens_out": sum(len(out[r.rid].output_tokens) for r in reqs),
        "pd_tokens_prefilled": prefilled,
        "wire_raw_bytes": wire_raw, "wire_quantized_bytes": wire_q,
        "wire_compression": ratio,
        "truncations": m["truncations"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wall_s": wall,
        # host seconds inside the schedulers' ticks, and of those inside
        # decode blocks (the rest is prefill, admission and accounting)
        "scheduler_wall_s": sum(s.wall_s for s in dep.schedulers.values()),
        "decode_wall_s": sum(d.decode_wall_s for d in dep.decoders.values()),
        "launches": launches,
    }
    if paged:
        ext_req = batches[1][0]
        pin = ext_req.device_pin
        summary["device_pin_cached_len"] = 0 if pin is None else pin.cached_len
        for name, region in m["clusters"].items():
            pool = region["pool"]
            if pool["allocated"] != (pool["freed"] + pool["evicted"]
                                     + pool["resident"]):
                fail(f"region {name}: pool pages not conserved: {pool}")
            dep.decoders[name].pool.check_invariants()
            summary[f"pool_{name}"] = pool
            summary[f"resident_kv_bytes_{name}"] = region["resident_kv_bytes"]
        summary["page_bytes"] = dep.decoders[dep.pd_names[0]].page_bytes
    return summary, launches, dep


def require_launched(launches, names, what):
    for name in names:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {what} path")


def _logit_check(torch, what, got, want, gate=True):
    """Kernels vs plain versions: finite, and (``gate``) the largest
    difference within TOL_LOGITS of the largest |logit|."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"non-finite logits ({what})")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    if gate and diff > TOL_LOGITS * scale:
        fail(f"{what} logits differ by {diff:.4f} > {TOL_LOGITS} x max "
             f"|logit| {scale:.4f}")
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return {"logits_max_abs_diff": diff, "logits_max_abs": scale,
            "argmax_agreement": same}


def compare_logits(torch, dev, cfg, params, gate=True, keep=None):
    """Phase 5: one bucketed prefill batch through the kernels and through
    the plain versions (both kept in ``keep``, as float32, when given)."""
    from repro_torch.models import Model

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                         device=dev)
    lens = torch.tensor([1024, 700], dtype=torch.int32, device=dev)
    with torch.no_grad():
        got, _ = Model(cfg).prefill(params, {"tokens": toks, "lengths": lens})
        want, _ = Model(cfg, use_kernels=False).prefill(
            params, {"tokens": toks, "lengths": lens})
    if keep is not None:
        keep.update(kernels=got.float(), plain=want.float())
    return _logit_check(torch, f"{cfg.name} first-token", got, want, gate)


def bf16_logit_witness(torch, bf16, f32_plain):
    """The bf16 prefill logits through the kernels and through the plain
    versions, each against the float32 plain logits of the same weights
    (relative L2 distance and largest difference over the largest
    |logit|); gated: the kernels' distance within TOL_BF16_LOGIT_RATIO of
    the plain versions', which is what bf16 rounding alone does."""
    out = {}
    for path in ("kernels", "plain"):
        d = bf16[path] - f32_plain
        out[f"{path}_bf16_rel_l2_from_f32"] = float(d.norm() / f32_plain.norm())
        out[f"{path}_bf16_max_abs_frac_from_f32"] = float(
            d.abs().max() / f32_plain.abs().max())
    out["ratio"] = (out["kernels_bf16_rel_l2_from_f32"]
                    / out["plain_bf16_rel_l2_from_f32"])
    if not out["ratio"] <= TOL_BF16_LOGIT_RATIO:
        fail(f"bf16 prefill logits through the kernels are further from the "
             f"float32 ones than the plain versions' by more than "
             f"{TOL_BF16_LOGIT_RATIO}x: {out}")
    return out


def _paged_engine(torch, cfg, params, lens, capacity, seed):
    """A paged decode engine of len(lens) slots holding prefilled prompts
    of ``lens`` tokens (random tokens from ``seed``)."""
    import numpy as np

    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine, PrefillEngine, Request
    from repro_torch.serving.engine import trim_request_cache

    model = Model(cfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (len(lens), max(lens))
                        ).astype(np.int32)
    first, caches, _ = PrefillEngine(model, params, min_bucket=128).prefill(
        toks, np.asarray(lens, np.int32))
    dec = DecodeEngine(model, params, len(lens), capacity, paged=True,
                       page_tokens=16)
    dec.admit_many([(Request(rid=i, tokens=toks[i, :L], max_new_tokens=64),
                     int(first[i]), trim_request_cache(caches, i, L), L)
                    for i, L in enumerate(lens)])
    del caches
    return dec, first


def compare_paged_step(torch, dev, cfg, params, gate=True):
    """Phase 5: one paged decode step of two admitted prompts through the
    kernels and, on a copy of the pools, through the plain versions."""
    from repro_torch.models import Model
    from repro_torch.models.tree import tree_map

    lens = [1000, 700]                 # the next position has its page
    dec, first = _paged_engine(torch, cfg, params, lens, 4096, seed=2)
    kw = dict(tables={"seq": torch.as_tensor(dec.table_seq, device=dev)},
              page_tokens=16, capacity=4096)
    tok = torch.as_tensor(first, device=dev).long()
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    plain = tree_map(lambda x: x.clone(), dec.caches)
    with torch.no_grad():
        got, _ = Model(cfg).decode_step(params, tok, dec.caches, ln, **kw)
        want, _ = Model(cfg, use_kernels=False).decode_step(
            params, tok, plain, ln, **kw)
    return _logit_check(torch, f"{cfg.name} paged decode step", got, want,
                        gate)


def to_float32(cfg, params):
    """The same weights in float32, converted leaf by leaf in place (each
    bf16 leaf is freed as its copy is made), and the config to match."""
    def walk(node):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in list(items):
            if isinstance(v, (dict, list)):
                walk(v)
            else:
                node[k] = v.float()
    walk(params)
    return dataclasses.replace(cfg, dtype="float32"), params


def mla_concat_cost(torch, dev, cfg, params):
    """The absorbed MLA paged decode concatenates [ckv, kpe] over the whole
    latent pool every step and MLA layer: its time against a decode step
    of 8 slots at 4000 tokens each over a 4096-page pool."""
    import numpy as np

    from repro_torch.core.blockpool import BlockPool
    from repro_torch.models import Model
    from repro_torch.models.paged import zero_request_payload
    from repro_torch.serving import DecodeEngine, Request

    L, slots = 4000, 8
    dec = DecodeEngine(Model(cfg), params, slots, 16384, paged=True,
                       pool=BlockPool(4096, 16), page_tokens=16)
    payload = zero_request_payload(cfg, L, dev)
    dec.admit_many([(Request(rid=i, tokens=np.zeros((L,), np.int32),
                             max_new_tokens=64), 0, payload, L)
                    for i in range(slots)])
    dec.step_block()                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.step_block()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / dec.block_size
    mla = [(gi, f"b{bi}") for gi, g in enumerate(cfg.groups)
           for bi, b in enumerate(g.blocks) if b.mixer.kind == "mla"]
    gi, key = mla[0]
    pool = dec.caches["groups"][gi][key]
    ckv, kpe = pool["ckv"][0], pool["kpe"][0]
    cat_ms = _ms(lambda: torch.cat([ckv, kpe], dim=-1), 20)
    n_mla = sum(cfg.groups[g].repeats for g, _ in mla)
    return {"mla_pool_shape": list(ckv.shape[:-1]) + [ckv.shape[-1]
                                                      + kpe.shape[-1]],
            "mla_concat_ms": cat_ms, "mla_layers": n_mla,
            "paged_decode_step_ms": step_ms,
            "mla_concat_share": cat_ms * n_mla / step_ms}


def _profiled(torch, fn):
    """Host wall of one ``fn()`` after a warm-up, then one more under
    ``torch.profiler``: the device's busy time (the sum of its kernels),
    its share of the wall, the five kernels that take most of it, and the
    shares of the busy time in the flash kernels (both cores of rows 1 and
    9) and in the decode kernels (both cores of rows 2 and 8, the bf16
    core's combine included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device time")
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:5]
    flash = [(ms, c) for n, ms, c in kernels
             if "flash_wgmma" in n or "flash_core" in n]
    decode = [(ms, c) for n, ms, c in kernels
              if "decode_hopper" in n or "decode_core" in n]
    return {"wall_ms": wall_ms, "device_busy_ms_profiled": busy,
            "device_busy_share": busy / wall_ms,
            "flash_ms": sum(ms for ms, _ in flash),
            "flash_launches": sum(c for _, c in flash),
            "flash_share_of_busy": sum(ms for ms, _ in flash) / busy,
            "decode_ms": sum(ms for ms, _ in decode),
            "decode_launches": sum(c for _, c in decode),
            "decode_share_of_busy": sum(ms for ms, _ in decode) / busy,
            "top_kernels": [{"name": n[:80], "ms": ms, "launches": c}
                            for n, ms, c in top]}


def profile_decode_block(torch, dev, cfg, params):
    """Where a paged decode block's time goes: one block of 8 slots at 4000
    tokens each (``_profiled``)."""
    import numpy as np

    from repro_torch.core.blockpool import BlockPool
    from repro_torch.models import Model
    from repro_torch.models.paged import zero_request_payload
    from repro_torch.serving import DecodeEngine, Request

    L, slots = 4000, 8
    dec = DecodeEngine(Model(cfg), params, slots, 16384, paged=True,
                       pool=BlockPool(4096, 16), page_tokens=16)
    payload = zero_request_payload(cfg, L, dev)
    dec.admit_many([(Request(rid=i, tokens=np.zeros((L,), np.int32),
                             max_new_tokens=64), 0, payload, L)
                    for i in range(slots)])
    return {"slots": slots, "tokens_per_slot": L, "steps": dec.block_size,
            **_profiled(torch, dec.step_block)}


def profile_prefill(torch, dev, cfg, params):
    """Where a prefill's time goes: one 4096-token prompt through
    ``PrefillEngine`` (``_profiled``)."""
    import numpy as np

    from repro_torch.models import Model
    from repro_torch.serving import PrefillEngine

    L = 4096
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, L))
    peng = PrefillEngine(Model(cfg), params, min_bucket=128)
    return {"tokens": L, **_profiled(torch, lambda: peng.prefill(
        toks.astype(np.int32), np.array([L], np.int32)))}


def kimi_config():
    """kimi-linear-1t at its published widths, one [KDA, KDA, KDA, MLA]
    unit deep, 32 of its 352 experts per MoE FFN, bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("kimi-linear-1t")
    groups = tuple(dataclasses.replace(g, repeats=1, blocks=tuple(
        dataclasses.replace(b, ffn=dataclasses.replace(b.ffn, num_experts=32))
        for b in g.blocks)) for g in cfg.groups)
    return dataclasses.replace(cfg, groups=groups)


def load_params(torch, dev, cfg, seed):
    from repro_torch.params import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    print(f"params {cfg.name}: {cfg.param_count() / 1e9:.2f} B "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def zamba2_paths(torch, dev, paths, launches):
    """zamba2-1.2b at full width and depth (38 layers: 32 Mamba2, the
    shared attention + FFN block invoked 6 times), dense and then paged,
    with a 4992-token (page-aligned) session: on the paged path its later
    turn resumes from the device pages and the Mamba2 state snapshot and
    prefills only its 600-token suffix.  Then the logit checks: bf16
    recorded, the 2 % gate held in float32."""
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-1.2b")
    params = load_params(torch, dev, cfg, 2)
    for tag, paged, need in (
            ("zamba2_dense", False, ("flash_attention", "decode_attention",
                                     "gla_chunked_fused",
                                     "quantize_int8_fused")),
            ("zamba2_paged", True, ("flash_attention",
                                    "paged_decode_attention",
                                    "paged_prefill_attention",
                                    "gla_chunked_fused",
                                    "quantize_int8_fused"))):
        summary, counts, dep = main_path(torch, dev, cfg, params,
                                         paged=paged, session_len=4992)
        del dep
        require_launched(counts, need, tag)
        if paged:
            pin = summary["device_pin_cached_len"]
            if pin != 4992:
                fail(f"the later turn on zamba2 pinned {pin} cached tokens, "
                     "not its 4992-token page-aligned prefix")
            if summary["pd_tokens_prefilled"][-1] != 600:
                fail(f"the later turn on zamba2 prefilled "
                     f"{summary['pd_tokens_prefilled'][-1]} tokens, not its "
                     "600-token suffix")
        paths[tag] = summary
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"{tag}: {summary['wall_s']:.2f} s wall, launches {counts}",
              flush=True)
    paths["zamba2_decode_profile"] = profile_decode_block(torch, dev, cfg,
                                                          params)
    paths["zamba2_prefill_profile"] = profile_prefill(torch, dev, cfg,
                                                      params)
    torch.cuda.empty_cache()
    bf16 = {}
    paths["zamba2_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                 gate=False, keep=bf16)
    paths["zamba2_paged_step_bf16"] = compare_paged_step(torch, dev, cfg,
                                                         params, gate=False)
    cfg, params = to_float32(cfg, params)
    torch.cuda.empty_cache()
    f32 = {}
    paths["zamba2_logits_f32"] = compare_logits(torch, dev, cfg, params,
                                                keep=f32)
    paths["zamba2_logits_bf16_witness"] = bf16_logit_witness(
        torch, bf16, f32["plain"])
    paths["zamba2_paged_step_f32"] = compare_paged_step(torch, dev, cfg,
                                                        params)


def _grad_gap(torch, got, want):
    """Two gradient trees: (relative gap of their global norms,
    ||got - want|| / ||want||, the leaf with the largest share of
    ||got - want||^2 and that share)."""
    from repro_torch.models.tree import tree_flatten_with_path
    dev = tree_flatten_with_path(want)[0][1].device
    na = nb = torch.zeros((), device=dev)
    per = {}
    for (path, a), (_, b) in zip(tree_flatten_with_path(got),
                                 tree_flatten_with_path(want)):
        a, b = a.float(), b.float()
        na, nb = na + (a * a).sum(), nb + (b * b).sum()
        per[path] = float(((a - b) ** 2).sum())
    na, nb = float(na) ** 0.5, float(nb) ** 0.5
    nd2 = sum(per.values())
    worst = max(per, key=per.get)
    return (abs(na - nb) / nb, nd2 ** 0.5 / nb, worst,
            per[worst] / max(nd2, 1e-30))


def zamba2_train(torch, dev):
    """Phase 6: the training path on zamba2-1.2b at full width and depth
    (38 layers, 1.34 B params, random bf16 weights from a seed): batch 2 x
    2048 tokens from ``SyntheticLM``, two microbatches, remat, AdamW (lr
    3e-4, warmup 2), four steps through ``make_train_step`` with every
    kernel launch counted from 0, then one more under ``torch.profiler``.
    Then the kernels-vs-plain check on one 2048-token row: loss and
    gradients in float32 (gated: the loss within TOL_TRAIN_LOSS, the
    global gradient norm within TOL_TRAIN_GRAD) and in bf16 (recorded),
    and the two bf16 gradients' distance from the float32 plain one
    (gated: the kernels' within TOL_BF16_GRAD_RATIO of the plain
    versions')."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.params import requires_grad
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                      TrainConfig, init_opt_state,
                                      loss_and_grads, make_train_step)

    cfg = get_config("zamba2-1.2b")
    params = requires_grad(load_params(torch, dev, cfg, 3))
    tc = TrainConfig(microbatches=2, adamw=AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=4))
    model = Model(cfg, use_kernels=True, remat=True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                                  global_batch=2))
    state = init_opt_state(params, tc)
    step_fn = make_train_step(model, tc)
    probe = params["groups"][0]["stacked"]["b0"]["mixer"]["wq"]["w"]
    before = probe[0, :4, :4].detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    hist = []
    for step in range(4):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, data.batch(step))
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]),
                     "time_s": time.perf_counter() - t0})
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    require_launched(launches, ("gla_chunked", "flash_attention"),
                     "zamba2_train")
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"zamba2 training: non-finite loss or grad norm {hist}")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"zamba2 training: step-0 loss {hist[0]['loss']:.3f} is not "
             f"near ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.3f}")
    if torch.equal(before, probe[0, :4, :4].detach()):
        fail("zamba2 training: the params did not move")
    profile = _profiled_once(torch, lambda: step_fn(params, state,
                                                    data.batch(4)))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "batch": [2, 2048],
           "microbatches": 2, "steps": hist,
           "mean_step_s_after_first": sum(h["time_s"] for h in hist[1:]) / 3,
           "peak_memory_gb": peak, "launches": launches,
           "step_profile": profile}
    del state, step_fn
    gc_cuda(torch)

    # kernels vs plain versions on one row: float32 gated; bf16 recorded,
    # and each bf16 gradient held against the float32 plain one
    batch = {"tokens": data.batch(10)["tokens"][:1]}
    losses, grads = {}, {}
    for dtype in ("bf16", "f32"):
        if dtype == "f32":
            with torch.no_grad():
                requires_grad(params, False)
                cfg, params = to_float32(cfg, params)
            requires_grad(params)
            gc_cuda(torch)
        for path, use in (("kernels", True), ("plain", False)):
            loss, _, grads[dtype, path] = loss_and_grads(
                Model(cfg, use_kernels=use, remat=True), params, batch)
            losses[dtype, path] = float(loss)
            if not math.isfinite(losses[dtype, path]):
                fail(f"zamba2 train check ({dtype}, {path}): non-finite "
                     f"loss")
    del params
    gc_cuda(torch)
    check = {}
    for dtype in ("bf16", "f32"):
        lk, lp = losses[dtype, "kernels"], losses[dtype, "plain"]
        norm_gap, diff, worst, share = _grad_gap(
            torch, grads[dtype, "kernels"], grads[dtype, "plain"])
        check[dtype] = {"loss_kernels": lk, "loss_plain": lp,
                        "loss_rel_diff": abs(lk - lp) / abs(lp),
                        "grad_norm_rel_diff": norm_gap,
                        "grad_rel_l2_diff": diff,
                        "largest_diff_leaf": worst,
                        "largest_diff_leaf_share": share}
    # the bf16 gradients' distance from the float32 plain gradient of the
    # same weights: through the kernels, and through the plain versions
    # (the same model with its own summation order) as the witness of what
    # bf16 rounding alone does
    wit = {path: _grad_gap(torch, grads["bf16", path], grads["f32", "plain"])
           for path in ("kernels", "plain")}
    del grads
    gc_cuda(torch)
    check["bf16_vs_f32_plain"] = {
        f"{path}_grad_rel_l2_diff": w[1] for path, w in wit.items()}
    check["bf16_vs_f32_plain"].update(
        {f"{path}_grad_norm_rel_diff": w[0] for path, w in wit.items()},
        ratio=wit["kernels"][1] / wit["plain"][1])
    f32 = check["f32"]
    if not (f32["loss_rel_diff"] <= TOL_TRAIN_LOSS
            and f32["grad_norm_rel_diff"] <= TOL_TRAIN_GRAD):
        fail(f"zamba2 train check in float32: kernels vs plain {check}")
    if not check["bf16_vs_f32_plain"]["ratio"] <= TOL_BF16_GRAD_RATIO:
        fail(f"zamba2 train check in bf16: the gradients through the "
             f"kernels are further from the float32 ones than the plain "
             f"versions' by more than {TOL_BF16_GRAD_RATIO}x: {check}")
    return out, check


def hybrid_train(torch, dev):
    """Phase 7: the reference's KDA:MLA 3:1 recipe at its 100m scale
    (53.7 M params, 12 layers, float32) through the port's copy of
    ``examples/train_100m.py``: ``TrainLoop`` with checkpoints in a
    temporary directory, 30 steps of batch 8 x 1024 tokens in two
    microbatches, every kernel launch counted from 0."""
    import math
    import tempfile

    from repro_torch.examples.train_100m import run
    from repro_torch.kernels import build

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        cfg, hist, stragglers = run("100m", steps=30, batch=8, seq=1024,
                                    device=dev, ckpt_dir=ckpt)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    require_launched(launches, ("delta_chunked", "flash_attention"),
                     "hybrid_train")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        fail(f"hybrid training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"hybrid training: the loss did not fall ({losses[0]:.4f} -> "
             f"{losses[-1]:.4f})")
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_count(), "batch": [8, 1024],
            "microbatches": 2, "steps": len(hist), "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "mean_step_s_after_first": sum(h["time_s"] for h in hist[1:])
            / (len(hist) - 1),
            "straggler_flags": len(stragglers), "wall_s": wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


# what some kernel entries add to the keys every entry has: achieved rate,
# share of the bound and the error at each checked shape (rows 1 and 9),
# the GQA shape's numbers (row 8)
_EXTRA_KEYS = ("tflops", "bound_share", "checked", "shapes")


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _profiled_once(torch, fn):
    """One ``fn()`` under ``torch.profiler``: its host wall, the device's
    busy time, and the ten kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device time")
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "top_kernels": [{"name": n[:80], "ms": ms, "launches": c}
                            for n, ms, c in top]}


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    # registers and spills of the bf16 decode core's instances
    decode_ptxas = ptxas_report(str(lib) + ".log", "decode_hopper::")
    for e in decode_ptxas:
        print(f"ptxas {e['name'].split('>(')[0]}>: {e.get('registers')} "
              f"registers, {e.get('spill_stores')} / {e.get('spill_loads')} "
              f"bytes spilled (stores / loads)", flush=True)

    kernels = check_kernels(torch, dev)
    for name, k in kernels.items():
        rate = (f", {k['tflops']:.1f} TFLOP/s, {k['bound_share']:.3f} of "
                f"the bound" if "tflops" in k else "")
        print(f"check {name}: max_abs_err {k['max_abs_err']:.3e} (atol "
              f"needed at rtol {TOL_BF16[1]}: {k['atol_needed']:.3e}), "
              f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']}{rate})", flush=True)
    grad_checks = check_grads(torch, dev)
    print(f"training-shape op checks (forward error; gradient difference "
          f"/ largest gradient): {grad_checks}", flush=True)
    torch.cuda.empty_cache()

    # kimi-linear-1t slice: the dense path, then the paged one
    cfg = kimi_config()
    params = load_params(torch, dev, cfg, 0)
    paths, launches = {}, {}
    for tag, paged, need in (
            ("kimi_dense", False, ("flash_attention", "decode_attention",
                                   "delta_chunked_fused",
                                   "quantize_int8_fused")),
            ("kimi_paged", True, ("flash_attention", "paged_decode_attention",
                                  "delta_chunked_fused",
                                  "quantize_int8_fused"))):
        summary, counts, dep = main_path(torch, dev, cfg, params, paged=paged)
        del dep
        require_launched(counts, need, tag)
        paths[tag] = summary
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"{tag}: {summary['wall_s']:.2f} s wall, launches {counts}",
              flush=True)
    paths["kimi_logits"] = compare_logits(torch, dev, cfg, params)
    paths["kimi_mla_concat"] = mla_concat_cost(torch, dev, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # mistral-nemo-12b at full width and depth, paged, with a prefix hit
    cfg = get_config("mistral-nemo-12b")
    params = load_params(torch, dev, cfg, 1)
    summary, counts, dep = main_path(torch, dev, cfg, params, paged=True)
    del dep
    require_launched(counts, ("flash_attention", "paged_decode_attention",
                              "paged_prefill_attention",
                              "quantize_int8_fused"), "mistral_paged")
    ext = summary["prompt_tokens"][-1]
    c = summary["device_pin_cached_len"]
    if not c > 0:
        fail("the later turn on mistral-nemo-12b found no device prefix")
    if summary["pd_tokens_prefilled"][-1] != ext - c:
        fail(f"the later turn prefilled {summary['pd_tokens_prefilled'][-1]} "
             f"tokens, not its {ext - c}-token suffix")
    paths["mistral_paged"] = summary
    paths["mistral_decode_profile"] = profile_decode_block(torch, dev, cfg,
                                                           params)
    paths["mistral_prefill_profile"] = profile_prefill(torch, dev, cfg,
                                                       params)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    print(f"mistral_paged: {summary['wall_s']:.2f} s wall, launches {counts}",
          flush=True)
    torch.cuda.empty_cache()
    # in bf16, 40 layers turn the kernels' and plain versions' different
    # float32 summation orders into flips of bf16 roundings that compound
    # layer over layer (2.1 % of the largest |logit| for the decode step on
    # an H100): recorded, and the 2 % gate is held in float32, where the
    # two differ by their summation order alone
    paths["mistral_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                  gate=False)
    paths["mistral_paged_step_bf16"] = compare_paged_step(
        torch, dev, cfg, params, gate=False)
    cfg, params = to_float32(cfg, params)
    torch.cuda.empty_cache()
    paths["mistral_logits_f32"] = compare_logits(torch, dev, cfg, params)
    paths["mistral_paged_step_f32"] = compare_paged_step(torch, dev, cfg,
                                                         params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    zamba2_paths(torch, dev, paths, launches)
    gc_cuda(torch)

    # the training path: zamba2-1.2b (row 6), then the KDA:MLA recipe
    # (row 5)
    summary, check = zamba2_train(torch, dev)
    paths["zamba2_train"], paths["zamba2_train_check"] = summary, check
    for name, n in summary["launches"].items():
        launches[name] = launches.get(name, 0) + n
    print(f"zamba2_train: {[round(h['loss'], 4) for h in summary['steps']]}"
          f", {summary['mean_step_s_after_first']:.2f} s a step, peak "
          f"{summary['peak_memory_gb']:.1f} GB, launches "
          f"{summary['launches']}; check {check}", flush=True)
    summary = hybrid_train(torch, dev)
    paths["hybrid_train"] = summary
    for name, n in summary["launches"].items():
        launches[name] = launches.get(name, 0) + n
    print(f"hybrid_train: loss {summary['losses'][0]:.4f} -> "
          f"{summary['losses'][-1]:.4f}, "
          f"{summary['mean_step_s_after_first']:.3f} s a step, launches "
          f"{summary['launches']}", flush=True)
    paths["gradient_checks"] = grad_checks
    paths["decode_ptxas"] = decode_ptxas

    entries = [dict(name=name, route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=launches.get(name, 0),
                    max_abs_err=k["max_abs_err"], ms=k["ms"],
                    plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                    bound_by=k["bound_by"], library_ms=k["library_ms"],
                    atol_needed=k["atol_needed"], shape=k["shape"],
                    **{key: k[key] for key in _EXTRA_KEYS if key in k})
               for name, k in kernels.items()]
    missing = [e["name"] for e in entries if e["launches"] <= 0]
    if missing:
        fail(f"kernels never launched on a main path: {missing}")
    print(json.dumps({"main_path": paths}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
