#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout (it imports ``src/repro_torch``, never JAX or
the reference package ``src/repro``).  Phases, each fatal on failure:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one process
     per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's full-width shapes, and time kernel, plain version and (for
     the attention kernels) PyTorch's SDPA as a yardstick;
  4. drive the main path: a ``CrossDCDeployment`` of full-width
     ``kimi-linear-1t`` (widths as published; depth cut to one
     [KDA, KDA, KDA, MLA] unit and the MoE to 32 of its 352 experts so the
     bf16 weights, ~17.8 GB, fit the card; random weights from a seed)
     serving prompts of 100-12000 tokens through both routes, with int8
     wire compression, chunked prefill and a prefix-cache hit, every kernel
     launch counted;
  5. compare one prefill batch's first-token logits through the kernels with
     those through the plain versions.

The last lines are a main-path summary, the ``nvidia-smi`` line, one
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
    S = 2048
    pairs = S * (S + 1) // 2
    bnd = _bound(_nbytes(q, k, v, o), 2 * H * pairs * (Dk + Dv), BF16_FLOP_S)
    out["flash_attention"] = dict(
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:119",
        max_abs_err=max(e1, e2),
        atol_needed=max(atol_needed(o, o_ref), atol_needed(oc, oc_ref)),
        ms=_ms(lambda: flash_attention(q, k, v, causal=True, scale=scale), 10),
        plain_ms=_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                 scale=scale), 3),
        bound_ms=bnd[0], bound_by=bnd[1],
        library_ms=_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), 10),
        shape="q (1,64,2048,192) k (1,64,2048,192) v (1,64,2048,128) bf16, "
              "causal; checked also at 2048 queries over 6144 keys, "
              "q_offset 4096")

    # decode: absorbed MLA, Hq = 64 over Hkv = 1, Dk = 536, Dv = 472
    B, S, Dk, Dv = 8, 16384, 536, 472
    qd = randn(B, 64, Dk)
    kd, vd = randn(B, 1, S, Dk), randn(B, 1, S, Dv)
    lens = torch.tensor([16384, 12001, 9000, 5601, 3800, 1501, 701, 101],
                        dtype=torch.int32, device=dev)
    scale = 192 ** -0.5
    od = decode_attention(qd, kd, vd, lens, scale=scale)
    torch.cuda.synchronize()
    od_ref = decode_attention_ref(qd, kd, vd, lens, scale=scale)
    e = close("decode_attention", od, od_ref, *TOL_BF16)
    keys = int(lens.sum())
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None]
    bnd = _bound(_nbytes(qd, od, lens) + keys * (Dk + Dv) * 2,
                 2 * 64 * keys * (Dk + Dv), BF16_FLOP_S)
    out["decode_attention"] = dict(
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:94",
        max_abs_err=e, atol_needed=atol_needed(od, od_ref),
        ms=_ms(lambda: decode_attention(qd, kd, vd, lens, scale=scale), 20),
        plain_ms=_ms(lambda: decode_attention_ref(qd, kd, vd, lens,
                                                  scale=scale), 3),
        bound_ms=bnd[0], bound_by=bnd[1],
        # one cache head: the 64 query heads are 64 query rows of it
        library_ms=_ms(lambda: F.scaled_dot_product_attention(
            qd[:, None], kd, vd, attn_mask=mask, scale=scale), 10),
        shape="q (8,64,536) k (8,1,16384,536) v (8,1,16384,472) bf16, "
              "lengths 16384..101")

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
    return out


def full_width_config():
    """kimi-linear-1t at its published widths, one [KDA, KDA, KDA, MLA]
    unit deep, 32 of its 352 experts per MoE FFN, bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("kimi-linear-1t")
    groups = tuple(dataclasses.replace(g, repeats=1, blocks=tuple(
        dataclasses.replace(b, ffn=dataclasses.replace(b.ffn, num_experts=32))
        for b in g.blocks)) for g in cfg.groups)
    return dataclasses.replace(cfg, groups=groups)


def main_path(torch, dev, cfg, params):
    """Phase 4: the PrfaaS serving loop, every kernel launch counted."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serving import (CrossDCDeployment, DeploymentConfig,
                                     Request)

    dep = CrossDCDeployment(Model(cfg), params, DeploymentConfig(
        threshold=2048, pd_clusters=1, wire_compression=True,
        decode_slots=8, capacity=16384, decode_block_size=8,
        min_prefill_bucket=128, max_prefill_bucket=4096))
    rng = np.random.default_rng(0)
    lens = [100, 700, 1500, 2500, 3800, 5000, 9000, 12000, 300]
    prompts = [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
               for L in lens]
    # a later turn of the 5000-token session: its prefix is cached
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
    for batch in batches:
        out.update(dep.submit_batch(batch))
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
    for name in ("flash_attention", "decode_attention",
                 "delta_chunked_fused", "quantize_int8_fused"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for r in reqs:
        toks = np.asarray(out[r.rid].output_tokens)
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {r.rid} emitted out-of-vocabulary tokens")
    summary = {
        "requests": len(reqs), "routes": routes,
        "prompt_tokens": [len(r.tokens) for r in reqs],
        "cached_tokens": [r.cached_tokens for r in reqs],
        "chunked": sum(1 for r in reqs if len(r.tokens) > 4096),
        "tokens_out": sum(len(out[r.rid].output_tokens) for r in reqs),
        "wire_raw_bytes": wire_raw, "wire_quantized_bytes": wire_q,
        "wire_compression": ratio,
        "truncations": dep.metrics()["truncations"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wall_s": wall,
        # host seconds inside the schedulers' ticks, and of those inside
        # decode blocks (the rest is prefill, admission and accounting)
        "scheduler_wall_s": sum(s.wall_s for s in dep.schedulers.values()),
        "decode_wall_s": sum(d.decode_wall_s for d in dep.decoders.values()),
        "launches": launches,
    }
    return summary, launches


def compare_logits(torch, dev, cfg, params):
    """Phase 5: one bucketed prefill batch through the kernels and through
    the plain versions."""
    from repro_torch.models import Model

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g,
                         device=dev)
    lens = torch.tensor([1024, 700], dtype=torch.int32, device=dev)
    with torch.no_grad():
        got, _ = Model(cfg).prefill(params, {"tokens": toks, "lengths": lens})
        want, _ = Model(cfg, use_kernels=False).prefill(
            params, {"tokens": toks, "lengths": lens})
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("non-finite first-token logits")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    if diff > TOL_LOGITS * scale:
        fail(f"first-token logits differ by {diff:.4f} > {TOL_LOGITS} x "
             f"max |logit| {scale:.4f}")
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return {"logits_max_abs_diff": diff, "logits_max_abs": scale,
            "argmax_agreement": same}


def main():
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

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = check_kernels(torch, dev)
    for name, k in kernels.items():
        print(f"check {name}: max_abs_err {k['max_abs_err']:.3e} (atol "
              f"needed at rtol {TOL_BF16[1]}: {k['atol_needed']:.3e}), "
              f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']})", flush=True)
    torch.cuda.empty_cache()

    from repro_torch.params import init_params
    cfg = full_width_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    print(f"params: {cfg.param_count() / 1e9:.2f} B "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    summary, launches = main_path(torch, dev, cfg, params)
    summary.update(compare_logits(torch, dev, cfg, params))

    entries = [dict(name=name, route="cuda", source=k["source"],
                    replaces=k["replaces"], launches=launches.get(name, 0),
                    max_abs_err=k["max_abs_err"], ms=k["ms"],
                    plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                    bound_by=k["bound_by"], library_ms=k["library_ms"],
                    atol_needed=k["atol_needed"], shape=k["shape"])
               for name, k in kernels.items()]
    print(json.dumps({"main_path": summary}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
