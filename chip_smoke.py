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
     path runs, and flash at h2o-danube's sliding window (head dim 80,
     window 4096, whole and as chunks after 4608 and 8192 keys); the dense
     and paged decode at the four group sizes the main paths run, MLA,
     GQA at head dims 128 and 80, and MHA, and the paged one also at zamba2's
     decode block, 8 rows of 4000 tokens; the delta rule, rows 3 and 5, at
     its table shape and at the shapes the main paths run, kimi's prefill
     chunk and the recipe's float32 microbatch; gated linear attention,
     rows 6 and 7, at its table shapes and at zamba2's prefill chunk and
     training microbatch; the int8 wire encode, row 4, at its table shape
     by CUDA events and profiler device time, and at three requests'
     shapes read in place from their padded caches, mistral-nemo's and
     zamba2's 12000-token k / v and kimi's 4096-token latents, against the
     plain encode and the trim, cast and kernel chain before it, with each
     one's time and peak memory); the shapes of llama4 (G 5), mixtral (G 6,
     window 4096), phi-3 (head dim 96) and seamless (flash not causal with
     Sq != Sk, decode over the fixed encoder length) in bf16 and float32,
     and paged prefill at llama4's G 5; after printing the ptxas registers and
     spills of the bf16 decode core's, the delta core's, the GLA core's
     and the wire encode's instances;
     then each differentiable op (attention, gla and delta, with and
     without lengths) at the training paths' shapes and types: its kernel
     forward against the plain version's outputs, and its gradients
     against autograd through the plain version (the same plain backward
     on both sides, so a check of the wiring), mixtral's sliding window
     at 8192 tokens among them; and ``swa_banded``'s float32 gradient
     against the quadratic plain version's;
  3b. calibrate the card (``repro_torch.analysis.calibrate.sweep`` in
     bf16: a matmul and a streaming probe, then causal attention through
     the flash kernel plus the FFN's products at prefill lengths
     256-4096, each timed as replays of a CUDA graph of its calls, the
     eager dispatch's time recorded beside it), print the peaks, the
     points and the fit, and write them to
     ``build/calibration_h100.json``; a peak above 1.05x the data sheet's,
     an MFU outside (0, 1] or no flash launch fails;
  4. drive the main paths, each warmed first (``PrefillEngine.warmup`` of
     the traffic's shapes with each region's decode engine: every prefill
     bucket and chunk count, the paged admission, and the capture of the
     decode block as a CUDA graph, which every later block replays), then
     with every kernel launch counted from 0 (a replay adds the launches
     its capture recorded), through ``CrossDCDeployment`` serving prompts
     of 100-12000 tokens through both routes with int8 wire compression
     and chunked prefill, then a later turn of one session:
       * ``kimi-linear-1t`` at its published widths (depth cut to one
         [KDA, KDA, KDA, MLA] unit and the MoE to 32 of its 352 experts, so
         the bf16 weights, ~17.8 GB, fit the card), with the dense KV
         layout and then with paged KV;
       * ``mistral-nemo-12b`` at full width, depth cut to ``MISTRAL_LAYERS``
         (20 of 40 layers, ~13.6 GB of bf16 weights), paged, where the
         later turn resumes from the device pages of its cached prefix and
         prefills only its suffix;
       * ``zamba2-1.2b`` at full width and depth (32 Mamba2 layers and a
         shared attention + FFN block invoked 6 times, ~2.5 GB of bf16
         weights), dense and then paged, with a page-aligned 4992-token
         session whose later turn, paged, pins 4992 cached tokens (pool
         pages and the Mamba2 state snapshot) and prefills 600;
       * ``h2o-danube-1.8b`` at full width, ``DANUBE_LAYERS`` (12 of 24)
         layers of sliding-window GQA (window 4096, head dim 80, ~2.0 GB
         of bf16 weights), dense (rings of 4096 rows a slot) and then
         paged (each slot's private ring table of 256 pages), with the
         same 4992-token session, past the window, whose later turn,
         paged, resumes from the ring snapshot (4992 cached tokens) and
         prefills 600;
       * ``xlstm-350m`` at full width, ``XLSTM_PAIRS`` (6 of 12) [mLSTM,
         sLSTM] pairs (~0.25 GB of bf16 weights), dense and then paged
         (state slots alone: it has no attention), over ten prompts of
         64-640 tokens in chunks of 256 with threshold 256 (the sLSTM is a
         plain PyTorch step a token, host-bound: ``slstm_prefill_cost`` times
         it first), whose 512-token session's later turn, paged, resumes
         from the state snapshot and prefills 128; every leaf ships as it
         is (ratio 1, as the reference's wire); its greedy replay on both
         layouts, sampled on the paged one, speculative decode with
         prompts cut to 256 tokens, and its logit checks (float32 gated:
         the prefill within 2 %, the paged decode step equal to the dense
         one bit for bit);
       * ``llama4-scout-17b-a16e`` and ``mixtral-8x22b`` at every
         published width and expert, depth cut to 8 of 48 and 8 of 56
         layers (~39.4 and ~40.9 GB of bf16 weights; ``moe_paths``),
         dense and paged: llama4's later turn resumes from its device
         prefix through the paged-prefill kernel, mixtral's 4992-token
         session passes its window and its later turn resumes from the
         ring snapshot and prefills 600; replays greedy and sampled, a
         profiled paged decode block, speculative decode (bf16 tokens
         gated equal to the plain greedy ones; mixtral adds a 4600-token
         prompt whose rings wrap), bf16 logits recorded, and the float32
         2 % gates on a 2-layer cut of each at the same widths;
       * ``seamless-m4t-medium`` (encoder-decoder, 12 + 12 layers) and
         ``phi-3-vision-4.2b`` (VLM, 32 layers) at full width and depth
         through ``Model.prefill`` / ``decode_step`` (no engine takes
         them, as none of the reference's does): seamless over 3000
         frames and 500 / 350 tokens, phi-3 over 576 patches and 2000 /
         1400 tokens, 16 greedy decode steps each; the decode-from-prefill
         invariant (bf16 recorded, float32 gated at 5e-4) and the logits
         (bf16 recorded, float32 gated at 2 %) (``encdec_vlm_paths``);
     random weights from a seed, each model's weights freed before the
     next one's load; on each path the first offloaded request's in-situ
     wire payload must equal the plain encode of its batch cache, byte for
     byte, and each decode engine must have captured its block once; then
     on each path two decode engines, the graph replayed and
     the eager block (``graphs=False``), take the same eight prefilled
     requests and must emit the same tokens (``check_replay``); on the two
     kimi paths again sampling (temperature 0.8, top-k 50): graph and
     eager the same tokens, a second engine of the seed the same, another
     seed other tokens, temperature 1 with top-k 1 the greedy tokens, each
     graph captured once; then speculative decode on each model, dense and
     paged (``check_spec``: nine prompts, one a repeated 16-token phrase,
     into a plain graph engine, a speculative graph engine and a
     speculative eager one, ``spec_k`` 2, one-token n-grams): replayed =
     eager tokens, one capture each, verify rounds run, pages conserved,
     the decode kernel launched (its launches counted from 0), the tokens
     identical to the plain greedy ones, gated in bf16 on every path whose
     verify runs the plain step's shapes (the scan verify: kimi, zamba2 and
     h2o-danube dense and paged, the latter with a tenth prompt past the
     window so its rings wrap and roll back; mistral-nemo paged) and on
     mistral-nemo dense (one pass, its products over B x 3 rows) recorded
     in bf16 and gated in float32 after phase 5's conversion; one spec and
     one plain block profiled on mistral-nemo dense and kimi paged; and kimi's prefill repeated three times and its
     dropless MoE three, every cache leaf and every MoE output the same
     bits (``prefill_repeatability``, gated);
  5. compare logits through the kernels with those through the plain
     versions (largest difference within 2 % of the largest |logit|): one
     prefill batch of kimi in bf16; one prefill batch and one paged decode
     step of mistral-nemo-12b, of zamba2-1.2b and of h2o-danube-1.8b (its
     prefill of 5000 tokens, past the window), recorded in bf16 and held
     in float32 (over their 20-38 layers bf16 rounding flips compound by
     themselves: ~2 % on mistral-nemo at 40, ~11 % on zamba2's prefill, on
     an H100), and zamba2's bf16 prefill logits through the kernels no
     further from the float32 plain logits than 1.5x the plain bf16
     logits' distance; time the MLA paged decode's whole-pool [ckv, kpe]
     concatenation against a decode step; and profile one paged decode
     block of mistral-nemo-12b and of zamba2-1.2b, replayed as a graph and
     eager, and one 4096-token
     prefill of kimi, mistral-nemo and zamba2 (``torch.profiler``: device
     busy time, the largest kernels and the flash, decode, delta and GLA
     kernels' shares); each profiled decode block (kimi's too) also as a
     sampling graph, recorded beside the greedy one; the verify attention
     (three decode-kernel calls at mistral-nemo's GQA shape) against its
     one-pass plain version, gated at the bf16 tolerance; and that no
     row's decode output moves with another row's length, dense and paged
     at every group size the bf16 core serves, float32 at GQA
     (``decode_batch_variance``, gated);
  5b. the serving launcher end to end (``repro_torch.launch.serve
     .run_serve``, in-process): zamba2-1.2b at full width and depth,
     twelve requests in three batches over three PD regions, int8 wire,
     the calibration of 3b, sampled decode and ``--cross-validate``; with
     frozen thresholds every request must be answered with its tokens,
     both routes taken, the simulator replay must agree on every route
     with no threshold moved, and flash, decode, masked GLA and quantize
     must launch; then once with live feedback, its agreement recorded;
     then greedy and speculative (``--spec-k 2``), frozen, gated the same
     way, its replay priced with the live acceptance;
  6. the training path on ``zamba2-1.2b`` at full width, 14 of its 38
     layers (``ZAMBA2_TRAIN_UNITS``): four
     AdamW steps of 2 x 2048 tokens in two microbatches with remat
     through ``make_train_step`` (the Mamba2 mixers on the unmasked GLA
     kernel, row 6), one more profiled; then the loss and gradients of one
     2048-token row through the kernels against the plain versions, bf16
     recorded and float32 gated, and the bf16 gradients through the
     kernels no further from the float32 ones than 1.5x the plain bf16
     gradients' distance;
  7. the reference's KDA:MLA 3:1 training recipe at its 100m scale
     (``repro_torch.examples.train_100m``): 20 steps of 8 x 1024 tokens
     through ``TrainLoop`` with checkpoints in a temporary directory (the
     KDA mixers on the unmasked delta kernel, row 5); its loss must fall;
  8. ``train_more``: three AdamW steps each, remat, random bf16 weights
     from a seed, of mixtral-8x22b (``MIXTRAL_TRAIN_LAYERS``, 1 of 56
     layers, every expert; 1 x 8192 tokens: the capacity MoE and its aux
     loss, the flash kernel's backward recompute through ``swa_banded``;
     step 0 twice, the same bits), seamless-m4t-medium at full depth (2 x
     1024 tokens over 2048 random frames; ``mea_attention``) and
     phi-3-vision-4.2b (``PHI3_TRAIN_LAYERS``, 8 of 32; 2 x (576 random
     patches + 1024 tokens)): finite losses and grad norms, a step-0 loss
     within 1.0 of the random init's, probe leaves moved (the router and
     an expert, ``enc_proj`` and an encoder layer, ``patch_proj``), flash
     launched; mixtral's (2048 tokens) and seamless's (one row) float32
     loss and grad norm through the kernels against the plain versions,
     gated, with the routing decisions that differ; each run's aux,
     dropped pairs and peak memory printed;
  9. ``dryrun``: the work of five steps the earlier phases timed, counted
     on the ``meta`` device at the same cuts (``dryrun_shares``,
     ``repro_torch.analysis.counting``): kimi's and mistral-nemo's
     4096-token prefills, their 8-slot x 4000-token decode blocks of 8
     steps (the dense ``decode_step``, the paged one's arithmetic) and
     zamba2's train step; each step's model FLOPs as run
     (``roofline.model_flops_for(..., as_run=True)``: no input lookup,
     the logits of the rows computed) over its profiled busy time as a
     share of the calibration's measured peak (``mfu``, recorded) and of
     989 TFLOP/s (``mfu_989``), its counted FLOPs over the busy time as a
     share of 989 TFLOP/s (``counted_989``), and its counted bytes (op by
     op, a kernel op at its kernel's boundary; not traced) over the busy
     time as a share of 3.35 TB/s (``hbm_share``); a share of the data
     sheet outside (0, 1.05] fails (a counting or timing fault);
 10. ``examples``: ``repro_torch.examples.quickstart`` and
     ``serve_cross_dc`` on the card, each as a subprocess; a non-zero
     exit fails.

Each phase's seconds are printed as it ends (``phase <name>: <s>``) and
kept under ``phase_s`` in the summary.  The last lines are the main
paths' summary, the ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line and ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, when there is no CUDA device or no
port beside this script.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
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
TOL_STATE = (1e-4, 1e-3)       # float32 outputs and states (abs, rel)
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
# the calibration sweep's measured peaks may exceed the data sheet's by
# this factor at most (a higher reading is a timing fault, not a card)
TOL_PEAK = 1.05
# the sampled decode the new phases run
SAMPLING = dict(temperature=0.8, top_k=50)
# xlstm-350m's traffic: ten prompts of 64-640 tokens, the 512-token
# session at index 5 (its later turn adds 128), a threshold of 256 so both
# routes occur, and chunks of 256 tokens.  Cut from 64-3000 tokens,
# threshold and chunks 1024 and a 2048 + 512-token session: the sLSTM's
# plain steps cost ~0.5 ms a token a layer of host time on the card
# (``slstm_prefill_cost``), which put that traffic's phase at ~460 s
XLSTM_LENS = (64, 100, 200, 256, 300, 512, 180, 400, 640, 120)
XLSTM_SESSION, XLSTM_EXT, XLSTM_CHUNK = 512, 128, 256
# depth cuts of earlier paths, their widths kept, so that the phases stay
# within 900 s on a loaded host with the MoE, encoder-decoder and VLM
# phases (the phases read 794-849 s without those, 987 s with them and
# only the first two cuts, on a loaded host; ``PERF.md``):
# mistral-nemo-12b serves 20 of its 40 layers, h2o-danube-1.8b 12 of its
# 24, xlstm-350m 6 of its 12 [mLSTM, sLSTM] pairs, and zamba2-1.2b trains
# 2 of its 6 [5 x Mamba2, shared block] units and its 2-layer tail (14 of
# 38 layers)
MISTRAL_LAYERS = 20
DANUBE_LAYERS = 12
XLSTM_PAIRS = 6
ZAMBA2_TRAIN_UNITS = 2
# the train_more phase's cuts, every width and expert kept: mixtral-8x22b
# trains 1 of its 56 layers (2.91 B params: bf16 params and grads and
# AdamW's float32 moments and master, ~46.6 GB, fit the card) and
# phi-3-vision-4.2b 8 of its 32
MIXTRAL_TRAIN_LAYERS = 1
PHI3_TRAIN_LAYERS = 8
# the launcher phase: zamba2-1.2b, the hybrid family the launcher serves at
# full width and depth on one card, through three PD regions with
# cross-validation against the simulator replay (``--calibration`` and
# ``--freeze-thresholds`` are added by the phase)
LAUNCHER_ARGS = ("--arch", "zamba2-1.2b", "--requests", "12",
                 "--batches", "3", "--pd-clusters", "3",
                 "--pd-mesh-gbps", "10", "--link-gbps", "10",
                 "--wire-compression", "--cross-validate",
                 "--temperature", str(SAMPLING["temperature"]),
                 "--top-k", str(SAMPLING["top_k"]))


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
# and the group sizes the main paths run (tag, Hq, Hkv, Dk, Dv, scale):
# kimi's absorbed MLA, mistral-nemo's GQA, h2o-danube's GQA at head dim 80
# (its ring holds at most 4096 keys and takes no window) and zamba2's MHA;
# then llama4's and mixtral's GQA (G 5 and 6: the stream's 8-head
# instance) and phi-3's MHA at head dim 96, also checked in float32
CHECK_LENGTHS = (16384, 12001, 9000, 5601, 3800, 1501, 701, 101)
NEW_DECODE_GROUPS = (("GQA_G5", 40, 8, 128, 128, 128 ** -0.5),
                     ("GQA_G6", 48, 8, 128, 128, 128 ** -0.5),
                     ("MHA96", 32, 32, 96, 96, 96 ** -0.5))
DECODE_GROUPS = (("MLA", 64, 1, 536, 472, 192 ** -0.5),
                 ("GQA", 32, 8, 128, 128, 128 ** -0.5),
                 ("GQA80", 32, 8, 80, 80, 80 ** -0.5),
                 ("MHA", 32, 32, 64, 64, 64 ** -0.5)) + NEW_DECODE_GROUPS
# the flash kernel's shapes on the paths of llama4 (GQA, G 5), mixtral
# (G 6, window 4096, the logit checks' 5000-token prefill), phi-3 (MHA at
# head dim 96 over 576 patches and 2000 tokens) and seamless (its
# bidirectional encoder over 3000 frames, and 500 decoder queries over
# those 3000 keys in a cross block): (tag, B, Hq, Hkv, Sq, Sk, D, causal,
# window), each checked in bf16 and in float32
NEW_FLASH_SHAPES = (("llama4_gqa_g5", 1, 40, 8, 4096, 4096, 128, True, 0),
                    ("mixtral_swa_g6", 1, 48, 8, 5000, 5000, 128, True, 4096),
                    ("phi3_mha_d96", 1, 32, 32, 2576, 2576, 96, True, 0),
                    ("seamless_encoder", 2, 16, 16, 3000, 3000, 64, False, 0),
                    ("seamless_cross", 2, 16, 16, 500, 3000, 64, False, 0))


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


def time_decode_shapes(torch, dev):
    """Rows 2 and 8 timed at their table shapes (B 8, lengths 16384..101
    over S 16384; paged: pages of 16 through permuted tables) at the three
    DECODE_GROUPS, and at 8 rows of 4000 tokens (zamba2's and mistral-nemo's
    decode blocks): {"dense" | "paged": {shape: ms}} by CUDA events over
    50 launches.  Imports ``repro_torch`` when called, so the kernels timed
    are those of the checkout on the path."""
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.paged_decode_attn import paged_decode_attention

    g = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    T, S, B = 16, 16384, 8
    P, N = B * S // T + 1, S // T

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    out = {"dense": {}, "paged": {}}
    for name, lengths in (("16384..101", CHECK_LENGTHS),
                          ("8x4000", (4000,) * B)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        tables = _paged_tables(torch, dev, g, list(lengths), T, N, P)
        for tag, Hq, Hkv, Dk, Dv, scale in DECODE_GROUPS:
            q = randn(B, Hq, Dk)
            k, v = randn(B, Hkv, S, Dk), randn(B, Hkv, S, Dv)
            out["dense"][f"{tag} {name}"] = _ms(
                lambda: decode_attention(q, k, v, lens, scale=scale), 50)
            del k, v
            kp, vp = randn(Hkv, P, T, Dk), randn(Hkv, P, T, Dv)
            out["paged"][f"{tag} {name}"] = _ms(
                lambda: paged_decode_attention(q, kp, vp, tables, lens,
                                               scale=scale), 50)
            del kp, vp
    return out


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


# rows 3 and 5 (the delta core): the shape each is timed at in the table,
# and the shapes the main paths run it at (kimi's 4096-token prefill
# chunk, masked; the KDA:MLA recipe's microbatch in float32, unmasked)
DELTA_SHAPES = {
    "row3_table": ("delta_chunked_fused", (2, 56, 4096, 128), "bf16",
                   (4096, 2500)),
    "row3_kimi_prefill": ("delta_chunked_fused", (1, 56, 4096, 128), "bf16",
                          (4096,)),
    "row5_table": ("delta_chunked", (2, 56, 4096, 128), "bf16", None),
    "row5_recipe": ("delta_chunked", (4, 8, 1024, 64), "f32", None),
}


def delta_case(torch, dev, g, tag):
    """One of DELTA_SHAPES: its inputs (unit q and k, decays and beta as
    KDA gives them, a nonzero state), the kernel and its plain version as
    callables over them, the rows below the lengths, and the bound: each
    valid row's q, k, v, o, log_a and beta once, the state in and out and
    the lengths, against the FLOPs of the chunk products at the inputs'
    type (bf16 tensor cores, float32 SIMT)."""
    import torch.nn.functional as F

    from repro_torch.kernels import delta as kd

    name, (B, H, S, d), dt, lens = DELTA_SHAPES[tag]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q = F.normalize(randn(B, H, S, d), dim=-1).to(dtype)
    k = F.normalize(randn(B, H, S, d), dim=-1).to(dtype)
    v = randn(B, H, S, d).to(dtype)
    la = -0.1 * randn(B, H, S).abs()
    beta = torch.rand((B, H, S), generator=g, device=dev) * 0.9 + 0.1
    s0 = 0.1 * randn(B, H, d, d)
    if lens is None:
        lengths = None
        valid = torch.ones((B, H, S), dtype=torch.bool, device=dev)

        def run():
            return kd.delta_chunked(q, k, v, la, beta, s0)

        def plain():
            return kd.delta_chunked_ref(q, k, v, la, beta, s0)
    else:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(S, device=dev)[None, :]
                 < lengths[:, None])[:, None].expand(B, H, S)

        def run():
            return kd.delta_chunked_fused(q, k, v, la, beta, lengths, s0)

        def plain():
            la_m, k_m, b_m = kd.mask_padded(lengths, S, la, k, beta)
            return kd.delta_chunked_ref(q, k_m, v, la_m, b_m, s0)
    rows = int(valid.sum())
    chunks = H * sum(-(-min(n, S) // 64) for n in (lens or (S,) * B))
    per_chunk = 4 * 64 * 64 * d + 6 * 64 * d * d + 2 * 64 * 64 * d
    # both dtypes run every product on the bf16 tensor cores (float32
    # operands in bf16 parts), so the operations count at their rate
    bnd = _bound(rows * (4 * d * q.element_size() + 2 * 4)
                 + 2 * _nbytes(s0) + (0 if lengths is None
                                      else _nbytes(lengths)),
                 chunks * per_chunk, BF16_FLOP_S)
    shape = (f"q,k,v ({B},{H},{S},{d}) {dt}, state ({B},{H},{d},{d}) f32, "
             + ("no lengths" if lens is None
                else "lengths " + ", ".join(map(str, lens))))
    return dict(name=name, run=run, plain=plain, valid=valid, bound=bnd,
                shape=shape, dtype=dtype)


def _time_shapes(torch, dev, shapes, case_fn):
    g = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for tag in shapes:
        case = case_fn(torch, dev, g, tag)
        out[tag] = _ms(case["run"], 10)
        del case
        torch.cuda.empty_cache()
    return out


def time_delta_shapes(torch, dev):
    """ms of rows 3 and 5 at each of DELTA_SHAPES, by CUDA events: only the
    wrappers' public calls, so the same timing runs on a parent checkout's
    kernels (two checkouts timed in turns)."""
    return _time_shapes(torch, dev, DELTA_SHAPES, delta_case)


def time_gla_shapes(torch, dev):
    """ms of rows 6 and 7 at each of GLA_SHAPES, as time_delta_shapes."""
    return _time_shapes(torch, dev, GLA_SHAPES, gla_case)


def scan_entry(torch, dev, g, close, atol_needed, name, source, replaces,
               shapes, case_fn):
    """Rows 3 and 5 (DELTA_SHAPES, delta_case) or 6 and 7 (GLA_SHAPES,
    gla_case): the kernel against its plain version at each of its shapes
    (outputs at TOL_BF16 in bf16, TOL_STATE in float32, below the lengths;
    the state at TOL_STATE), each shape's time, plain time, bound, bf16
    flip rate and device time per kernel (the core's phases); the table
    shape's numbers are the entry's own."""
    out = {}
    for tag, spec in shapes.items():
        if spec[0] != name:
            continue
        case = case_fn(torch, dev, g, tag)
        o, st = case["run"]()
        torch.cuda.synchronize()
        o2, st2 = case["plain"]()
        vm = case["valid"]
        otol = TOL_BF16 if case["dtype"] == torch.bfloat16 else TOL_STATE
        e_o = close(f"{name} (o, {tag})", o[vm], o2[vm], *otol)
        e_s = close(f"{name} (state, {tag})", st, st2, *TOL_STATE)
        out[tag] = dict(
            max_abs_err=e_o, state_max_abs_err=e_s,
            atol_needed=atol_needed(o[vm], o2[vm], otol[1]),
            ms=_ms(case["run"], 10), plain_ms=_ms(case["plain"], 2),
            bound_ms=case["bound"][0], bound_by=case["bound"][1],
            library_ms=None, shape=case["shape"])
        out[tag]["bound_share"] = out[tag]["bound_ms"] / out[tag]["ms"]
        if case["dtype"] == torch.bfloat16:
            # outputs that round to another bf16 value than the float32
            # plain version's
            out[tag]["bf16_flip_rate"] = float(
                (o[vm] != o2[vm]).float().mean())
        out[tag]["phases_ms"] = _kernel_ms(torch, case["run"], 5)
        del case, o, st, o2, st2
        torch.cuda.empty_cache()
    table = out[next(t for t in out if t.endswith("_table"))]
    return dict(source=source, replaces=replaces,
                max_abs_err=max(c["max_abs_err"] for c in out.values()),
                atol_needed=max(c["atol_needed"] for c in out.values()),
                **{key: table[key] for key in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "shape")},
                shapes=out)


# rows 6 and 7 (the GLA core), all bf16, at zamba2's Mamba2 head (H = 32,
# dk = 64, dv = 128) unless a head (dk, dv) is given: the shape each is
# timed at in the table, and the shapes the main paths run it at (zamba2's
# 4096-token prefill chunk, masked; its 2048-token training microbatch,
# unmasked; xlstm-350m's 256-token mLSTM prefill chunk, 4 heads of dk 256
# and dv 257, the normaliser's ones column included)
GLA_SHAPES = {
    "row7_table": ("gla_chunked_fused", (2, 32, 4096), (4096, 2500)),
    "row7_zamba2_prefill": ("gla_chunked_fused", (1, 32, 4096), (4096,)),
    "row7_xlstm_prefill": ("gla_chunked_fused", (1, 4, XLSTM_CHUNK),
                           (XLSTM_CHUNK,), (256, 257)),
    "row6_table": ("gla_chunked", (2, 32, 2048), None),
    "row6_zamba2_train": ("gla_chunked", (1, 32, 2048), None),
}


def gla_case(torch, dev, g, tag):
    """One of GLA_SHAPES: its inputs (q, k at the Mamba2 scale, decays
    from mild to strong in multiples of 2^-10, a nonzero state), the
    kernel and its plain version as callables over them, the rows below
    the lengths, and the bound: each valid row's q, k, v, o and log_a
    once, the state in and out and the lengths, against the FLOPs of the
    causal Q K^T and A V, q S and the state update at the bf16
    tensor-core rate."""
    from repro_torch.kernels import gla as kg

    name, (B, H, S), lens, *head = GLA_SHAPES[tag]
    dk, dv = head[0] if head else (64, 128)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    q = randn(B, H, S, dk).to(torch.bfloat16)
    k = randn(B, H, S, dk, scale=dk ** -0.5).to(torch.bfloat16)
    v = randn(B, H, S, dv).to(torch.bfloat16)
    # decays in multiples of 2^-10: every cumulative sum is exact, so the
    # kernel and the plain version share them
    la = torch.round(-2048.0 * torch.rand(
        (B, H, S), generator=g, device=dev) ** 3) / 1024
    s0 = randn(B, H, dk, dv, scale=0.5)
    if lens is None:
        lengths = None
        valid = torch.ones((B, H, S), dtype=torch.bool, device=dev)

        def run():
            return kg.gla_chunked(q, k, v, la, s0)

        def plain():
            return kg.gla_chunked_ref(q, k, v, la, s0)
    else:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(S, device=dev)[None, :]
                 < lengths[:, None])[:, None].expand(B, H, S)

        def run():
            return kg.gla_chunked_fused(q, k, v, la, lengths, s0)

        def plain():
            la_m, k_m = kg.mask_padded(lengths, S, la, k)
            return kg.gla_chunked_ref(q, k_m, v, la_m, s0)
    rows = int(valid.sum())
    chunks = H * sum(-(-min(n, S) // 64) for n in (lens or (S,) * B))
    # causal pairs of q k^T and A v, then q S and the state update
    per_chunk = 64 * 65 // 2 * 2 * (dk + dv) + 2 * (2 * 64 * dk * dv)
    bnd = _bound(rows * ((2 * dk + 2 * dv) * 2 + 4) + 2 * _nbytes(s0)
                 + (0 if lengths is None else _nbytes(lengths)),
                 chunks * per_chunk, BF16_FLOP_S)
    shape = (f"q,k ({B},{H},{S},{dk}) v ({B},{H},{S},{dv}) bf16, log_a f32, "
             f"state ({B},{H},{dk},{dv}) f32 nonzero, "
             + ("no lengths" if lens is None
                else "lengths " + ", ".join(map(str, lens))))
    return dict(name=name, run=run, plain=plain, valid=valid, bound=bnd,
                shape=shape, dtype=torch.bfloat16)


def _kernel_ms(torch, fn, reps: int):
    """Device ms of each kernel ``fn()`` launches, a run's mean over
    ``reps`` runs after a warm-up (``torch.profiler``)."""
    return {k: ms for k, (ms, _) in _device_kernels(torch, fn, reps).items()}


# row 4 at the main paths' request shapes: (tag, block, the wire leaves of
# the bucket-padded cache as (R, B, S, ...), request, prompt tokens): the
# k / v of a 12000-token mistral-nemo prompt (40 layers, chunked to 3 x
# 4096), zamba2's six shared-block k / v of one, and kimi's MLA latents of
# the second request of a padded batch of 4096-token prompts; bf16
WIRE_REQUESTS = (
    ("mistral_12000", "b0", {"k": (40, 1, 12288, 8, 128),
                             "v": (40, 1, 12288, 8, 128)}, 0, 12000),
    ("zamba2_12000", "b5", {"k": (6, 1, 12288, 32, 64),
                            "v": (6, 1, 12288, 32, 64)}, 0, 12000),
    ("kimi_4096", "b3", {"ckv": (1, 2, 4096, 472),
                         "kpe": (1, 2, 4096, 64)}, 1, 4096),
)


def wire_request_cache(torch, dev, block, shapes, seed):
    """A bucket-padded prefill cache holding only the wire leaves, bf16
    normal draws x 3 from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"groups": [{block: {
        name: torch.randn(shape, generator=g, device=dev,
                          dtype=torch.bfloat16) * 3.0
        for name, shape in shapes.items()}}]}


def wire_encoder():
    """(name, encode(caches, idx, length) -> wire pytree) of the wire
    encode this checkout's ``repro_torch`` runs for one offloaded request:
    in place where it has ``encode_request_for_wire``, else the trim, then
    ``quantize_cache_for_wire``."""
    from repro_torch.models import kvcache
    from repro_torch.serving.engine import trim_request_cache
    enc = getattr(kvcache, "encode_request_for_wire", None)
    if enc is not None:
        return "in_place", lambda c, i, n: enc(c, i, n)[0]
    return "trim_then_encode", lambda c, i, n: kvcache.quantize_cache_for_wire(
        trim_request_cache(c, i, n))[0]


def _trim_encode(caches, idx, length, encode):
    """The trimmed cache with each wire leaf cast to float32 and encoded by
    ``encode(x) -> (q, scale)``, the scale cast to the leaf's dtype."""
    from repro_torch.models.kvcache import WIRE_LEAVES
    from repro_torch.models.tree import tree_map_named
    from repro_torch.serving.engine import trim_request_cache

    def enc(name, leaf):
        if name in WIRE_LEAVES and leaf.dtype.is_floating_point:
            q, scale = encode(leaf.float())
            return {"q": q, "scale": scale.to(leaf.dtype)}
        return leaf

    return tree_map_named(enc, trim_request_cache(caches, idx, length))


def plain_wire(caches, idx, length):
    """The plain encode of one request: trim, cast, ``quantize_int8_ref``."""
    from repro_torch.kernels.quantize import quantize_int8_ref
    return _trim_encode(caches, idx, length, quantize_int8_ref)


def trim_cast_kernel_wire(caches, idx, length):
    """The call chain before the in-place encode: trim, float32 cast, one
    kernel call a leaf, scale cast."""
    from repro_torch.kernels.quantize import quantize_int8_fused
    return _trim_encode(caches, idx, length, quantize_int8_fused)


def wire_identical(torch, a, b) -> bool:
    """Two wire pytrees with the same paths, shapes, dtypes and bytes."""
    from repro_torch.models.tree import tree_flatten_with_path
    fa, fb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(fa, fb))


def _device_kernels(torch, fn, reps: int):
    """{kernel: (device ms, launches)} of one ``fn()``, a mean over
    ``reps`` runs after a warm-up (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: (e.self_device_time_total / 1e3 / reps,
                                  e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def time_wire(torch, fn, reps: int):
    """One encode call: its ms by CUDA events, its device ms and kernel
    launches by the profiler, each quantize pass's device ms, and its
    peak memory above what was allocated before it."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    kernels = _device_kernels(torch, fn, reps)
    return {"ms": _ms(fn, reps),
            "device_ms": sum(ms for ms, _ in kernels.values()),
            "device_launches": sum(n for _, n in kernels.values()),
            "passes_ms": {k.split("::")[-1]: ms
                          for k, (ms, _) in kernels.items()
                          if "absmax_kernel" in k or "encode_kernel" in k},
            "peak_gb": peak / 1e9}


def profile_wire_encode(torch, dev):
    """Row 4 on this checkout's ``repro_torch``, for timing two checkouts
    in turns: the kernel at its table shape, x (4096, 472) float32 (CUDA
    events and profiler device time), and the wire encode of each of
    ``WIRE_REQUESTS`` that the checkout's serving path runs
    (:func:`wire_encoder`), with its peak memory."""
    from repro_torch.kernels.quantize import quantize_int8_fused

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4096, 472), generator=g, device=dev) * 3.0
    table = time_wire(torch, lambda: quantize_int8_fused(x), 50)
    del x
    how, encode = wire_encoder()
    out = {"encode": how, "table_4096x472_f32": table}
    for seed, (tag, block, shapes, idx, length) in enumerate(WIRE_REQUESTS):
        caches = wire_request_cache(torch, dev, block, shapes, seed)
        out[tag] = time_wire(torch, lambda: encode(caches, idx, length),
                             5 if tag.startswith("mistral") else 20)
        del caches
    return out


def check_quantize(torch, dev, g):
    """Phase 3, row 4: the kernel against its plain version at its table
    shape, x (4096, 472) float32, timed by CUDA events and by profiler
    device time; then at each of ``WIRE_REQUESTS``, read in place from the
    padded cache, against the plain encode (trim, cast,
    ``quantize_int8_ref``) and the call chain before it (trim, cast, one
    kernel call a leaf), each byte-identical, each timed with its peak
    memory, beside the bound (the trimmed bf16 read once, the codes
    written once)."""
    from repro_torch.kernels.quantize import (quantize_int8_fused,
                                              quantize_int8_ref)

    x = (torch.randn((4096, 472), generator=g, device=dev) * 3.0)
    qq, sc = quantize_int8_fused(x)
    torch.cuda.synchronize()
    qr, sr = quantize_int8_ref(x)
    if not (torch.equal(qq, qr) and
            sc.view(torch.int32).item() == sr.view(torch.int32).item()):
        fail("quantize_int8_fused is not byte-identical to its plain version")
    bnd = _bound(x.numel() * 5 + 4, 3 * x.numel(), F32_FLOP_S)
    table = time_wire(torch, lambda: quantize_int8_fused(x), 50)
    entry = dict(
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:78",
        max_abs_err=float((qq.float() - qr.float()).abs().max()),
        atol_needed=0.0, ms=table["ms"], device_ms=table["device_ms"],
        phases_ms=table["passes_ms"],
        plain_ms=_ms(lambda: quantize_int8_ref(x), 20),
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
        shape="x (4096,472) f32 -> int8 + scale, byte-identical")
    del x, qq, qr
    _, encode = wire_encoder()
    requests = {}
    for seed, (tag, block, shapes, idx, length) in enumerate(WIRE_REQUESTS):
        caches = wire_request_cache(torch, dev, block, shapes, seed)
        got = encode(caches, idx, length)
        torch.cuda.synchronize()
        before = trim_cast_kernel_wire(caches, idx, length)
        want = plain_wire(caches, idx, length)
        if not (wire_identical(torch, got, want)
                and wire_identical(torch, before, want)):
            fail(f"the wire encode of {tag} is not byte-identical to the "
                 "plain encode")
        del got, before, want
        n = sum(s[0] * min(length, s[2]) * math.prod(s[3:])
                for s in shapes.values())
        rb = _bound(n * 3 + 4 * len(shapes), 3 * n, F32_FLOP_S)
        reps = 5 if tag.startswith("mistral") else 20
        requests[tag] = {
            "elements": n, "bound_ms": rb[0], "bound_by": rb[1],
            "in_place": time_wire(
                torch, lambda: encode(caches, idx, length), reps),
            "trim_cast_kernel": time_wire(
                torch, lambda: trim_cast_kernel_wire(caches, idx, length),
                reps),
            "byte_identical": True}
        del caches
        gc_cuda(torch)
    entry["requests"] = requests
    return entry


class WireWitness:
    """While active, the first offloaded request a deployment encodes for
    the wire is held against the plain encode of the same batch cache
    (trim, cast, ``quantize_int8_ref``), byte for byte; the check fails
    the run if they differ."""

    def __init__(self, torch):
        self.torch = torch
        self.result = None

    def __enter__(self):
        from repro_torch.serving import deployment
        self._mod, self._orig = deployment, deployment.encode_request_for_wire

        def encode(caches, idx, length):
            out = self._orig(caches, idx, length)
            if self.result is None:
                ok = wire_identical(self.torch, out[0],
                                    plain_wire(caches, idx, length))
                if not ok:
                    fail(f"the in-situ wire payload of a {length}-token "
                         "request differs from its plain encode")
                self.result = {"tokens": length, "wire_bytes": out[1],
                               "byte_identical": ok}
            return out

        deployment.encode_request_for_wire = encode
        return self

    def __exit__(self, *exc):
        self._mod.encode_request_for_wire = self._orig


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
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_ref)

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
    # h2o-danube's sliding-window GQA (Hq 32 over Hkv 8, D 80, window
    # 4096): the logit checks' 5000-token prefill, a 4096-query chunk after
    # 4608 keys of prior (tiles cut by the window off a tile edge) and the
    # main path's third 4096-token chunk, at q_offset 8192
    for Sq, off in ((5000, 0), (4096, 4608), (4096, 8192)):
        qs = randn(1, 32, Sq, 80)
        ks, vs = randn(1, 8, off + Sq, 80), randn(1, 8, off + Sq, 80)
        os_ = flash_attention(qs, ks, vs, causal=True, window=4096,
                              q_offset=off)
        torch.cuda.synchronize()
        os_ref = flash_attention_ref(qs, ks, vs, causal=True, window=4096,
                                     q_offset=off)
        checked[f"swa_d80_{Sq}_q_offset_{off}"] = close(
            f"flash_attention (SWA D 80, {Sq} queries, q_offset {off})",
            os_, os_ref, *TOL_BF16)
        needed.append(atol_needed(os_, os_ref))
        del qs, ks, vs, os_, os_ref
    # llama4's, mixtral's, phi-3's and seamless's shapes, bf16 and float32
    for tag, Bn, Hq, Hkv, Sq, Sk, D, causal, window in NEW_FLASH_SHAPES:
        for dt, tol in ((bf, TOL_BF16), (torch.float32, TOL_STATE)):
            qn = randn(Bn, Hq, Sq, D, dtype=dt)
            kn, vn = randn(Bn, Hkv, Sk, D, dtype=dt), randn(Bn, Hkv, Sk, D,
                                                            dtype=dt)
            kw = dict(causal=causal, window=window)
            on = flash_attention(qn, kn, vn, **kw)
            torch.cuda.synchronize()
            on_ref = flash_attention_ref(qn, kn, vn, **kw)
            key = f"{tag}_{'bf16' if dt == bf else 'f32'}"
            checked[key] = close(f"flash_attention ({key})", on, on_ref,
                                 *tol)
            if dt == bf:
                needed.append(atol_needed(on, on_ref))
            del qn, kn, vn, on, on_ref
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
              "and 4096, and at h2o-danube's SWA q (1,32,Sq,80) over k, v "
              "(1,8,q_offset+Sq,80), window 4096: Sq 5000 at q_offset 0, "
              "Sq 4096 at q_offset 4608 and 8192; and, bf16 and float32, "
              "at llama4's GQA (1,40|8,4096,128) causal, mixtral's "
              "(1,48|8,5000,128) window 4096, phi-3's MHA (1,32,2576,96) "
              "causal, seamless's encoder (2,16,3000,64) and cross "
              "(2,16,500,64) over (2,16,3000,64), not causal")

    # decode (row 2) at the group sizes the main paths run: absorbed MLA
    # (Hq 64 over Hkv 1, Dk 536, Dv 472: the table's row), GQA (32 over 8
    # heads of 128, and of 80) and zamba2's MHA (32 heads of 64), all but
    # MLA read in place through the model's (B, S, Hkv, D) buffers as
    # gqa_decode passes them
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
    # a cross block's decode: seamless's 16 heads of 64 over the 3000
    # encoder rows of both prompts, read in place from the (B, S_enc, Hkv,
    # D) leaves, every row at the full length
    enc = torch.full((2,), 3000, dtype=torch.int32, device=dev)
    qd = randn(2, 16, 64)
    kd, vd = (randn(2, 3000, 16, 64).transpose(1, 2) for _ in range(2))
    shapes["CROSS64"] = _decode_case(
        torch, close, atol_needed, "decode_attention (cross, enc_len 3000)",
        lambda: decode_attention(qd, kd, vd, enc),
        lambda: decode_attention_ref(qd, kd, vd, enc),
        qd, kd, vd, enc, 64 ** -0.5, extra=())
    shapes["CROSS64"]["shape"] = ("q (2,16,64) k, v (2,16,3000,64) bf16 "
                                  "(transposed (B,S_enc,Hkv,D) leaves), "
                                  "lengths 3000 x 2")
    del qd, kd, vd
    # the new groups and the cross decode in float32 (the SIMT core)
    f32 = {}
    cases = [(t, Hq, Hkv, Dk, Dv, sc, lens, S)
             for t, Hq, Hkv, Dk, Dv, sc in NEW_DECODE_GROUPS]
    cases.append(("CROSS64", 16, 16, 64, 64, 64 ** -0.5, enc, 3000))
    for tag, Hq, Hkv, Dk, Dv, scale, ln, Sn in cases:
        qd = randn(ln.shape[0], Hq, Dk, dtype=torch.float32)
        kd = randn(ln.shape[0], Sn, Hkv, Dk, dtype=torch.float32)
        vd = randn(ln.shape[0], Sn, Hkv, Dv, dtype=torch.float32)
        kd, vd = kd.transpose(1, 2), vd.transpose(1, 2)
        od = decode_attention(qd, kd, vd, ln, scale=scale)
        torch.cuda.synchronize()
        f32[tag] = close(f"decode_attention ({tag}, float32)", od,
                         decode_attention_ref(qd, kd, vd, ln, scale=scale),
                         *TOL_STATE)
        del qd, kd, vd, od
    out["decode_attention"] = _decode_entry(
        "src/repro_torch/csrc/decode_attn.cu",
        "src/repro/kernels/decode_attn.py:94", shapes)
    out["decode_attention"]["checked_f32"] = f32

    # delta, masked (row 3): KDA prefill, H = 56, dk = dv = 128, ragged
    # lengths, and kimi's prefill chunk
    out["delta_chunked_fused"] = scan_entry(
        torch, dev, g, close, atol_needed, "delta_chunked_fused",
        "src/repro_torch/csrc/delta.cu", "src/repro/kernels/delta.py:218",
        DELTA_SHAPES, delta_case)

    # quantize (row 4): its table shape, then the main paths' requests
    out["quantize_int8_fused"] = check_quantize(torch, dev, g)

    # gla, masked (row 7): zamba2's Mamba2 prefill, ragged lengths
    out["gla_chunked_fused"] = scan_entry(
        torch, dev, g, close, atol_needed, "gla_chunked_fused",
        "src/repro_torch/csrc/gla.cu", "src/repro/kernels/gla.py:185",
        GLA_SHAPES, gla_case)
    out.update(check_paged_kernels(torch, dev, g, randn, close, atol_needed))
    out.update(check_unmasked_kernels(torch, dev, g, close, atol_needed))
    return out


def check_unmasked_kernels(torch, dev, g, close, atol_needed):
    """Phase 3, rows 5 and 6: the unmasked scans of training, each against
    its plain version with a nonzero initial state.  gla_chunked at
    zamba2's Mamba2 head (H = 32, dk = 64, dv = 128) at its table shape and
    zamba2's 2048-token training microbatch, delta_chunked at row 3's kimi
    KDA shape, so the masked and unmasked delta kernels compare directly,
    and at the KDA:MLA recipe's float32 microbatch."""
    out = {"gla_chunked": scan_entry(
        torch, dev, g, close, atol_needed, "gla_chunked",
        "src/repro_torch/csrc/gla.cu", "src/repro/kernels/gla.py:126",
        GLA_SHAPES, gla_case)}
    out["delta_chunked"] = scan_entry(
        torch, dev, g, close, atol_needed, "delta_chunked",
        "src/repro_torch/csrc/delta.cu", "src/repro/kernels/delta.py:155",
        DELTA_SHAPES, delta_case)
    return out


def check_grads(torch, dev):
    """Phase 3b: each differentiable op on CUDA at the shapes and types the
    training paths give it, against its plain version.  ``zamba2_train``
    runs flash in MHA form (1, 32, 2048, 64) and gla_chunked at (1, 32,
    2048, dk 64 / dv 128) in bf16, and ``zamba2_train_check`` both again in
    float32; ``hybrid_train`` runs flash in MLA form (4, 8, 1024, Dk 96 /
    Dv 64) and delta_chunked at (4, 8, 1024, 64) in float32 (a microbatch
    of four rows); ``train_more`` runs flash at mixtral's (1, 48, 8192,
    128) over 8 KV heads with window 4096 in bf16, whose plain version and
    backward recompute is ``swa_banded``.  The masked instances get the
    same shapes with ragged lengths.

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
    * ``swa_banded``'s gradients, float32, against the quadratic plain
      version's at mixtral's window (1, 12, 8192, 128) over 2 KV heads
      (its 48 / 8 heads cut to fit the quadratic one's (8192, 8192)
      scores), within TOL_GRAD of the largest: ``swa_vs_quadratic``.

    Returns {case: {"fwd_max_abs_err": {dtype: x}, "fwd_atol_needed":
    {dtype: x}, "grad_rel_diff": x}, "swa_vs_quadratic": {...}}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attn import flash_attention_ref
    from repro_torch.models.chunked_attention import swa_banded

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

    # case: (op, float32 inputs, lengths, forward dtypes[, op keywords])
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
        "attention_swa_mixtral": ("attention", (
            randn(1, 48, 8192, 128), randn(1, 8, 8192, 128),
            randn(1, 8, 8192, 128)), None, ("bf16",), {"window": 4096}),
    }
    out = {}
    for name, (op, args, lengths, dtypes, *opkw) in cases.items():
        kw = {} if lengths is None else {"lengths": lengths}
        kw.update(*opkw)
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
    gc_cuda(torch)

    # the banded plain version's gradients against the quadratic one's
    args = (randn(1, 12, 8192, 128), randn(1, 2, 8192, 128),
            randn(1, 2, 8192, 128))
    up = randn(1, 12, 8192, 128)

    def swa_grads(fn):
        xs = [a.detach().clone().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*xs, window=4096), xs, up)

    got = swa_grads(swa_banded)
    want = swa_grads(flash_attention_ref)
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        diff = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and diff <= TOL_GRAD * scale):
            fail(f"swa_banded's gradient differs from the quadratic "
                 f"attention's: {diff:.3e} against {scale:.3e}")
        worst = max(worst, diff / max(scale, 1e-30))
    out["swa_vs_quadratic"] = {"shape": [1, 12, 2, 8192, 128],
                               "window": 4096, "grad_rel_diff": worst}
    del got, want
    gc_cuda(torch)
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
    # llama4's, mixtral's and phi-3's groups in float32 (the SIMT core)
    f32 = {}
    for tag, Hq, Hkv, Dk, Dv, scale in NEW_DECODE_GROUPS:
        kp = randn(Hkv, P, T, Dk, dtype=torch.float32)
        vp = randn(Hkv, P, T, Dv, dtype=torch.float32)
        tables = _paged_tables(torch, dev, g, lens_l, T, N, P)
        q = randn(B, Hq, Dk, dtype=torch.float32)
        o = paged_decode_attention(q, kp, vp, tables, lens, scale=scale)
        torch.cuda.synchronize()
        f32[tag] = close(
            f"paged_decode_attention ({tag}, float32)", o,
            paged_decode_attention_ref(q, kp, vp, tables, lens, scale=scale),
            *TOL_STATE)
        del kp, vp, q, o
    out["paged_decode_attention"] = _decode_entry(
        "src/repro_torch/csrc/paged_decode_attn.cu",
        "src/repro/kernels/paged_decode_attn.py:112", shapes)
    out["paged_decode_attention"]["checked_f32"] = f32

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
    # llama4's prefix-hit suffix chunk: GQA 40 over 8 heads of 128 (G 5)
    # over the 312 pages of its 4992-token prefix, one 1024-token chunk,
    # bf16 and float32
    for dt, tol, tag in ((torch.bfloat16, TOL_BF16, "bf16"),
                         (torch.float32, TOL_STATE, "f32")):
        kl, vl = (randn(8, 1024, T, 128, dtype=dt) for _ in range(2))
        tl = _paged_tables(torch, dev, g, [312 * T], T, 312, 1024)
        ql, ksl, vsl = (randn(1, h, 1024, 128, dtype=dt)
                        for h in (40, 8, 8))
        o = paged_prefill_attention(ql, kl, vl, tl, ksl, vsl)
        torch.cuda.synchronize()
        o_ref = paged_prefill_attention_ref(ql, kl, vl, tl, ksl, vsl)
        checked[f"gqa_g5_llama4_{tag}"] = close(
            f"paged_prefill_attention (llama4 G 5, {tag})", o, o_ref, *tol)
        errs.append(checked[f"gqa_g5_llama4_{tag}"])
        if dt == torch.bfloat16:
            needed.append(atol_needed(o, o_ref))
        del kl, vl, tl, ql, ksl, vsl, o, o_ref
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
              "keys, and at llama4's q (1,40,1024,128) over 312 pages "
              "(pools (8,1024,16,128)) + 1024 suffix keys, bf16 and "
              "float32; SDPA on the gathered cache with K/V repeated to 32 "
              "heads and a boolean mask")
    return out


def main_path(torch, dev, cfg, params, *, paged: bool, session_len=5000,
              lens=None, ext_len=600, threshold=2048, max_bucket=4096):
    """Phase 4: the PrfaaS serving loop, every kernel launch counted from 0:
    prompts of 100-12000 tokens (``lens``, the session's at index 5)
    through both routes (``threshold``; prompts past ``max_bucket``
    chunked) with int8 wire compression, then an ``ext_len``-token later
    turn of the ``session_len``-token session.  The wire must compress,
    unless the model has no attention block (xLSTM): its caches hold no k
    / v / latent leaf, so every leaf ships as it is, as the reference's
    wire does, and the ratio must be 1.  Paged: each region's decode engine runs on pool pages it
    shares with its prefix cache, and the later turn resumes from the
    device pages of its prefix where the architecture allows (page-aligned
    state snapshots for linear mixers, so never on kimi's 5000-token
    prompt, and on zamba2's 4992-token one).  The first offloaded
    request's wire payload, encoded in place from the batch cache, is held
    byte for byte against the plain encode of the same cache
    (:class:`WireWitness`)."""
    import numpy as np

    from repro_torch.configs.base import AttentionSpec
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serving import (CrossDCDeployment, DeploymentConfig,
                                     Request)

    dep = CrossDCDeployment(Model(cfg), params, DeploymentConfig(
        threshold=threshold, pd_clusters=1, wire_compression=True,
        decode_slots=8, capacity=16384, decode_block_size=8,
        min_prefill_bucket=128, max_prefill_bucket=max_bucket,
        paged_kv=paged))
    rng = np.random.default_rng(0)
    if lens is None:
        lens = [100, 700, 1500, 2500, 3800, session_len, 9000, 12000, 300]
    lens = list(lens)
    lens[5] = session_len
    prompts = [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
               for L in lens]
    # a later turn of the session: its prefix is cached
    ext = np.concatenate([prompts[5], rng.integers(
        0, cfg.vocab_size, (ext_len,)).astype(np.int32)])
    batches = [[Request(rid=i, tokens=t, max_new_tokens=16)
                for i, t in enumerate(prompts)],
               [Request(rid=len(prompts), tokens=ext, max_new_tokens=16)]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the reference's warm-ups for the traffic's shapes: every prefill
    # bucket and chunk count, the paged admission and, on each region's
    # decode engine, the capture of its block
    t0 = time.perf_counter()
    warm_lens = lens + [len(ext)]
    dep.prfaas.warmup([1], warm_lens)
    for name in dep.pd_names:
        dep.pd_prefill.warmup([1], warm_lens, decode=dep.decoders[name])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    compiles = {"prefill": dep.pd_prefill.compiles,
                "admit": {n: d.admit_compiles
                          for n, d in dep.decoders.items()}}
    if any(d.block_compiles != 1 for d in dep.decoders.values()):
        fail("a decode engine's block was not captured by its warm-up")
    build.reset_launches()
    t0 = time.perf_counter()
    out = {}
    prefilled = []
    with WireWitness(torch) as witness:
        for batch in batches:
            before = dep.pd_prefill.tokens_prefilled
            out.update(dep.submit_batch(batch))
            prefilled.append(dep.pd_prefill.tokens_prefilled - before)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if witness.result is None:
        fail("no offloaded request was encoded for the wire")

    blocks = {n: d.block_compiles for n, d in dep.decoders.items()}
    if set(blocks.values()) != {1}:
        fail(f"decode blocks captured again during traffic: {blocks}")
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
    has_attn = any(isinstance(b.mixer, AttentionSpec)
                   for g in cfg.groups for b in g.blocks)
    if not (wire_q > 0 and (ratio > 1.0 if has_attn
                            else ratio == 1.0 and wire_q == wire_raw)):
        fail(f"wire bytes {wire_q} (raw {wire_raw}), compression {ratio}")
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
        "chunked": sum(1 for r in reqs if len(r.tokens) > max_bucket),
        "tokens_out": sum(len(out[r.rid].output_tokens) for r in reqs),
        # a digest of every request's tokens, to compare layouts by
        "tokens_sha1": hashlib.sha1(json.dumps(
            {r.rid: out[r.rid].output_tokens for r in reqs},
            sort_keys=True).encode()).hexdigest(),
        "pd_tokens_prefilled": prefilled,
        "wire_raw_bytes": wire_raw, "wire_quantized_bytes": wire_q,
        "wire_compression": ratio,
        "wire_in_situ": witness.result,
        "truncations": m["truncations"],
        # from the warm-ups on: the graphs' pools are reserved, not
        # allocated, once their capture ends
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "warmup_s": warmup_s,
        "block_compiles": blocks,
        "compiles_after_warmup": compiles,
        "compiles_after_traffic": {
            "prefill": dep.pd_prefill.compiles,
            "admit": {n: d.admit_compiles for n, d in dep.decoders.items()}},
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


def compare_logits(torch, dev, cfg, params, gate=True, keep=None, S=1024,
                   extra=None):
    """Phase 5: one bucketed prefill batch of two rows, S and 700 S / 1024
    tokens, through the kernels and through the plain versions (both kept
    in ``keep``, as float32, when given).  ``extra``: the batch's frames
    or patches (an encoder-decoder's, a VLM's)."""
    from repro_torch.models import Model

    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                         device=dev)
    lens = torch.tensor([S, 700 * S // 1024], dtype=torch.int32,
                        device=dev)
    batch = {"tokens": toks, "lengths": lens, **(extra or {})}
    with torch.no_grad():
        got, _ = Model(cfg).prefill(params, batch)
        want, _ = Model(cfg, use_kernels=False).prefill(params, batch)
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
    kw = dict(tables={"seq": torch.as_tensor(dec.table_seq, device=dev),
                      "ring": torch.as_tensor(dec.table_ring, device=dev)},
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
    9), in the decode kernels (both cores of rows 2 and 8, the bf16 core's
    combine included), in the delta kernels (both phases of rows 3 and 5;
    ``delta_kernel`` on a checkout before the two-phase core) and in the
    GLA kernels (the bf16 core's three phases of rows 6 and 7 and the
    float32 ``gla_kernel``, the only one on a checkout before the core)."""
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
    delta = [(ms, c) for n, ms, c in kernels
             if "delta_hopper" in n or "delta_kernel" in n]
    gla = [(ms, c) for n, ms, c in kernels
           if "gla_hopper" in n or "gla_kernel" in n]
    return {"wall_ms": wall_ms, "device_busy_ms_profiled": busy,
            "device_busy_share": busy / wall_ms,
            "flash_ms": sum(ms for ms, _ in flash),
            "flash_launches": sum(c for _, c in flash),
            "flash_share_of_busy": sum(ms for ms, _ in flash) / busy,
            "decode_ms": sum(ms for ms, _ in decode),
            "decode_launches": sum(c for _, c in decode),
            "decode_share_of_busy": sum(ms for ms, _ in decode) / busy,
            "delta_ms": sum(ms for ms, _ in delta),
            "delta_launches": sum(c for _, c in delta),
            "delta_share_of_busy": sum(ms for ms, _ in delta) / busy,
            "gla_ms": sum(ms for ms, _ in gla),
            "gla_launches": sum(c for _, c in gla),
            "gla_share_of_busy": sum(ms for ms, _ in gla) / busy,
            "top_kernels": [{"name": n[:80], "ms": ms, "launches": c}
                            for n, ms, c in top]}


def profile_decode_block(torch, dev, cfg, params):
    """Where a paged decode block's time goes: one block of 8 slots at 4000
    tokens each (``_profiled``), replayed as the engine's CUDA graph and,
    on a second engine of the same admissions, run eagerly
    (``graphs=False``); then the graph of a third engine that samples
    (``SAMPLING``), recorded beside the greedy one (no gate)."""
    import numpy as np

    from repro_torch.core.blockpool import BlockPool
    from repro_torch.models import Model
    from repro_torch.models.paged import zero_request_payload
    from repro_torch.serving import DecodeEngine, Request

    L, slots = 4000, 8
    out = {"slots": slots, "tokens_per_slot": L}
    for tag, graphs, sampling in (("graph", True, {}), ("eager", False, {}),
                                  ("graph_sampled", True, SAMPLING)):
        dec = DecodeEngine(Model(cfg), params, slots, 16384, paged=True,
                           pool=BlockPool(4096, 16), page_tokens=16,
                           graphs=graphs, **sampling)
        payload = zero_request_payload(cfg, L, dev)
        dec.admit_many([(Request(rid=i, tokens=np.zeros((L,), np.int32),
                                 max_new_tokens=64), 0, payload, L)
                        for i in range(slots)])
        del payload
        out["steps"] = dec.block_size
        out[tag] = _profiled(torch, dec.step_block)
        out[tag]["block_compiles"] = dec.block_compiles
        del dec
        gc_cuda(torch)
    out["wall_eager_over_graph"] = (out["eager"]["wall_ms"]
                                    / out["graph"]["wall_ms"])
    g, smp = out["graph"], out["graph_sampled"]
    out["sampled_minus_greedy"] = {
        "wall_ms": smp["wall_ms"] - g["wall_ms"],
        "device_busy_ms": (smp["device_busy_ms_profiled"]
                           - g["device_busy_ms_profiled"])}
    return out


def _replay_prompts(cfg, cap=None):
    """(lengths, right-padded tokens) of eight prompts of 100-2000 tokens
    from a seed (each cut to ``cap`` tokens when given)."""
    import numpy as np
    rng = np.random.default_rng(4)
    lens = rng.integers(100, 2000, 8).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (8, int(lens.max()))
                        ).astype(np.int32)
    if cap is not None:
        lens, toks = np.minimum(lens, cap), toks[:, :cap]
    return lens, toks


def _named_leaves(tree, path=""):
    """[(path, tensor)] of a cache tree, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def prefill_repeatability(torch, dev, cfg, params):
    """Whether a prefill gives the same bits twice on the card: the eight
    prompts of ``check_replay`` prefilled three times in one process (the
    first tokens and each cache leaf, bitwise, against the first run; the
    leaves that moved by name), and the prefill's dropless MoE (the first
    MoE FFN, 4096 rows) three times, then three times under
    ``torch.use_deterministic_algorithms``.  Gated by ``main``: every
    repeat equal (the MoE's combine adds in a fixed order)."""
    import warnings

    import numpy as np

    from repro_torch.models import Model
    from repro_torch.models.layers import apply_moe_dropless
    from repro_torch.serving import PrefillEngine

    lens, toks = _replay_prompts(cfg)
    peng = PrefillEngine(Model(cfg), params, min_bucket=128, max_bucket=4096)
    runs = [peng.prefill(toks, lens)[:2] for _ in range(3)]
    base = _named_leaves(runs[0][1])
    moved = sorted({p for r in runs[1:] for (p, a), (_, b) in
                    zip(base, _named_leaves(r[1])) if not torch.equal(a, b)})
    out = {"first_tokens_equal": [bool(np.array_equal(runs[0][0], r[0]))
                                  for r in runs[1:]],
           "cache_leaves_equal": [
               sum(bool(torch.equal(a, b)) for (_, a), (_, b) in
                   zip(base, _named_leaves(r[1])))
               for r in runs[1:]],
           "cache_leaves": len(base), "cache_leaves_moved": moved}
    del runs, base
    gi, key, spec = next((gi, f"b{bi}", b.ffn)
                         for gi, g in enumerate(cfg.groups)
                         for bi, b in enumerate(g.blocks)
                         if b.ffn.kind == "moe")
    ffn = params["groups"][gi]["stacked"][key]["ffn"]
    p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()})
         for k, v in ffn.items()}
    x = torch.randn((4096, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0)
                    ).to(p["w1"].dtype)
    with torch.no_grad():
        for tag, det in (("moe", False), ("moe_deterministic", True)):
            # warn_only: cuBLAS's own warning (no CUBLAS_WORKSPACE_CONFIG)
            # is not what is measured here
            torch.use_deterministic_algorithms(det, warn_only=True)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    ys = [apply_moe_dropless(p, x, spec) for _ in range(3)]
            finally:
                torch.use_deterministic_algorithms(False)
            out[f"{tag}_repeats_equal"] = [bool(torch.equal(ys[0], y))
                                           for y in ys[1:]]
            out[f"{tag}_max_abs_diff"] = max(
                float((ys[0].float() - y.float()).abs().max())
                for y in ys[1:])
    return out


def check_replay(torch, dev, cfg, params, *, paged: bool,
                 sampled: bool = False, cap=None):
    """The captured block against the eager one on a served path: two
    decode engines (``graphs`` on and off) of 8 slots get the same
    admissions, eight prompts of 100-2000 tokens prefilled once from a
    seed with budgets of 20-27 tokens, and drain them; every token must be
    the same, and each graph engine must capture once (at its
    ``warmup_block``).  ``sampled``: both sample (``SAMPLING``, one seed),
    and four more graph engines take the same admissions: one of the same
    seed (the same tokens), one of another seed (other tokens), one at
    temperature 1 and top-k 1 and one greedy (the same tokens as each
    other).  ``cap``: the prompts cut to that many tokens.  Returns each
    engine's decode wall and the graph's launches a replay."""
    import numpy as np

    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine, PrefillEngine, Request
    from repro_torch.serving.engine import trim_request_cache

    model = Model(cfg)
    lens, toks = _replay_prompts(cfg, cap)
    first, caches, _ = PrefillEngine(model, params, min_bucket=128,
                                     max_bucket=4096).prefill(toks, lens)
    entries = [(Request(rid=i, tokens=toks[i, :L], max_new_tokens=20 + i),
                int(first[i]), trim_request_cache(caches, i, int(L)), int(L))
               for i, L in enumerate(lens)]
    del caches
    engines = {"graph": (True, {}), "eager": (False, {})}
    if sampled:
        smp = dict(SAMPLING, seed=1)
        engines = {"graph": (True, smp), "eager": (False, smp),
                   "graph_same_seed": (True, smp),
                   "graph_other_seed": (True, dict(smp, seed=2)),
                   "graph_top1": (True, dict(temperature=1.0, top_k=1)),
                   "graph_greedy": (True, {})}
    res, outs = {}, {}
    for tag, (graphs, sampling) in engines.items():
        dec = DecodeEngine(model, params, 8, 4096, block_size=8, paged=paged,
                           page_tokens=16, graphs=graphs, **sampling)
        dec.warmup_block()
        if dec.admit_many(entries) != len(entries):
            fail(f"{cfg.name}: replay check admitted too few requests")
        torch.cuda.synchronize()
        blocks = dec.run_until_drained()
        torch.cuda.synchronize()
        outs[tag] = {rid: r.output_tokens for rid, r in dec.outputs.items()}
        res[f"{tag}_decode_wall_s"] = dec.decode_wall_s
        res[f"{tag}_block_compiles"] = dec.block_compiles
        if tag == "graph":
            res["blocks"] = blocks
            res["launches_per_replay"] = dict(dec._graph_launches or {})
        del dec
        gc_cuda(torch)
    for tag, (graphs, _) in engines.items():
        if graphs and res[f"{tag}_block_compiles"] != 1:
            fail(f"{cfg.name}: the {tag} engine's decode block was "
                 f"captured {res[f'{tag}_block_compiles']} times")
    same = sum(outs["graph"][r] == outs["eager"][r] for r in outs["eager"])
    res["requests"], res["requests_identical"] = len(outs["eager"]), same
    what = f"{cfg.name} (paged={paged}, sampled={sampled})"
    if same != len(outs["eager"]) or set(outs["graph"]) != set(outs["eager"]):
        fail(f"{what}: replayed tokens differ from the eager block's on "
             f"{len(outs['eager']) - same} requests")
    if sampled:
        if outs["graph_same_seed"] != outs["graph"]:
            fail(f"{what}: two engines of one seed sampled other tokens")
        if outs["graph_other_seed"] == outs["graph"]:
            fail(f"{what}: another seed sampled the same tokens")
        if outs["graph_top1"] != outs["graph_greedy"]:
            fail(f"{what}: temperature 1, top-k 1 is not the greedy stream")
        res["requests_differing_other_seed"] = sum(
            outs["graph_other_seed"][r] != outs["graph"][r]
            for r in outs["graph"])
    res["tokens"] = sum(len(t) for t in outs["graph"].values())
    # a digest of the graph engine's streams, to compare checkouts by
    res["tokens_sha1"] = hashlib.sha1(json.dumps(
        outs["graph"], sort_keys=True).encode()).hexdigest()
    return res


# speculative decode in the spec phases: two n-gram drafts a round
SPEC = dict(spec_k=2, spec_ngram=1)


def _spec_prompts(cfg, long_prompt: int = 0, cap=None):
    """(lengths, right-padded tokens) of the eight ``_replay_prompts`` and
    a ninth of a 16-token phrase repeated to 1024 tokens, on which the
    drafter's guesses can land (all nine cut to ``cap`` tokens when
    given); ``long_prompt``: a tenth of that many tokens, the phrase
    repeated after a random head (a sliding window's ring wraps on it)."""
    import numpy as np
    lens, toks = _replay_prompts(cfg, cap)
    rng = np.random.default_rng(5)
    phrase = rng.integers(0, cfg.vocab_size, 16)
    n = 10 if long_prompt else 9
    rep = min(1024, cap or 1024)
    rows = np.zeros((n, max(toks.shape[1], long_prompt, rep)), np.int32)
    rows[:8, :toks.shape[1]] = toks
    rows[8, :rep] = np.resize(phrase, rep)
    lens = np.append(lens, rep)
    if long_prompt:
        head = long_prompt - 512
        rows[9, :head] = rng.integers(0, cfg.vocab_size, head)
        rows[9, head:long_prompt] = np.resize(phrase, 512)
        lens = np.append(lens, long_prompt)
    return lens.astype(np.int32), rows


def check_spec(torch, dev, cfg, params, *, launches=None, eager=True,
               gate_identity=(), profile=(), layouts=(False, True),
               long_prompt=0, cap=None):
    """Speculative decode on a model's dense and paged served paths
    (``layouts``; False: dense, True: paged): the nine ``_spec_prompts``
    (ten with ``long_prompt``), prefilled once (budgets 16-25 tokens), are
    admitted, for each layout, into a plain graph engine, a speculative
    graph engine and (``eager``) a speculative eager one (``SPEC``,
    ``graphs=False``), each of a slot a prompt, warmed (its capture) and
    drained.
    Gated: the speculative replay emits the eager block's tokens; each
    graph engine captures once; ``verify_rounds > 0`` and
    ``accepted_tokens >= verify_rounds``; the paged pool conserves its
    pages; the speculative graph launches the layout's decode kernel, its
    launches counted from 0 (added to ``launches``; a model without
    attention, xLSTM, has no decode kernel and must launch none).
    ``cap``: the eight prompts cut to that many tokens.  The count of
    requests whose speculative tokens equal the plain greedy ones, and
    each other one's first divergence, are recorded; on the layouts in
    ``gate_identity`` every request's must (the decode cores are
    batch-invariant, so a scan verify runs the plain step's bits).
    ``profile``: the layouts (False: dense, True: paged) whose graph
    engines run their first block under ``_profiled_once`` (busy ms per
    emitted token; its wall is left out of ``decode_wall_s``).  Returns
    {"dense": summary, "paged": summary}."""
    import numpy as np

    from repro_torch.configs.base import AttentionSpec
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine, PrefillEngine, Request
    from repro_torch.serving.engine import trim_request_cache

    model = Model(cfg)
    kernel_free = not any(isinstance(b.mixer, AttentionSpec)
                          for g in cfg.groups for b in g.blocks)
    lens, toks = _spec_prompts(cfg, long_prompt, cap)
    capacity = max(2304, -(-(long_prompt + 64) // 256) * 256)
    first, caches, _ = PrefillEngine(model, params, min_bucket=128,
                                     max_bucket=4096).prefill(toks, lens)
    entries = [(Request(rid=i, tokens=toks[i, :L], max_new_tokens=16 + i),
                int(first[i]), trim_request_cache(caches, i, int(L)), int(L))
               for i, L in enumerate(lens)]
    del caches
    engines = {"plain": (True, {}), "spec": (True, SPEC)}
    if eager:
        engines["spec_eager"] = (False, SPEC)
    out = {}
    for paged in layouts:
        t0 = time.perf_counter()
        kernel = "paged_decode_attention" if paged else "decode_attention"
        what = f"{cfg.name} {cfg.dtype} (paged={paged}) speculative"
        res, outs = {}, {}
        for tag, (graphs, spec) in engines.items():
            dec = DecodeEngine(model, params, len(entries), capacity,
                               block_size=8, paged=paged, page_tokens=16,
                               graphs=graphs, **spec)
            torch.cuda.synchronize()
            if tag == "spec":
                build.reset_launches()
            dec.warmup_block()
            if dec.admit_many(entries) != len(entries):
                fail(f"{what}: admitted too few requests")
            prof_wall = 0.0
            if paged in profile and graphs:
                n0, w0 = dec.tokens_out, dec.decode_wall_s
                pr = _profiled_once(torch, dec.step_block)
                n = dec.tokens_out - n0
                prof_wall = dec.decode_wall_s - w0
                res[f"{tag}_block_profile"] = {
                    **pr, "tokens": n,
                    "busy_ms_per_token": pr["device_busy_ms"] / n}
            dec.run_until_drained()
            torch.cuda.synchronize()
            if tag == "spec":
                counts = dict(build.LAUNCHES)
                res["spec_launches"] = counts
                if kernel_free and counts:
                    fail(f"{what}: kernels {counts} launched by a decode "
                         "step that has none")
                if not kernel_free and counts.get(kernel, 0) <= 0:
                    fail(f"{what}: {kernel} was not launched")
                if launches is not None:
                    for name, c in counts.items():
                        launches[name] = launches.get(name, 0) + c
            outs[tag] = {rid: r.output_tokens
                         for rid, r in dec.outputs.items()}
            res[f"{tag}_decode_wall_s"] = dec.decode_wall_s - prof_wall
            res[f"{tag}_tokens_out"] = dec.tokens_out
            if graphs:
                caps = dec.spec_compiles if spec else dec.block_compiles
                if caps != 1:
                    fail(f"{what}: the {tag} engine captured {caps} times")
                res[f"{tag}_launches_per_replay"] = dict(
                    dec._graph_launches or {})
            if spec:
                if not (dec.verify_rounds > 0
                        and dec.accepted_tokens >= dec.verify_rounds):
                    fail(f"{what}: {dec.verify_rounds} rounds, "
                         f"{dec.accepted_tokens} tokens accepted")
                res[f"{tag}_verify_rounds"] = dec.verify_rounds
                res[f"{tag}_accepted_tokens"] = dec.accepted_tokens
                res[f"{tag}_accepted_tokens_per_dispatch"] = \
                    dec.accepted_tokens_per_dispatch
            if paged:
                s = dec.pool.stats
                if s["allocated"] != (s["freed"] + s["evicted"]
                                      + dec.pool.resident):
                    fail(f"{what}: pool pages not conserved: {s}")
                res[f"{tag}_pool"] = {**s, "resident": dec.pool.resident}
            del dec
            gc_cuda(torch)
        if eager and outs["spec"] != outs["spec_eager"]:
            bad = [r for r in outs["spec"]
                   if outs["spec"][r] != outs["spec_eager"][r]]
            fail(f"{what}: replayed tokens differ from the eager block's on "
                 f"requests {bad}")
        same, first_div = 0, {}
        for rid, want in outs["plain"].items():
            got = outs["spec"][rid]
            if got == want:
                same += 1
            else:
                first_div[rid] = next(
                    (i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    min(len(got), len(want)))
        res["requests"] = len(outs["plain"])
        res["requests_identical_to_plain"] = same
        res["first_divergence"] = first_div
        res["identity_gated"] = paged in gate_identity
        if paged in gate_identity and same != len(outs["plain"]):
            fail(f"{what}: speculative tokens differ from the plain greedy "
                 f"ones (request: first differing index) {first_div}")
        res["decode_wall_s_per_token"] = {
            t: res[f"{t}_decode_wall_s"] / res[f"{t}_tokens_out"]
            for t in ("plain", "spec")}
        res["wall_s"] = time.perf_counter() - t0
        out["paged" if paged else "dense"] = res
        print(f"spec {cfg.name} {cfg.dtype} paged={paged}: "
              f"{res['wall_s']:.1f} s, identical "
              f"{same}/{len(outs['plain'])}, accepted/round "
              f"{res['spec_accepted_tokens_per_dispatch']:.4f}, decode s "
              f"plain {res['plain_decode_wall_s']:.3f} spec "
              f"{res['spec_decode_wall_s']:.3f}", flush=True)
    return out


def decode_batch_variance(torch, dev):
    """That a row's decode output does not depend on the other rows'
    lengths: the decode kernels (rows 2 and 8) on eight rows, then again
    with row 1's length moved to each of 0, 17, 700 more and the full
    4096; every other row's output compared bit for bit.  bf16, dense and
    paged (pages of 16, a permuted table), at every group size the Hopper
    core serves: mistral-nemo's GQA (G 4, the stream), h2o-danube's (G 4
    at head dim 80), qwen2.5's (G 8, the stream's 8-head instance),
    llama4's and mixtral's (G 5 and 6, the same instance with idle heads),
    granite's MQA (G 48, one 64-row tensor-core tile), kimi's absorbed MLA
    (G 64), zamba2's MHA (G 1) and phi-3's at head dim 96; float32 at the
    GQA shape (the SIMT core).  Gated: no row may move."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(11)
    S, T = 4096, 16
    base = [3000, 1200, 2600, 900, 4000, 150, 3300, 2048]
    out = {}
    for tag, dtype, Hq, Hkv, Dk, Dv in (
            ("gqa_bf16", torch.bfloat16, 32, 8, 128, 128),
            ("gqa_d80_bf16", torch.bfloat16, 32, 8, 80, 80),
            ("g8_bf16", torch.bfloat16, 16, 2, 128, 128),
            ("g5_bf16", torch.bfloat16, 40, 8, 128, 128),
            ("g6_bf16", torch.bfloat16, 48, 8, 128, 128),
            ("mha_d96_bf16", torch.bfloat16, 32, 32, 96, 96),
            ("mqa_g48_bf16", torch.bfloat16, 48, 1, 128, 128),
            ("mla_bf16", torch.bfloat16, 64, 1, 536, 472),
            ("mha_bf16", torch.bfloat16, 32, 32, 64, 64),
            ("gqa_f32", torch.float32, 32, 8, 128, 128)):
        q = torch.randn((8, Hq, Dk), generator=g, device=dev).to(dtype)
        k = torch.randn((8, Hkv, S, Dk), generator=g, device=dev).to(dtype)
        v = torch.randn((8, Hkv, S, Dv), generator=g, device=dev).to(dtype)
        layouts = {"dense": lambda n: ops.decode_attention(q, k, v, n)}
        if dtype == torch.bfloat16:
            N = S // T
            perm = torch.randperm(8 * N, generator=torch.Generator()
                                  .manual_seed(3)).to(dev)
            tables = perm.reshape(8, N).to(torch.int32)
            kp = torch.empty((Hkv, 8 * N + 1, T, Dk), dtype=dtype, device=dev)
            vp = torch.empty((Hkv, 8 * N + 1, T, Dv), dtype=dtype, device=dev)
            kp[:, perm] = k.reshape(8, Hkv, N, T, Dk).transpose(0, 1) \
                .reshape(Hkv, 8 * N, T, Dk)
            vp[:, perm] = v.reshape(8, Hkv, N, T, Dv).transpose(0, 1) \
                .reshape(Hkv, 8 * N, T, Dv)
            layouts["paged"] = lambda n: ops.paged_decode_attention(
                q, kp, vp, tables, n)
        for layout, run in layouts.items():
            lens = torch.tensor(base, dtype=torch.int32, device=dev)
            a = run(lens)
            moved, diff = {}, 0.0
            for L in (0, 17, base[1] + 700, S):
                lens2 = lens.clone()
                lens2[1] = L
                b = run(lens2)
                torch.cuda.synchronize()
                rows = [i for i in range(8)
                        if i != 1 and not torch.equal(a[i], b[i])]
                if rows:
                    moved[L] = rows
                diff = max(diff, float((a.float() - b.float())[
                    [i for i in range(8) if i != 1]].abs().max()))
            out[f"{tag}_{layout}"] = {"rows_moved_by_row1_length": moved,
                                      "max_abs_diff_other_rows": diff}
    bad = {t: r for t, r in out.items() if r["rows_moved_by_row1_length"]}
    if bad:
        fail(f"decode rows moved with another row's length: {bad}")
    return out


def check_verify(torch, dev):
    """The verify attention on the card (``ops.verify_attention``: three
    calls of the decode kernel) against its one-pass plain version at
    mistral-nemo's GQA shape, bf16: B 8, Hq 32, Hkv 8, Q 3, D 128, S 4096,
    ragged lengths; gated at ``TOL_BF16``, timed beside the plain pass."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attn import verify_attention_ref

    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    q = torch.randn((8, 32, 3, 128), generator=g, device=dev).to(bf)
    k = torch.randn((8, 8, 4096, 128), generator=g, device=dev).to(bf)
    v = torch.randn((8, 8, 4096, 128), generator=g, device=dev).to(bf)
    lens = torch.tensor([4096, 3001, 2500, 1800, 1024, 700, 97, 4094],
                        dtype=torch.int32, device=dev)
    got = ops.verify_attention(q, k, v, lens)
    want = verify_attention_ref(q, k, v, lens)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=TOL_BF16[0],
                          rtol=TOL_BF16[1]):
        fail(f"verify_attention disagrees with its plain version: max abs "
             f"error {err:.3e}")
    return {"max_abs_err": err,
            "ms": _ms(lambda: ops.verify_attention(q, k, v, lens), 20),
            "plain_ms": _ms(lambda: verify_attention_ref(q, k, v, lens), 5)}


def gemm_rows_probe(torch, dev):
    """Whether a bf16 product's first 9 rows keep their bits when it runs
    over 27 (mistral-nemo dense's one-pass verify runs its products over
    B x 3 rows where a plain step's run over B) at mistral-nemo's
    projection and FFN shapes: {"din x dout": bool}.  Not called by
    ``main``; the one run behind PERF.md's answer is in the verify
    skill's notes."""
    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    gemm_rows = {}
    for din, dout in ((5120, 4096), (5120, 1024), (5120, 14336),
                      (14336, 5120), (4096, 5120)):
        x = torch.randn((27, din), generator=g, device=dev).to(bf)
        w = (torch.randn((din, dout), generator=g, device=dev)
             * din ** -0.5).to(bf)
        gemm_rows[f"{din}x{dout}"] = bool(torch.equal((x @ w)[:9],
                                                      x[:9] @ w))
    return gemm_rows


def calibration(torch, dev):
    """Phase 3b: the measured calibration of this card
    (``repro_torch.analysis.calibrate.sweep`` in bf16: a matmul and a
    streaming probe, then causal flash attention through the hand-written
    kernel plus the FFN's two products at prefill lengths 256-4096), the
    fit, written to ``build/calibration_h100.json`` for the launcher
    phase.  Fails if a measured peak is above the data sheet's by more
    than ``TOL_PEAK``, an MFU lies outside (0, 1] or the flash kernel was
    not launched."""
    from repro_torch.analysis import calibrate
    from repro_torch.kernels import build

    path = ROOT / "build" / "calibration_h100.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    build.reset_launches()
    t0 = time.perf_counter()
    out = calibrate.sweep(str(path), dev, torch.bfloat16)
    wall = time.perf_counter() - t0
    flash = build.LAUNCHES.get("flash_attention", 0)
    m, cal = out["machine"], out["calibration"]
    print(f"calibration: peak {m['peak_flops'] / 1e12:.1f} TFLOP/s (matmul "
          f"probe {m['matmul_probe_flops'] / 1e12:.1f}), "
          f"{m['mem_bw'] / 1e12:.3f} TB/s; fit mfu_max "
          f"{cal['mfu_max']:.4f}, l_half {cal['l_half']:.1f}", flush=True)
    for p in out["points"]:
        print(f"calibration l={p['l']}: attention {p['attn_us']:.1f} us "
              f"(eager {p['attn_eager_us']:.1f}), FFN {p['ffn_us']:.1f} us "
              f"(eager {p['ffn_eager_us']:.1f}), "
              f"{p['achieved_flops'] / 1e12:.1f} TFLOP/s, mfu "
              f"{p['mfu']:.4f}", flush=True)
    if m["peak_flops"] > TOL_PEAK * BF16_FLOP_S:
        fail(f"calibration: peak {m['peak_flops']:.4g} FLOP/s is above "
             f"{TOL_PEAK} x {BF16_FLOP_S:.4g}")
    if m["mem_bw"] > TOL_PEAK * HBM_BYTES_S:
        fail(f"calibration: {m['mem_bw']:.4g} B/s is above {TOL_PEAK} x "
             f"{HBM_BYTES_S:.4g}")
    bad = [p["l"] for p in out["points"] if not 0.0 < p["mfu"] <= 1.0]
    if bad:
        fail(f"calibration: MFU outside (0, 1] at lengths {bad}")
    if flash <= 0:
        fail("calibration: the flash kernel was not launched")
    return {"path": str(path.relative_to(ROOT)), "machine": m,
            "points": out["points"],
            "fit": {"mfu_max": cal["mfu_max"], "l_half": cal["l_half"]},
            "flash_launches": flash, "wall_s": wall}


def launcher(torch, dev, calibration_path):
    """Phase 5b: the serving launcher end to end, in-process
    (``repro_torch.launch.serve.run_serve`` with ``LAUNCHER_ARGS``, the
    calibration of phase 3b and sampled decode), every kernel launch
    counted from 0.  With frozen thresholds: every request answered with
    its tokens, both routes taken, the simulator replay agreeing on every
    route and no threshold moved on either side, and flash, decode, masked
    GLA and quantize launched.  Then once more with live congestion
    feedback, its agreement recorded (no gate: the reference expects >=
    0.9 there, and it follows wall times).  Then greedy and speculative
    (``--spec-k 2 --spec-ngram 1``), frozen: the same gates, and the
    replay's ``spec_accept_rate`` the live acceptance less 1.  Returns the
    three summaries and the frozen runs' launches."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    out, launches = {}, {}
    # the greedy speculative run drops the sampling arguments (the last four)
    greedy_spec = list(LAUNCHER_ARGS[:-4]) + ["--spec-k", str(SPEC["spec_k"]),
                                              "--spec-ngram",
                                              str(SPEC["spec_ngram"])]
    for tag, frozen, base in (("launcher_frozen", True, LAUNCHER_ARGS),
                              ("launcher_live", False, LAUNCHER_ARGS),
                              ("launcher_spec", True, greedy_spec)):
        argv = list(base) + ["--calibration", str(calibration_path)]
        if frozen:
            argv.append("--freeze-thresholds")
        args = serve.build_parser().parse_args(argv)
        build.reset_launches()
        t0 = time.perf_counter()
        rep = serve.run_serve(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        cv, reqs, outs = (rep["cross_validate"], rep["_requests"],
                          rep["_outputs"])
        routes = {}
        for r in reqs:
            routes[r.route] = routes.get(r.route, 0) + 1
        summary = {"argv": argv, "wall_s": wall, "routes": routes,
                   "route_agreement": cv["route_agreement"],
                   "mismatches": cv["mismatches"],
                   "thresholds": cv["thresholds"], "ttft": cv["ttft"],
                   "egress_bytes": cv["egress_bytes"],
                   "kv_wire_compression": cv["kv_wire_compression"],
                   "tokens_out": sum(len(o.output_tokens)
                                     for o in outs.values()),
                   "truncations": rep["deployment"]["truncations"],
                   "accepted_tokens_per_dispatch":
                       rep["deployment"]["accepted_tokens_per_dispatch"],
                   "spec_accept_rate": cv["spec_accept_rate"],
                   "launches": counts}
        out[tag] = summary
        print(f"{tag}: {wall:.1f} s, routes {routes}, agreement "
              f"{cv['route_agreement']}, launches {counts}", flush=True)
        if frozen:
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            for r in reqs:
                o = outs.get(r.rid)
                if o is None or len(o.output_tokens) != 1 + r.max_new_tokens:
                    fail(f"launcher: request {r.rid} not answered with its "
                         f"{1 + r.max_new_tokens} tokens")
            if len(routes) < 2 or "prfaas" not in routes:
                fail(f"launcher: both routes must be taken, got {routes}")
            if cv["route_agreement"] != 1.0 or cv["mismatches"]:
                fail(f"launcher: the simulator replay disagrees on "
                     f"{cv['mismatches']}")
            for side, th in cv["thresholds"].items():
                if set(th.values()) != {float(args.threshold)}:
                    fail(f"launcher: {side} thresholds moved: {th}")
            require_launched(counts, ("flash_attention", "decode_attention",
                                      "gla_chunked_fused",
                                      "quantize_int8_fused"), tag)
        if base is greedy_spec:
            apd = rep["deployment"]["accepted_tokens_per_dispatch"]
            if cv["spec_accept_rate"] != apd - 1.0:
                fail(f"launcher: the replay's spec_accept_rate "
                     f"{cv['spec_accept_rate']} is not the live acceptance "
                     f"{apd} - 1")
        del rep, reqs, outs
        gc_cuda(torch)
    return out, launches


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


def depth_cut(cfg, repeats: int):
    """``cfg`` (one group of repeated blocks) at every published width,
    its group repeated ``repeats`` times."""
    (g,) = cfg.groups
    return dataclasses.replace(cfg, groups=(dataclasses.replace(
        g, repeats=repeats),))


def llama4_config(layers: int = 8):
    """llama4-scout-17b-a16e at every published width (d_model 5120, GQA
    40 / 8 heads of 128, all 16 experts of d_ff 8192 top-1 plus the shared
    one, vocab 202048), ``layers`` of its 48 layers: 8 are 19.7 B params,
    ~39.4 GB in bf16 (the whole model, 109 B, is ~218 GB)."""
    from repro_torch.configs import get_config
    return depth_cut(get_config("llama4-scout-17b-a16e"), layers)


def mixtral_config(layers: int = 8):
    """mixtral-8x22b at every published width (d_model 6144, GQA 48 / 8
    heads of 128, window 4096, all 8 experts of d_ff 16384 top-2, vocab
    32768), ``layers`` of its 56 layers: 8 are 20.4 B params, ~40.9 GB in
    bf16 (the whole model, 141 B, is ~282 GB)."""
    from repro_torch.configs import get_config
    return depth_cut(get_config("mixtral-8x22b"), layers)


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
        paths[f"{tag}_replay"] = check_replay(torch, dev, cfg, params,
                                              paged=paged)
        print(f"{tag}_replay: {paths[f'{tag}_replay']}", flush=True)
    for layout, res in check_spec(torch, dev, cfg, params, launches=launches,
                                  gate_identity=(False, True)).items():
        paths[f"zamba2_{layout}_spec"] = res
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


def danube_paths(torch, dev, paths, launches):
    """h2o-danube-1.8b at full width, ``DANUBE_LAYERS`` of its 24
    sliding-window GQA layers (window 4096, head dim 80), dense and then
    paged, with the
    page-aligned 4992-token session past the window: on the paged path its
    later turn resumes from the ring snapshot and prefills only its
    600-token suffix.  Then the replay checks (greedy and sampled),
    speculative decode with a tenth prompt of 4600 tokens, so the rings
    wrap and roll back (bf16 tokens gated equal to the plain greedy ones),
    and the logit checks over a 5000-token prefill and a paged decode
    step: bf16 recorded, the 2 % gate held in float32."""
    from repro_torch.configs import get_config

    cfg = depth_cut(get_config("h2o-danube-1.8b"), DANUBE_LAYERS)
    params = load_params(torch, dev, cfg, 3)
    for tag, paged, need in (
            ("danube_dense", False, ("flash_attention", "decode_attention",
                                     "quantize_int8_fused")),
            ("danube_paged", True, ("flash_attention",
                                    "paged_decode_attention",
                                    "quantize_int8_fused"))):
        summary, counts, dep = main_path(torch, dev, cfg, params,
                                         paged=paged, session_len=4992)
        del dep
        require_launched(counts, need, tag)
        if paged:
            pin = summary["device_pin_cached_len"]
            if pin != 4992:
                fail(f"the later turn on danube pinned {pin} cached tokens, "
                     "not its 4992-token ring snapshot")
            if summary["pd_tokens_prefilled"][-1] != 600:
                fail(f"the later turn on danube prefilled "
                     f"{summary['pd_tokens_prefilled'][-1]} tokens, not its "
                     "600-token suffix")
        paths[tag] = summary
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"{tag}: {summary['wall_s']:.2f} s wall, launches {counts}",
              flush=True)
        for sampled in (False, True):
            key = f"{tag}_replay" + ("_sampled" if sampled else "")
            paths[key] = check_replay(torch, dev, cfg, params, paged=paged,
                                      sampled=sampled)
            print(f"{key}: {paths[key]}", flush=True)
        gc_cuda(torch)
    for layout, res in check_spec(torch, dev, cfg, params, launches=launches,
                                  gate_identity=(False, True),
                                  long_prompt=4600).items():
        paths[f"danube_{layout}_spec"] = res
    gc_cuda(torch)
    paths["danube_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                 gate=False, S=5000)
    paths["danube_paged_step_bf16"] = compare_paged_step(torch, dev, cfg,
                                                         params, gate=False)
    cfg, params = to_float32(cfg, params)
    torch.cuda.empty_cache()
    paths["danube_logits_f32"] = compare_logits(torch, dev, cfg, params,
                                                S=5000)
    paths["danube_paged_step_f32"] = compare_paged_step(torch, dev, cfg,
                                                        params)


def moe_paths(torch, dev, paths, launches, tag, cfg, seed):
    """A MoE family on its card cut (``llama4_config`` / ``mixtral_config``,
    bf16), served as ``danube_paths`` serves h2o-danube: the PrfaaS loop
    dense then paged (``main_path``), each path's replay checks (greedy and
    sampled), a profiled paged decode block (8 slots at 4000 tokens, as
    kimi's), speculative decode on both layouts (the scan verify: a MoE
    FFN takes no one-pass verify, so bf16 tokens are gated equal to the
    plain greedy ones), and the logit checks in bf16, recorded.

    Full GQA (llama4): the paged later turn resumes from the device pages
    of its 5000-token session's page-aligned prefix and prefills only the
    rest through the paged-prefill kernel, as mistral-nemo's.  A sliding
    window (mixtral): the 4992-token session passes the window; its paged
    later turn resumes from the ring snapshot and prefills only its
    600-token suffix, and ``check_spec`` adds a 4600-token prompt whose
    rings wrap and roll back.

    The 2 % float32 gates of ``compare_logits`` and ``compare_paged_step``
    would need ~79-82 GB in float32 at 8 layers; they run, after the bf16
    tree is freed, on a further cut of 2 layers at the same widths with
    every expert (~26 GB for llama4, ~22 GB for mixtral in float32)."""
    from repro_torch.models.attention import is_ring

    ring = is_ring(cfg.groups[0].blocks[0].mixer)
    session = 4992 if ring else 5000
    S = 5000 if ring else 1024
    params = load_params(torch, dev, cfg, seed)
    for layout, paged, need in (
            ("dense", False, ("flash_attention", "decode_attention",
                              "quantize_int8_fused")),
            ("paged", True, ("flash_attention", "paged_decode_attention",
                             "quantize_int8_fused")
             + (() if ring else ("paged_prefill_attention",)))):
        name = f"{tag}_{layout}"
        summary, counts, dep = main_path(torch, dev, cfg, params,
                                         paged=paged, session_len=session)
        del dep
        require_launched(counts, need, name)
        if paged:
            ext = summary["prompt_tokens"][-1]
            pin = summary["device_pin_cached_len"]
            if ring and pin != 4992:
                fail(f"the later turn on {cfg.name} pinned {pin} cached "
                     "tokens, not its 4992-token ring snapshot")
            if not pin > 0:
                fail(f"the later turn on {cfg.name} found no device prefix")
            if summary["pd_tokens_prefilled"][-1] != ext - pin:
                fail(f"the later turn on {cfg.name} prefilled "
                     f"{summary['pd_tokens_prefilled'][-1]} tokens, not its "
                     f"{ext - pin}-token suffix")
        paths[name] = summary
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        print(f"{name}: {summary['wall_s']:.2f} s wall, peak "
              f"{summary['peak_memory_gb']:.1f} GB, launches {counts}",
              flush=True)
        for sampled in (False, True):
            key = f"{name}_replay" + ("_sampled" if sampled else "")
            paths[key] = check_replay(torch, dev, cfg, params, paged=paged,
                                      sampled=sampled)
            print(f"{key}: {paths[key]}", flush=True)
        gc_cuda(torch)
    block = profile_decode_block(torch, dev, cfg, params)
    paths[f"{tag}_decode_profile"] = block
    print(f"{tag}_decode_profile: graph wall / busy "
          f"{block['graph']['wall_ms']:.1f} / "
          f"{block['graph']['device_busy_ms_profiled']:.1f} ms", flush=True)
    for layout, res in check_spec(torch, dev, cfg, params, launches=launches,
                                  gate_identity=(False, True),
                                  long_prompt=4600 if ring else 0).items():
        paths[f"{tag}_{layout}_spec"] = res
    gc_cuda(torch)
    paths[f"{tag}_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                 gate=False, S=S)
    paths[f"{tag}_paged_step_bf16"] = compare_paged_step(
        torch, dev, cfg, params, gate=False)
    del params
    gc_cuda(torch)
    cut = dataclasses.replace(depth_cut(cfg, 2), dtype="float32")
    params = load_params(torch, dev, cut, seed)
    paths[f"{tag}_logits_f32_2_layers"] = compare_logits(torch, dev, cut,
                                                         params, S=S)
    paths[f"{tag}_paged_step_f32_2_layers"] = compare_paged_step(
        torch, dev, cut, params)
    del params
    gc_cuda(torch)


def decode_from_prefill(torch, dev, cfg, params, S, extra):
    """The PrfaaS invariant of the reference's smoke test
    (``tests/test_models_smoke.py::test_decode_matches_prefill``), through
    the kernels: two rows of S tokens (after ``extra``'s frames or
    patches) prefilled whole, and again without their last token, whose
    cache, placed for decode, decodes that token.  Returns the largest
    difference of the two log-softmaxes (the reference gates it at
    5e-4)."""
    from repro_torch.models import Model, prepare_decode_caches

    g = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g, device=dev)
    model = Model(cfg)
    total0 = S - 1 + cfg.num_image_patches
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks, **extra})
        _, caches = model.prefill(params, {"tokens": toks[:, :-1], **extra})
        dc = prepare_decode_caches(cfg, caches, total0 + 8)
        del caches
        got, _ = model.decode_step(params, toks[:, -1], dc, torch.full(
            (2,), total0, dtype=torch.int32, device=dev))
    if not (torch.isfinite(full).all() and torch.isfinite(got).all()):
        fail(f"{cfg.name}: non-finite logits in the decode-from-prefill "
             "check")
    return float((torch.log_softmax(full, -1)
                  - torch.log_softmax(got, -1)).abs().max())


def encdec_vlm_run(torch, dev, cfg, params, lens, extra, steps=16):
    """The encoder-decoder's and the VLM's whole surface, as the
    reference's (no engine takes them): one prefill of two right-padded
    rows of ``lens`` tokens (after ``extra``'s frames or patches) through
    ``Model.prefill``, its caches placed by ``prepare_decode_caches``,
    then ``steps`` greedy ``Model.decode_step``s, every kernel launch
    counted from 0.  Returns (summary, launches)."""
    from repro_torch.kernels import build
    from repro_torch.models import Model, prepare_decode_caches

    g = torch.Generator(device=dev).manual_seed(7)
    S, P = max(lens), cfg.num_image_patches
    toks = torch.randint(0, cfg.vocab_size, (len(lens), S), generator=g,
                         device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks, "lengths": ln,
                                                **extra})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dc = prepare_decode_caches(cfg, caches, -(-(S + P + steps) // 256)
                                   * 256)
        del caches
        tok, out = logits.argmax(-1), []
        for i in range(steps):
            out.append(tok)
            lg, dc = model.decode_step(params, tok, dc, ln + P + i)
            tok = lg.argmax(-1)
        out.append(tok)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    toks_out = torch.stack(out, 1).cpu()
    if not (torch.isfinite(lg).all() and toks_out.min() >= 0
            and toks_out.max() < cfg.vocab_size):
        fail(f"{cfg.name}: non-finite logits or out-of-vocabulary tokens")
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "encoder_layers": sum(g.repeats * len(g.blocks)
                                  for g in cfg.encoder_groups or ()),
            "lengths": list(lens), "prefix": P,
            "frames": (list(extra["frames"].shape) if "frames" in extra
                       else None),
            "prefill_s": t1 - t0, "decode_steps": steps,
            "decode_s": t2 - t1, "decode_ms_per_step": (t2 - t1) / steps
            * 1e3, "tokens_sha1": hashlib.sha1(
                toks_out.numpy().tobytes()).hexdigest(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}, launches


def encdec_vlm_paths(torch, dev, paths, launches):
    """seamless-m4t-medium (12 + 12 layers, d_model 1024, 16 heads of 64,
    vocab 256206; ~0.88 B params) and phi-3-vision-4.2b (32 layers, d_model
    3072, 32 heads of 96; ~3.8 B params) at full width and depth, random
    bf16 weights from a seed, through ``Model.prefill`` and
    ``Model.decode_step`` (``encdec_vlm_run``): seamless over 3000 frames
    and 500 / 350 decoder tokens (the flash kernel in the bidirectional
    encoder and in the cross blocks, Sq != Sk; the decode kernel on the
    self caches and over the fixed encoder length), phi-3 over 576 patches
    and 2000 / 1400 tokens (head dim 96).  Then the decode-from-prefill
    invariant (``decode_from_prefill``) and the kernels-vs-plain logits
    (``compare_logits``): bf16 recorded; after the conversion to float32
    the invariant gated at 5e-4 and the logits at 2 %."""
    from repro_torch.configs import get_config

    for tag, arch, seed, lens, S, make in (
            ("seamless", "seamless-m4t-medium", 5, (500, 350), 500,
             lambda cfg, g: {"frames": torch.randn(
                 (2, 3000, cfg.encoder_input_dim), generator=g,
                 device=dev)}),
            ("phi3", "phi-3-vision-4.2b", 6, (2000, 1400), 2000,
             lambda cfg, g: {"patches": torch.randn(
                 (2, cfg.num_image_patches, cfg.d_model), generator=g,
                 device=dev)})):
        cfg = get_config(arch)
        params = load_params(torch, dev, cfg, seed)
        extra = make(cfg, torch.Generator(device=dev).manual_seed(seed))
        summary, counts = encdec_vlm_run(torch, dev, cfg, params, lens, extra)
        require_launched(counts, ("flash_attention", "decode_attention"),
                         tag)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        print(f"{tag}: prefill {summary['prefill_s']:.2f} s, "
              f"{summary['decode_ms_per_step']:.1f} ms a decode step, peak "
              f"{summary['peak_memory_gb']:.1f} GB, launches {counts}",
              flush=True)
        summary["decode_from_prefill_bf16"] = decode_from_prefill(
            torch, dev, cfg, params, S, extra)
        summary["logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                gate=False, S=S, extra=extra)
        cfg, params = to_float32(cfg, params)
        gc_cuda(torch)
        err = decode_from_prefill(torch, dev, cfg, params, S, extra)
        summary["decode_from_prefill_f32"] = err
        if not err < 5e-4:
            fail(f"{arch}: decoding the last token from the prefill cache "
                 f"moves its log-softmax by {err:.3e} (float32; the "
                 "reference's bound 5e-4)")
        summary["logits_f32"] = compare_logits(torch, dev, cfg, params, S=S,
                                               extra=extra)
        paths[tag] = summary
        print(f"{tag}: decode from prefill "
              f"{summary['decode_from_prefill_bf16']:.3e} (bf16) / "
              f"{err:.3e} (float32), logits {summary['logits_bf16']} / "
              f"{summary['logits_f32']}", flush=True)
        del params, extra
        gc_cuda(torch)


def slstm_prefill_cost(torch, dev, cfg, params, L=XLSTM_CHUNK):
    """What the sLSTM recurrence (plain PyTorch, a step a token) costs a
    prefill: one L-token prompt through ``PrefillEngine``, then the
    model's sLSTM mixers alone on hidden states of the same shape (each
    layer's ``linear_forward`` with the lengths, as the prefill calls it),
    each timed on the host's clock after a warm-up, synchronized; and the
    device kernels one layer launches per token (``torch.profiler`` over
    a 64-token call).  Returns ms per token per layer, the sLSTM's share
    of the prefill's wall and the launches per token per layer."""
    import numpy as np

    from repro_torch.models import Model
    from repro_torch.models import linear_attention as lin
    from repro_torch.models.tree import tree_map
    from repro_torch.serving import PrefillEngine

    peng = PrefillEngine(Model(cfg), params, min_bucket=128, max_bucket=L)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, L)
                                             ).astype(np.int32)

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill_ms = wall(lambda: peng.prefill(toks, np.array([L], np.int32)))
    # (spec, one layer's mixer params) of every sLSTM layer
    cells = [(b.mixer, tree_map(lambda w, r=r: w[r], params["groups"][gi][
        "stacked"][f"b{bi}"]["mixer"]))
             for gi, g in enumerate(cfg.groups)
             for bi, b in enumerate(g.blocks)
             if getattr(b.mixer, "kind", "") == "slstm"
             for r in range(g.repeats)]
    layers = len(cells)
    x = torch.randn((1, L, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7)
                    ).to(params["embed"].dtype)
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)

    def slstm_layers():
        with torch.no_grad():
            for m, p in cells:
                lin.linear_forward(p, x, m, lengths=lengths)

    slstm_ms = wall(slstm_layers)
    m, p = cells[0]
    with torch.no_grad():
        kernels = _device_kernels(torch, lambda: lin.linear_forward(
            p, x[:, :64], m, lengths=lengths.clamp(max=64)), 3)
    per_token = sum(c for _, c in kernels.values()) / 64
    return {"prompt_tokens": L, "prefill_ms": prefill_ms,
            "slstm_layers": layers, "slstm_ms": slstm_ms,
            "slstm_ms_per_token_per_layer": slstm_ms / (L * layers),
            "slstm_share_of_prefill": slstm_ms / prefill_ms,
            "slstm_launches_per_token_per_layer": per_token,
            "slstm_device_ms_per_token_per_layer": sum(
                ms for ms, _ in kernels.values()) / 64}


def compare_paged_dense_step(torch, dev, cfg, params, lens=(1000, 700)):
    """One decode step of two prefilled prompts (``lens`` tokens) over the
    paged layout and over the dense one, from the same admissions:
    (largest logit difference, logits equal bit for bit)."""
    import numpy as np

    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine, PrefillEngine, Request
    from repro_torch.serving.engine import trim_request_cache

    model, lens = Model(cfg), list(lens)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, max(lens))).astype(np.int32)
    first, caches, _ = PrefillEngine(model, params, min_bucket=128).prefill(
        toks, np.asarray(lens, np.int32))
    out = []
    for paged in (False, True):
        dec = DecodeEngine(model, params, 2, 4096, paged=paged,
                           page_tokens=16)
        dec.admit_many([(Request(rid=i, tokens=toks[i, :L],
                                 max_new_tokens=64), int(first[i]),
                         trim_request_cache(caches, i, L), L)
                        for i, L in enumerate(lens)])
        with torch.no_grad():
            lg, _ = model.decode_step(
                params, torch.as_tensor(first, device=dev).long(),
                dec.caches, torch.tensor(lens, dtype=torch.int32, device=dev),
                **dec._tables_kw())
        out.append(lg)
        del dec
    return {"logits_max_abs_diff": float((out[0] - out[1]).abs().max()),
            "bitwise_equal": bool(torch.equal(out[0], out[1]))}


def xlstm_paths(torch, dev, paths, launches):
    """xlstm-350m at full width, ``XLSTM_PAIRS`` of its 12 [mLSTM, sLSTM]
    pairs (d_model 1024, 4 heads of 256; ~0.25 GB of bf16 weights): the
    sLSTM's cost in a prefill first; then dense and paged (state slots
    alone: no attention, tables of zero columns) over ``XLSTM_LENS`` in
    chunks of ``XLSTM_CHUNK``, whose later turn, paged, resumes from the
    session's state snapshot and prefills only its suffix; every leaf
    ships as it is (ratio 1, as the reference); the mLSTM prefill launches
    the masked GLA kernel (row 7 at dk 256, dv 257).  Then the greedy
    replay checks on both layouts (the paged engine's tokens gated equal
    to the dense one's) and the sampled one on the paged layout,
    speculative decode with the prompts cut to ``XLSTM_CHUNK`` tokens
    (bf16 tokens gated equal to the plain greedy ones; the decode step
    has no kernel), and the logit checks: bf16 recorded, the 2 % prefill
    gate and the paged decode step's equality with the dense one held in
    float32."""
    from repro_torch.configs import get_config

    cfg = depth_cut(get_config("xlstm-350m"), XLSTM_PAIRS)
    params = load_params(torch, dev, cfg, 4)
    torch.cuda.reset_peak_memory_stats()
    cost = slstm_prefill_cost(torch, dev, cfg, params)
    paths["xlstm_slstm_cost"] = cost
    print(f"xlstm_slstm_cost: {cost}", flush=True)
    for tag, paged in (("xlstm_dense", False), ("xlstm_paged", True)):
        summary, counts, dep = main_path(
            torch, dev, cfg, params, paged=paged, session_len=XLSTM_SESSION,
            lens=XLSTM_LENS, ext_len=XLSTM_EXT, threshold=XLSTM_CHUNK,
            max_bucket=XLSTM_CHUNK)
        del dep
        require_launched(counts, ("gla_chunked_fused",), tag)
        if paged:
            pin = summary["device_pin_cached_len"]
            if pin != XLSTM_SESSION:
                fail(f"the later turn on xlstm pinned {pin} cached tokens, "
                     f"not its {XLSTM_SESSION}-token state snapshot")
            if summary["pd_tokens_prefilled"][-1] != XLSTM_EXT:
                fail(f"the later turn on xlstm prefilled "
                     f"{summary['pd_tokens_prefilled'][-1]} tokens, not its "
                     f"{XLSTM_EXT}-token suffix")
        paths[tag] = summary
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"{tag}: {summary['wall_s']:.2f} s wall, warm-up "
              f"{summary['warmup_s']:.2f} s, launches: gla_chunked_fused "
              f"{counts.get('gla_chunked_fused', 0)}, quantize_int8_fused "
              f"{counts.get('quantize_int8_fused', 0)}", flush=True)
        for sampled in (False, True) if paged else (False,):
            key = f"{tag}_replay" + ("_sampled" if sampled else "")
            paths[key] = check_replay(torch, dev, cfg, params, paged=paged,
                                      sampled=sampled, cap=XLSTM_CHUNK)
            print(f"{key}: {paths[key]}", flush=True)
        gc_cuda(torch)
    # the same admissions decode to the same tokens over both layouts
    # (gated); the served traffic's tokens are recorded side by side (its
    # paged later turn resumes from the snapshot, its dense one prefills
    # the whole prompt)
    if (paths["xlstm_dense_replay"]["tokens_sha1"]
            != paths["xlstm_paged_replay"]["tokens_sha1"]):
        fail("xlstm: the paged decode engine's tokens differ from the "
             "dense one's on the same admissions")
    paths["xlstm_served_tokens_equal"] = (
        paths["xlstm_dense"]["tokens_sha1"]
        == paths["xlstm_paged"]["tokens_sha1"])
    for layout, res in check_spec(torch, dev, cfg, params, launches=launches,
                                  gate_identity=(False, True),
                                  cap=XLSTM_CHUNK).items():
        paths[f"xlstm_{layout}_spec"] = res
    gc_cuda(torch)
    paths["xlstm_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                gate=False, S=XLSTM_CHUNK)
    paths["xlstm_paged_dense_step_bf16"] = compare_paged_dense_step(
        torch, dev, cfg, params, lens=(XLSTM_CHUNK, 180))
    cfg, params = to_float32(cfg, params)
    torch.cuda.empty_cache()
    paths["xlstm_logits_f32"] = compare_logits(torch, dev, cfg, params,
                                               S=XLSTM_CHUNK)
    step = compare_paged_dense_step(torch, dev, cfg, params,
                                    lens=(XLSTM_CHUNK, 180))
    paths["xlstm_paged_dense_step_f32"] = step
    if not step["bitwise_equal"]:
        fail(f"xlstm: the float32 paged decode step differs from the dense "
             f"one: {step}")
    paths["xlstm_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc_cuda(torch)


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
    """Phase 6: the training path on zamba2-1.2b at full width, depth cut
    to ``ZAMBA2_TRAIN_UNITS`` of its 6 [5 x Mamba2, shared block] units and
    its 2-layer tail (14 of 38 layers, 0.57 B params, random bf16 weights
    from a seed): batch 2 x
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
    cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(
        cfg.groups[0], repeats=ZAMBA2_TRAIN_UNITS),) + cfg.groups[1:])
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
    temporary directory, 20 steps of batch 8 x 1024 tokens in two
    microbatches, every kernel launch counted from 0."""
    import math
    import tempfile

    from repro_torch.examples.train_100m import run
    from repro_torch.kernels import build

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        cfg, hist, stragglers = run("100m", steps=20, batch=8, seq=1024,
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


def moe_routing(torch, cfg, model, params, batch):
    """The first MoE block's routing on ``batch``'s tokens (the first
    block of the first repeat, whose input is the embeddings through its
    mixer): (top-k experts (T, k) sorted per token, each pair's capacity
    keep in the sorted dispatch order)."""
    from repro_torch.models.layers import (_route, _sorted_pairs,
                                           capacity_plan, rms_norm)
    from repro_torch.models.model import _block_params

    g = cfg.groups[0]
    b, p = g.blocks[0], _block_params(g, params["groups"][0], 0)["b0"]
    tokens = torch.as_tensor(batch["tokens"]).to(params["embed"].device)
    with torch.no_grad():
        x, positions, _ = model._decoder_input(
            params, {"tokens": tokens[:, :-1].long()})
        x, _ = model._mix(b, p, x, positions, None)
        h = rms_norm(x, p["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
        gates, idx = _route(p["ffn"], h, b.ffn.top_k)
        keep, _ = capacity_plan(_sorted_pairs(gates, idx)[1], h.shape[0],
                                b.ffn)
    return torch.sort(idx, dim=1).values, keep


def _train_batches(torch, dev, cfg, B, S, seed, steps):
    """``steps`` batches of ``SyntheticLM`` tokens (B, S + 1), with random
    float32 frames (B, 2 S, encoder_input_dim) for an encoder-decoder and
    patches (B, num_image_patches, d_model) for a VLM, from ``seed``."""
    from repro_torch.training import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for step in range(steps):
        b = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(dev)}
        if cfg.encoder_groups is not None:
            b["frames"] = torch.randn((B, 2 * S, cfg.encoder_input_dim),
                                      generator=g, device=dev)
        if cfg.num_image_patches:
            b["patches"] = torch.randn((B, cfg.num_image_patches,
                                        cfg.d_model), generator=g, device=dev)
        out.append(b)
    return out


def init_loss(cfg) -> float:
    """The cross-entropy the random init gives: the final norm's unit-rms
    rows against (un)embedding columns drawn N(0, 0.02^2) (``params.py``)
    give logits of variance 0.02^2 d_model, and the log-sum-exp of V such
    logits is ln V plus half that variance (ln V + 1.23 at mixtral's
    d_model 6144, + 0.20 at seamless's 1024)."""
    return math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model


def train_run(torch, dev, tag, cfg, seed, batches, probes, *, repeat=False,
              check_rows=None):
    """Three AdamW steps (lr 3e-4, warmup 2) through ``make_train_step``
    with remat, one microbatch, random bf16 weights from ``seed``, every
    kernel launch counted from 0.  Before them, step 0's loss and
    gradients (``aux`` from them; twice with ``repeat``, which must give
    the same bits).  Gates: finite losses and grad norms, a step-0 loss
    within 1.0 of the random init's (``init_loss``), each ``probes``
    leaf (a name: a function of the params) moved, flash launched.  With
    ``check_rows`` (a batch of one row), the loss and gradients on it
    through the kernels against the plain versions in float32, gated at
    TOL_TRAIN_LOSS / TOL_TRAIN_GRAD.  Frees the params.  Returns the
    run's summary."""
    import math

    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.models.tree import tree_leaves
    from repro_torch.params import requires_grad
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_opt_state, loss_and_grads,
                                      make_train_step)

    params = requires_grad(load_params(torch, dev, cfg, seed))
    model = Model(cfg, use_kernels=True, remat=True)
    moe = any(b.ffn.kind == "moe" for g in cfg.groups for b in g.blocks)
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(),
           "tokens": list(batches[0]["tokens"].shape)}
    if moe:
        idx, keep = moe_routing(torch, cfg, model, params, batches[0])
        out["pairs_dropped_share"] = 1.0 - float(keep.float().mean())
        del idx, keep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    loss, m, grads = loss_and_grads(model, params, batches[0])
    torch.cuda.synchronize()
    out["step0_loss_and_grads_s"] = time.perf_counter() - t0
    out["aux"], out["ce"] = float(m["aux"]), float(m["ce"])
    if repeat:
        loss2, m2, grads2 = loss_and_grads(model, params, batches[0])
        same = (torch.equal(loss, loss2) and torch.equal(m["aux"], m2["aux"])
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(grads), tree_leaves(grads2))))
        out["step0_repeat_bit_identical"] = same
        del loss2, m2, grads2
        if not same:
            fail(f"{tag}: step 0 twice from the same params gave other "
                 f"bits")
    del loss, m, grads
    tc = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=2,
                                       total_steps=3))
    state = init_opt_state(params, tc)
    step_fn = make_train_step(model, tc)
    before = {name: f(params).detach().flatten()[:64].clone()
              for name, f in probes.items()}
    hist = []
    for step, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "time_s": time.perf_counter() - t0})
    out.update(steps=hist, launches=dict(build.LAUNCHES),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    require_launched(out["launches"], ("flash_attention",), tag)
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"{tag}: non-finite loss or grad norm {hist}")
    out["init_loss"] = init_loss(cfg)
    if abs(hist[0]["loss"] - out["init_loss"]) > 1.0:
        fail(f"{tag}: step-0 loss {hist[0]['loss']:.3f} is not near the "
             f"random init's {out['init_loss']:.3f}")
    still = [name for name, f in probes.items()
             if torch.equal(before[name], f(params).detach().flatten()[:64])]
    if still:
        fail(f"{tag}: the params did not move: {still}")
    del state, step_fn
    gc_cuda(torch)
    if check_rows is not None:
        out["f32_check"] = train_f32_check(torch, tag, cfg, params,
                                           check_rows, moe)
    del params
    gc_cuda(torch)
    return out


def train_f32_check(torch, tag, cfg, params, batch, moe):
    """Loss and gradients on ``batch`` through the kernels against the
    plain versions in float32 (the params converted in place), gated at
    TOL_TRAIN_LOSS and TOL_TRAIN_GRAD; for a MoE the routing decisions of
    its first block that differ between the two (experts and capacity
    keeps), recorded beside the gate."""
    from repro_torch.models import Model
    from repro_torch.params import requires_grad
    from repro_torch.training import loss_and_grads

    with torch.no_grad():
        requires_grad(params, False)
        cfg, params = to_float32(cfg, params)
    requires_grad(params)
    gc_cuda(torch)
    res, routes = {}, {}
    for path, use in (("kernels", True), ("plain", False)):
        model = Model(cfg, use_kernels=use, remat=True)
        loss, _, res[path] = loss_and_grads(model, params, batch)
        res[path + "_loss"] = float(loss)
        if moe:
            routes[path] = moe_routing(torch, cfg, model, params, batch)
    lk, lp = res["kernels_loss"], res["plain_loss"]
    norm_gap, diff, worst, share = _grad_gap(torch, res["kernels"],
                                             res["plain"])
    check = {"loss_kernels": lk, "loss_plain": lp,
             "loss_rel_diff": abs(lk - lp) / abs(lp),
             "grad_norm_rel_diff": norm_gap, "grad_rel_l2_diff": diff,
             "largest_diff_leaf": worst, "largest_diff_leaf_share": share}
    if moe:
        (ik, kk), (ip, kp) = routes["kernels"], routes["plain"]
        check["routing_experts_differ"] = int((ik != ip).sum())
        check["routing_keeps_differ"] = int((kk != kp).sum())
    del res
    gc_cuda(torch)
    print(f"{tag} float32 check, kernels vs plain: {check}", flush=True)
    if not (check["loss_rel_diff"] <= TOL_TRAIN_LOSS
            and check["grad_norm_rel_diff"] <= TOL_TRAIN_GRAD):
        fail(f"{tag} train check in float32: kernels vs plain {check}")
    return check


def train_more(torch, dev):
    """Phase 8: training on the MoE, encoder-decoder and VLM families,
    full width, random bf16 weights from a seed, remat, AdamW, three
    steps each (``train_run``):
      * mixtral-8x22b, ``MIXTRAL_TRAIN_LAYERS`` (1) of its 56 layers, all 8
        experts (2.91 B params): batch 1 x 8192 tokens, so the flash
        kernel's backward recompute is ``swa_banded`` (window 4096);
        capacity MoE and its aux loss; step 0 twice, bit-identical; the
        float32 kernels-vs-plain check on one 2048-token row;
      * seamless-m4t-medium at full depth (12 + 12 layers): batch 2 x 1024
        tokens over 2048 random frames (the encoder's self-attention and
        the cross-attention recompute through ``mea_attention``); the
        float32 check on one row;
      * phi-3-vision-4.2b, ``PHI3_TRAIN_LAYERS`` (8) of its 32 layers:
        batch 2 x (576 random patches + 1024 tokens).
    Returns {tag: summary}."""
    from repro_torch.configs import get_config

    out = {}
    cfg = mixtral_config(MIXTRAL_TRAIN_LAYERS)
    rows = _train_batches(torch, dev, cfg, 1, 2048, 11, 1)[0]

    def stacked(*path):
        def get(params):
            x = params["groups"][0]["stacked"]["b0"]
            for k in path:
                x = x[k]
            return x[0]
        return get

    out["mixtral_train"] = train_run(
        torch, dev, "mixtral_train", cfg, 12,
        _train_batches(torch, dev, cfg, 1, 8192, 12, 3),
        {"router": stacked("ffn", "router"),
         "expert0_w1": lambda p: stacked("ffn", "w1")(p)[0]},
        repeat=True, check_rows=rows)
    cfg = get_config("seamless-m4t-medium")
    batches = _train_batches(torch, dev, cfg, 2, 1024, 13, 3)
    rows = {k: v[:1] for k, v in batches[0].items()}
    out["seamless_train"] = train_run(
        torch, dev, "seamless_train", cfg, 13, batches,
        {"enc_proj": lambda p: p["enc_proj"]["w"],
         "encoder_layer0_wq": lambda p: p["enc_groups"][0]["stacked"]["b0"][
             "mixer"]["wq"]["w"][0]},
        check_rows=rows)
    cfg = depth_cut(get_config("phi-3-vision-4.2b"), PHI3_TRAIN_LAYERS)
    out["phi3_train"] = train_run(
        torch, dev, "phi3_train", cfg, 14,
        _train_batches(torch, dev, cfg, 2, 1024, 14, 3),
        {"patch_proj": lambda p: p["patch_proj"]["w"]})
    return out


# what some kernel entries add to the keys every entry has: achieved rate,
# share of the bound and the error at each checked shape (rows 1 and 9),
# the GQA shape's numbers (row 8), device time, each pass's and the
# request shapes' numbers (row 4)
_EXTRA_KEYS = ("tflops", "bound_share", "checked", "checked_f32", "shapes",
               "device_ms", "phases_ms", "requests")


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


def dryrun_shares(torch, paths, calib):
    """Phase 9: the meta-device counts of five timed steps and their shares
    of the card (see the module docstring).  Returns {step: {...}}."""
    from repro_torch.analysis import counting, roofline
    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs
    from repro_torch.models import Model

    meta = torch.device("meta")
    mistral = depth_cut(get_config("mistral-nemo-12b"), MISTRAL_LAYERS)
    zamba2 = get_config("zamba2-1.2b")
    zamba2 = dataclasses.replace(zamba2, groups=(dataclasses.replace(
        zamba2.groups[0], repeats=ZAMBA2_TRAIN_UNITS),) + zamba2.groups[1:])

    def prefill(cfg):
        model, params = Model(cfg), input_specs.params_specs(cfg)
        batch = {"tokens": torch.empty((1, 4096), dtype=torch.long,
                                       device=meta),
                 "lengths": torch.empty((1,), dtype=torch.int32,
                                        device=meta)}

        def run():
            with torch.no_grad():
                logits, _ = model.prefill(params, batch)
                torch.argmax(logits, dim=-1)
        return run

    block = paths["kimi_decode_profile"]
    slots, L, steps = (block["slots"], block["tokens_per_slot"],
                       block["steps"])
    peak = calib["machine"]["peak_flops"]
    # (step, config, kind, batch, sequence, steps counted by one run, the
    # profile's busy ms, how the run is built)
    plan = (
        ("kimi_prefill", kimi_config(), "prefill", 1, 4096, 1,
         paths["kimi_prefill_profile"]["device_busy_ms_profiled"],
         lambda cfg: prefill(cfg)),
        ("mistral_prefill", mistral, "prefill", 1, 4096, 1,
         paths["mistral_prefill_profile"]["device_busy_ms_profiled"],
         lambda cfg: prefill(cfg)),
        ("kimi_decode_block", kimi_config(), "decode", slots, L, steps,
         paths["kimi_decode_profile"]["graph"]["device_busy_ms_profiled"],
         lambda cfg: counting.step_fn(cfg, "decode", slots, L)),
        ("mistral_decode_block", mistral, "decode", slots, L, steps,
         paths["mistral_decode_profile"]["graph"]["device_busy_ms_profiled"],
         lambda cfg: counting.step_fn(cfg, "decode", slots, L)),
        ("zamba2_train_step", zamba2, "train", 2, 2048, 1,
         paths["zamba2_train"]["step_profile"]["device_busy_ms"],
         lambda cfg: counting.step_fn(cfg, "train", 2, 2048, mb=2)),
    )
    out = {}
    for name, cfg, kind, B, S, reps, busy_ms, build in plan:
        t0 = time.perf_counter()
        c = counting.count(build(cfg))
        flops, nbytes = c["flops"] * reps, c["bytes"] * reps
        model_flops = reps * roofline.model_flops_for(
            cfg, kind, S, B, kind == "train", as_run=True)
        busy_s = busy_ms / 1e3
        r = {"model_flops": model_flops, "counted_flops": flops,
             "counted_bytes": nbytes, "busy_ms": busy_ms,
             "mfu": model_flops / busy_s / peak,
             "mfu_989": model_flops / busy_s / roofline.PEAK_FLOPS,
             "counted_989": flops / busy_s / roofline.PEAK_FLOPS,
             "hbm_share": nbytes / busy_s / roofline.HBM_BW,
             "count_s": time.perf_counter() - t0}
        print(f"dryrun {name}: model_flops {model_flops:.4g}, counted "
              f"{flops:.4g} FLOPs and {nbytes:.4g} bytes, busy "
              f"{busy_ms:.2f} ms", flush=True)
        print(f"dryrun {name}: mfu {r['mfu']:.4f} of the measured "
              f"{peak / 1e12:.1f} TFLOP/s ({r['mfu_989']:.4f} of "
              f"{roofline.PEAK_FLOPS / 1e12:.0f}; counted "
              f"{r['counted_989']:.4f}), hbm_share {r['hbm_share']:.4f}",
              flush=True)
        bad = [k for k in ("mfu_989", "counted_989", "hbm_share")
               if not 0.0 < r[k] <= TOL_PEAK]
        if bad or not r["mfu"] > 0.0:
            fail(f"dryrun {name}: {bad or ['mfu']} outside (0, {TOL_PEAK}]: "
                 f"{r}")
        out[name] = r
    return out


def run_examples():
    """Phase 10: the quickstart and cross-DC serving examples on the card,
    each a subprocess from this checkout.  Returns {example: seconds}."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {}
    for name in ("quickstart", "serve_cross_dc"):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m",
                              f"repro_torch.examples.{name}"],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        out[name] = time.perf_counter() - t0
        tail = res.stdout.strip().splitlines()[-2:]
        print(f"example {name}: exit {res.returncode} in {out[name]:.1f} "
              f"s; {tail}", flush=True)
        if res.returncode != 0:
            fail(f"example {name} exited {res.returncode}: "
                 f"{res.stderr[-2000:]}")
    return out


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

    phase_s, clock = {}, [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

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
    phase("build")
    # registers and spills of the bf16 decode core's, the delta core's, the
    # GLA core's and the wire encode's instances
    decode_ptxas = ptxas_report(str(lib) + ".log", "decode_hopper::")
    delta_ptxas = ptxas_report(str(lib) + ".log", "delta_hopper::")
    gla_ptxas = ptxas_report(str(lib) + ".log", "gla_hopper::")
    quantize_ptxas = ptxas_report(str(lib) + ".log", "quantize_wire::")
    for e in decode_ptxas + delta_ptxas + gla_ptxas + quantize_ptxas:
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
    verify = check_verify(torch, dev)
    batch_variance = decode_batch_variance(torch, dev)
    print(f"verify_attention: {verify}; decode batch variance: "
          f"{batch_variance}", flush=True)
    phase("kernel_checks")
    torch.cuda.empty_cache()
    calib = calibration(torch, dev)
    gc_cuda(torch)
    phase("calibration")

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
        paths[f"{tag}_replay"] = check_replay(torch, dev, cfg, params,
                                              paged=paged)
        print(f"{tag}_replay: {paths[f'{tag}_replay']}", flush=True)
        paths[f"{tag}_replay_sampled"] = check_replay(
            torch, dev, cfg, params, paged=paged, sampled=True)
        print(f"{tag}_replay_sampled: {paths[f'{tag}_replay_sampled']}",
              flush=True)
    for layout, res in check_spec(torch, dev, cfg, params,
                                  launches=launches, profile=(True,),
                                  gate_identity=(False, True)).items():
        paths[f"kimi_{layout}_spec"] = res
    rep = prefill_repeatability(torch, dev, cfg, params)
    paths["kimi_prefill_repeatability"] = rep
    print(f"kimi_prefill_repeatability: {rep}", flush=True)
    if rep["cache_leaves_moved"] or not all(rep["first_tokens_equal"]):
        fail(f"kimi's prefill is not repeatable: leaves "
             f"{rep['cache_leaves_moved']} moved, first tokens equal "
             f"{rep['first_tokens_equal']}")
    if not all(rep["moe_repeats_equal"]):
        fail(f"the dropless MoE is not repeatable: {rep}")
    paths["kimi_decode_profile"] = profile_decode_block(torch, dev, cfg,
                                                        params)
    print(f"kimi_decode_profile: sampled - greedy "
          f"{paths['kimi_decode_profile']['sampled_minus_greedy']}",
          flush=True)
    paths["kimi_logits"] = compare_logits(torch, dev, cfg, params)
    paths["kimi_prefill_profile"] = profile_prefill(torch, dev, cfg, params)
    paths["kimi_mla_concat"] = mla_concat_cost(torch, dev, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("kimi")

    # mistral-nemo-12b at full width, MISTRAL_LAYERS deep, paged, with a
    # prefix hit
    cfg = depth_cut(get_config("mistral-nemo-12b"), MISTRAL_LAYERS)
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
    paths["mistral_paged_replay"] = check_replay(torch, dev, cfg, params,
                                                 paged=True)
    print(f"mistral_paged_replay: {paths['mistral_paged_replay']}",
          flush=True)
    # the paged verify is the scan of plain steps: gated in bf16; the
    # dense one-pass verify runs its products over B x 3 rows: recorded
    for layout, res in check_spec(torch, dev, cfg, params,
                                  launches=launches, profile=(False,),
                                  gate_identity=(True,)).items():
        paths[f"mistral_{layout}_spec"] = res
    paths["mistral_decode_profile"] = profile_decode_block(torch, dev, cfg,
                                                           params)
    paths["mistral_prefill_profile"] = profile_prefill(torch, dev, cfg,
                                                       params)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    print(f"mistral_paged: {summary['wall_s']:.2f} s wall, launches {counts}",
          flush=True)
    torch.cuda.empty_cache()
    # in bf16, many layers turn the kernels' and plain versions' different
    # float32 summation orders into flips of bf16 roundings that compound
    # layer over layer (2.1 % of the largest |logit| for the decode step
    # at 40 layers on an H100): recorded, and the 2 % gate is held in
    # float32, where the two differ by their summation order alone
    paths["mistral_logits_bf16"] = compare_logits(torch, dev, cfg, params,
                                                  gate=False)
    paths["mistral_paged_step_bf16"] = compare_paged_step(
        torch, dev, cfg, params, gate=False)
    cfg, params = to_float32(cfg, params)
    torch.cuda.empty_cache()
    paths["mistral_logits_f32"] = compare_logits(torch, dev, cfg, params)
    paths["mistral_paged_step_f32"] = compare_paged_step(torch, dev, cfg,
                                                         params)
    gc_cuda(torch)
    # the one-pass dense verify's tokens against the plain greedy ones in
    # float32, where its products' row count does not move a bit
    for layout, res in check_spec(torch, dev, cfg, params, eager=False,
                                  gate_identity=(False,),
                                  layouts=(False,)).items():
        paths[f"mistral_{layout}_spec_f32"] = res
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("mistral")

    zamba2_paths(torch, dev, paths, launches)
    gc_cuda(torch)
    phase("zamba2")
    danube_paths(torch, dev, paths, launches)
    gc_cuda(torch)
    phase("danube")
    xlstm_paths(torch, dev, paths, launches)
    gc_cuda(torch)
    phase("xlstm")
    # the MoE families on their card cuts (8 layers, every width and
    # expert), then the encoder-decoder and the VLM at full depth
    moe_paths(torch, dev, paths, launches, "llama4", llama4_config(), 7)
    phase("llama4")
    moe_paths(torch, dev, paths, launches, "mixtral", mixtral_config(), 8)
    phase("mixtral")
    encdec_vlm_paths(torch, dev, paths, launches)
    phase("encdec_vlm")

    # the serving launcher end to end, calibrated, sampled, cross-validated
    runs, counts = launcher(torch, dev, ROOT / calib["path"])
    paths.update(runs)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    phase("launcher")

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
    phase("training")
    # training on the MoE (capacity + aux loss), the encoder-decoder and
    # the VLM
    for tag, summary in train_more(torch, dev).items():
        paths[tag] = summary
        for name, n in summary["launches"].items():
            launches[name] = launches.get(name, 0) + n
        losses = [round(h["loss"], 4) for h in summary["steps"]]
        print(f"{tag}: losses {losses}, aux {summary['aux']:.4f}, dropped "
              f"{summary.get('pairs_dropped_share', 0.0):.4f} of the pairs, "
              f"peak {summary['peak_memory_gb']:.1f} GB, "
              f"{summary['steps'][-1]['time_s']:.2f} s the last step, "
              f"launches {summary['launches']}", flush=True)
    phase("train_more")
    paths["dryrun"] = dryrun_shares(torch, paths, calib)
    phase("dryrun")
    paths["examples_s"] = run_examples()
    phase("examples")
    paths["phase_s"] = phase_s
    paths["calibration"] = calib
    paths["gradient_checks"] = grad_checks
    paths["verify_attention"] = verify
    paths["decode_batch_variance"] = batch_variance
    paths["decode_ptxas"] = decode_ptxas
    paths["delta_ptxas"] = delta_ptxas
    paths["gla_ptxas"] = gla_ptxas
    paths["quantize_ptxas"] = quantize_ptxas

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
