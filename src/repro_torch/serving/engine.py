"""Continuously-batched region engine: bucketed / chunked prefill, slot-based
decode and the region scheduler that interleaves them.

Counterpart of ``src/repro/serving/engine.py`` for the dense KV layout and
greedy decode (paged KV, speculative decode and sampling are later slices
and raise ``NotImplementedError``).  The reference compiles one program per
shape; PyTorch runs eagerly, so the bucket grid here bounds padding and
keeps tokens identical to the reference rather than bounding compiles.

  * ``PrefillEngine``: pow2 length x batch buckets with exact per-row
    ``lengths``; prompts past ``max_bucket`` run as ``ChunkedPrefill``
    chunks (the flash kernel's ``q_offset`` path + linear-state carry).
  * ``DecodeEngine``: per-slot dense caches; ``admit_many`` writes the
    admitted requests into free slots, ``step_block`` runs ``block_size``
    decode steps with the argmax fed back on the device and one host sync
    per block.
  * ``RegionScheduler``: admit ready requests -> one prefill unit -> one
    decode block, per tick.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models.tree import tree_map, tree_map_named
from repro_torch.serving.api import Request, Response

_SEQ_LEAVES = ("k", "v", "ckv", "kpe")


def next_pow2(n: int, lo: int = 1) -> int:
    v = max(int(lo), 1)
    while v < n:
        v *= 2
    return v


def _device_of(params) -> torch.device:
    return params["embed"].device


class PrefillEngine:
    """Bucketed (and, past ``max_bucket``, chunked) prefill.

    ``min_bucket``: smallest pow2 length bucket.  ``max_bucket``: prompts
    whose bucket exceeds it are prefilled in fixed ``max_bucket``-token
    chunks.  The batch is rounded up to a power of two as well.
    """

    def __init__(self, model: Model, params, *, min_bucket: int = 32,
                 max_bucket: Optional[int] = None):
        self.model = model
        self.params = params
        self.device = _device_of(params)
        self.min_bucket = next_pow2(min_bucket)
        if max_bucket is not None and next_pow2(max_bucket) != max_bucket:
            raise ValueError("max_bucket must be a power of two")
        self.max_bucket = max_bucket

    def bucket_for(self, max_len: int) -> int:
        return next_pow2(max_len, self.min_bucket)

    def is_chunked(self, length: int) -> bool:
        """True when a prompt of ``length`` tokens runs as chunked prefill."""
        return (self.max_bucket is not None
                and self.bucket_for(int(length)) > self.max_bucket)

    def _pad(self, tokens: np.ndarray, lengths):
        """Pad a (B, S) prompt batch to its bucket shape: pow2 length (or a
        chunk multiple past ``max_bucket``) x pow2 batch.  Returns (toks,
        lens, B, chunked)."""
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        if lengths is None:
            lengths = np.full((B,), S, np.int32)
        lengths = np.asarray(lengths, np.int32)
        max_len = int(lengths.max()) if B else S
        Sb = self.bucket_for(max_len)
        chunked = self.max_bucket is not None and Sb > self.max_bucket
        if chunked:
            C = self.max_bucket
            Sb = -(-max_len // C) * C
        Bb = next_pow2(B)
        toks = np.zeros((Bb, Sb), np.int32)
        toks[:B, :min(S, Sb)] = tokens[:, :Sb]
        lens = np.ones((Bb,), np.int32)                  # pad rows: 1 token
        lens[:B] = np.maximum(lengths, 1)
        return toks, lens, B, chunked

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def prefill(self, tokens: np.ndarray, lengths=None):
        """tokens: (B, S) right-padded prompts; lengths: (B,).  Returns
        (first_token (B,) np.int32, bucket-padded caches, wall_s)."""
        t0 = time.perf_counter()
        toks, lens, B, chunked = self._pad(tokens, lengths)
        if chunked:
            cp = ChunkedPrefill(self, toks, lens, B)
            while not cp.done:
                cp.step()
            first, caches = cp.finish()
        else:
            with torch.no_grad():
                logits, caches = self.model.prefill(
                    self.params, {"tokens": self._tensor(toks).long(),
                                  "lengths": self._tensor(lens)})
                first = torch.argmax(logits, dim=-1).to(torch.int32)
            first = first.cpu().numpy()[:B]
        return first, caches, time.perf_counter() - t0

    def start_chunked(self, tokens: np.ndarray, lengths=None
                      ) -> "ChunkedPrefill":
        """Begin a chunked prefill the scheduler advances one chunk per
        tick.  The prompt batch must be past ``max_bucket``."""
        toks, lens, B, chunked = self._pad(tokens, lengths)
        if not chunked:
            raise ValueError("prompt fits a plain bucket; use prefill()")
        return ChunkedPrefill(self, toks, lens, B)


class ChunkedPrefill:
    """One in-flight chunked prefill, advanced a fixed-shape chunk at a time.

    ``step()`` runs one ``max_bucket``-token chunk through
    ``model.prefill_chunk`` and folds the chunk's hidden states into the
    (B, 1, d) last-valid-hidden carry; ``finish()`` computes the first
    decode token from the carry.  Wall time accumulates across steps."""

    def __init__(self, eng: PrefillEngine, toks: np.ndarray,
                 lens: np.ndarray, n_valid: int):
        self.eng = eng
        self.toks = toks                     # (Bb, Sb), Sb = n_chunks * C
        self.lens = lens
        self.n_valid = n_valid
        self.C = eng.max_bucket
        self.n_chunks = toks.shape[1] // self.C
        self.i = 0
        self.caches = None
        self._last = None                    # (Bb, 1, d) last-hidden carry
        self._lens_dev = eng._tensor(lens)
        self.wall_s = 0.0

    @property
    def done(self) -> bool:
        return self.i >= self.n_chunks

    def step(self) -> bool:
        """Advance one chunk; returns True once every chunk has run."""
        t0 = time.perf_counter()
        eng, C, i = self.eng, self.C, self.i
        Bb = self.toks.shape[0]
        pos = np.repeat(np.arange(i * C, (i + 1) * C, dtype=np.int32)[None],
                        Bb, axis=0)
        chunk_lens = np.clip(self.lens - i * C, 0, C).astype(np.int32)
        with torch.no_grad():
            h, self.caches = eng.model.prefill_chunk(
                eng.params,
                {"tokens": eng._tensor(self.toks[:, i * C:(i + 1) * C]).long(),
                 "positions": eng._tensor(pos),
                 "lengths": eng._tensor(chunk_lens)},
                self.caches)
            if self._last is None:
                self._last = torch.zeros((Bb, 1, h.shape[-1]), dtype=h.dtype,
                                         device=h.device)
            # rows whose last prompt position falls in this chunk take it
            last = self._lens_dev.long() - 1
            idx = torch.clamp(last - i * C, 0, C - 1)
            cand = h[torch.arange(Bb, device=h.device), idx][:, None]
            inside = (last >= i * C) & (last < (i + 1) * C)
            self._last = torch.where(inside[:, None, None], cand, self._last)
        self.i += 1
        if self.done and self._last.is_cuda:
            torch.cuda.synchronize(self._last.device)
        self.wall_s += time.perf_counter() - t0
        return self.done

    def finish(self):
        """Epilogue after the last ``step()``: (first_token (n_valid,)
        np.int32, caches)."""
        if not self.done:
            raise RuntimeError(f"chunked prefill at chunk {self.i}"
                               f"/{self.n_chunks}; not finished")
        t0 = time.perf_counter()
        Bb = self.toks.shape[0]
        with torch.no_grad():
            logits = self.eng.model.last_logits(
                self.eng.params, self._last,
                torch.ones((Bb,), dtype=torch.int32, device=self._last.device))
            first = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.wall_s += time.perf_counter() - t0
        return first[:self.n_valid], self.caches


class DecodeEngine:
    """Slot-based continuous-batching decode (dense per-slot caches,
    greedy)."""

    def __init__(self, model: Model, params, num_slots: int, capacity: int,
                 block_size: int = 8, *, temperature: float = 0.0,
                 paged: bool = False, spec_k: int = 0):
        if paged:
            raise NotImplementedError("paged KV is not ported yet")
        if spec_k:
            raise NotImplementedError("speculative decode is not ported yet")
        if temperature > 0.0:
            raise NotImplementedError("sampled decode is not ported yet; "
                                      "the port decodes greedily")
        self.model = model
        self.params = params
        self.device = _device_of(params)
        self.num_slots = num_slots
        self.capacity = capacity
        self.block_size = max(1, int(block_size))
        self.caches = model.init_cache(num_slots, capacity, self.device)
        self._admit_wall: Dict[int, float] = {}
        self.tbt_s: List[float] = []
        self.lengths = np.zeros((num_slots,), np.int32)
        self.tokens = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.budget = np.zeros((num_slots,), np.int32)
        self.slot_req: List[Optional[int]] = [None] * num_slots
        self.outputs: Dict[int, Response] = {}
        self.truncations = 0
        # occupancy telemetry, as the reference: wall seconds inside
        # step_block, the same weighted by active slots, tokens emitted
        self.decode_wall_s = 0.0
        self.slot_busy_s = 0.0
        self.tokens_out = 0
        self._free = deque(range(num_slots))

    def free_slots(self) -> List[int]:
        return list(self._free)

    def admit_many(self, entries: Sequence[Tuple]) -> int:
        """entries: [(req, first_token, one_cache, prompt_len), ...].
        Admits up to the number of free slots, in order; each request's
        prefill cache (batch of 1) is zero-padded to capacity and written
        into its slot.  Returns the number admitted."""
        n = min(len(entries), len(self._free))
        take = list(entries[:n])
        slots = [self._free.popleft() for _ in range(n)]
        for slot, (req, first_token, cache, prompt_len) in zip(slots, take):
            placed = prepare_decode_caches(self.model.cfg, cache,
                                           self.capacity)
            tree_map(lambda buf, new: buf[:, slot].copy_(new[:, 0]),
                     self.caches, placed)
            self.lengths[slot] = prompt_len
            self.tokens[slot] = first_token
            self.active[slot] = True
            self.budget[slot] = req.max_new_tokens
            self.slot_req[slot] = req.rid
            self.outputs[req.rid] = Response(req.rid, [int(first_token)])
            self._admit_wall[req.rid] = time.perf_counter()
        return n

    def _retire(self, slot: int):
        rid = self.slot_req[slot]
        resp = self.outputs[rid]
        resp.finished = True
        # at the KV-capacity wall with budget left: not a clean finish
        truncated = (self.lengths[slot] >= self.capacity - 1
                     and self.budget[slot] > 0)
        resp.truncated = bool(truncated)
        self.truncations += int(truncated)
        t_admit = self._admit_wall.pop(rid, None)
        if t_admit is not None:
            n_tok = len(resp.output_tokens)
            self.tbt_s.append((time.perf_counter() - t_admit)
                              / max(1, n_tok - 1))
        self.active[slot] = False
        self.slot_req[slot] = None
        self._free.append(slot)

    def _block(self):
        """``block_size`` greedy decode steps on the device: each step's
        argmax is the next step's input, and the tokens reach the host once
        per block (the MoE's loop over experts also reads each layer's
        expert counts).  Returns (block, slots) tokens."""
        toks = torch.as_tensor(self.tokens, device=self.device).long()
        lens = torch.as_tensor(self.lengths, device=self.device)
        out = []
        with torch.no_grad():
            for _ in range(self.block_size):
                logits, self.caches = self.model.decode_step(
                    self.params, toks, self.caches, lens)
                toks = torch.argmax(logits, dim=-1)
                out.append(toks)
                lens = lens + 1
        return torch.stack(out).to(torch.int32).cpu().numpy()

    def step_block(self):
        """Advance every active stream by up to ``block_size`` tokens with
        one host sync.  Returns #active.

        Inactive slots decode garbage into cache rows a later admission
        rewrites; streams that reach their budget or the capacity wall
        mid-block keep only their valid tokens."""
        if not self.active.any():
            return 0
        t0 = time.perf_counter()
        toks = self._block()                          # (block, num_slots)
        idx = np.where(self.active)[0]
        wall = time.perf_counter() - t0
        self.decode_wall_s += wall
        self.slot_busy_s += len(idx) * wall
        # tokens a slot emits before retiring: min(budget, room to
        # capacity-1) per block, floored at 1 (a slot admitted at the wall
        # still emits one token)
        valid = np.clip(
            np.minimum(self.budget[idx],
                       self.capacity - 1 - self.lengths[idx]),
            1, self.block_size).astype(int)
        self.tokens_out += int(valid.sum())
        self.lengths[idx] += valid
        self.budget[idx] -= valid
        self.tokens[idx] = toks[valid - 1, idx]
        done = (self.budget[idx] <= 0) | \
               (self.lengths[idx] >= self.capacity - 1)
        for j, i in enumerate(idx):
            out = self.outputs[self.slot_req[i]].output_tokens
            out.extend(int(t) for t in toks[:valid[j], i])
            if done[j]:
                self._retire(i)
        return int(self.active.sum())

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while self.active.any() and steps < max_steps:
            self.step_block()
            steps += 1
        return steps


class RegionScheduler:
    """One continuously-batched loop per region, owning the prefill queue
    and the decode slots together.  ``tick()``: admit every ready request
    into free slots, advance one prefill unit (a chunk of the in-flight
    chunked prefill, or one same-(engine, bucket) FIFO batch), then run one
    decode block.  Finished units pass through ``on_unit_done`` (when set)
    for trim/wire/metrics accounting."""

    def __init__(self, prefill: PrefillEngine, decode: DecodeEngine, *,
                 max_prefill_batch: int = 8, on_unit_done=None):
        self.prefill = prefill
        self.decode = decode
        self.max_prefill_batch = max(1, int(max_prefill_batch))
        self.on_unit_done = on_unit_done
        self.queue: deque = deque()          # (req, engine), FIFO
        self.ready: deque = deque()          # (admit entry, ready boundary)
        self._inflight = None                # (ChunkedPrefill, reqs, lens)
        self.boundaries = 0
        self.max_admit_wait = 0
        self.starved_boundaries = 0
        self.wall_s = 0.0

    def submit(self, req: Request, engine: Optional[PrefillEngine] = None):
        self.queue.append((req, engine if engine is not None
                           else self.prefill))

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.ready or self._inflight is not None
                    or self.decode.active.any())

    def _admit(self) -> int:
        if not self.ready:
            return 0
        n = self.decode.admit_many([e for e, _ in self.ready])
        for _ in range(n):
            _, born = self.ready.popleft()
            self.max_admit_wait = max(self.max_admit_wait,
                                      self.boundaries - born)
        if self.ready and self.decode.free_slots():
            self.starved_boundaries += 1
        return n

    def _finish_unit(self, engine, reqs, lengths, first, caches,
                     wall_s: float):
        if self.on_unit_done is not None:
            entries = self.on_unit_done(engine, reqs, lengths, first,
                                        caches, wall_s)
        else:
            entries = [(r, int(first[i]),
                        trim_request_cache(caches, i, int(lengths[i])),
                        int(lengths[i]))
                       for i, r in enumerate(reqs)]
        for e in entries:
            self.ready.append((e, self.boundaries))

    def _prefill_one(self):
        if self._inflight is not None:
            cp, reqs, lengths = self._inflight
            cp.step()
            if cp.done:
                self._inflight = None
                first, caches = cp.finish()
                self._finish_unit(cp.eng, reqs, lengths, first, caches,
                                  cp.wall_s)
            return
        if not self.queue:
            return
        req0, e0 = self.queue[0]
        if e0.is_chunked(len(req0.tokens)):
            # long prompt: the chunk-interleaved unit (batch of 1)
            self.queue.popleft()
            lengths = np.array([len(req0.tokens)], np.int32)
            toks = np.asarray(req0.tokens, np.int32)[None, :]
            self._inflight = (e0.start_chunked(toks, lengths), [req0],
                              lengths)
            self._prefill_one()              # its first chunk runs now
            return
        bucket = e0.bucket_for(len(req0.tokens))
        unit: List[Request] = []
        rest: deque = deque()
        while self.queue:
            r, e = self.queue.popleft()
            if (len(unit) < self.max_prefill_batch and e is e0
                    and not e.is_chunked(len(r.tokens))
                    and e.bucket_for(len(r.tokens)) == bucket):
                unit.append(r)
            else:
                rest.append((r, e))
        self.queue = rest
        lengths = np.array([len(r.tokens) for r in unit], np.int32)
        toks = np.zeros((len(unit), int(lengths.max())), np.int32)
        for i, r in enumerate(unit):
            toks[i, :len(r.tokens)] = r.tokens
        first, caches, wall = e0.prefill(toks, lengths)
        self._finish_unit(e0, unit, lengths, first, caches, wall)

    def tick(self):
        """admit -> one prefill unit -> one decode block; returns #active."""
        t0 = time.perf_counter()
        self._admit()
        self._prefill_one()
        n = self.decode.step_block()
        self.boundaries += 1
        self.wall_s += time.perf_counter() - t0
        return n

    def run(self, max_ticks: int = 100_000) -> int:
        ticks = 0
        while self.has_work and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

    def occupancy(self) -> float:
        denom = self.decode.num_slots * self.wall_s
        return self.decode.slot_busy_s / denom if denom > 0 else 0.0

    def goodput_tok_s(self) -> float:
        return (self.decode.tokens_out / self.wall_s
                if self.wall_s > 0 else 0.0)


def trim_request_cache(caches, idx: int, length: int):
    """Request ``idx`` of a bucket-padded batched prefill cache, with its
    sequence leaves (k/v/ckv/kpe) trimmed to ``length``: the bytes that
    cross the wire.  O(1) state leaves pass through (batch of 1)."""
    def cut(name, leaf):
        leaf = leaf[:, idx:idx + 1]
        if name in _SEQ_LEAVES:
            leaf = leaf[:, :, :min(max(length, 0), leaf.shape[2])]
        return leaf.contiguous()

    return tree_map_named(cut, caches)
