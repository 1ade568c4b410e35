"""Continuously-batched region engine: bucketed / chunked prefill, slot-based
decode and the region scheduler that interleaves them.

Counterpart of ``src/repro/serving/engine.py`` for greedy, sampled and
speculative decode over the dense or the paged KV layout.  The reference
compiles one program per shape; PyTorch runs prefill eagerly, so the
bucket grid there bounds padding and keeps tokens identical to the
reference, and ``compiles`` counts the distinct shapes run.  The
reference's jitted decode block (a ``lax.scan``) is, on the card, one CUDA
graph per ``DecodeEngine``, captured once and replayed every block.

  * ``PrefillEngine``: pow2 length x batch buckets with exact per-row
    ``lengths``; prompts past ``max_bucket`` run as ``ChunkedPrefill``
    chunks (the flash kernel's ``q_offset`` path + linear-state carry), and
    a device prefix hit runs only its suffix (``start_suffix``).
  * ``DecodeEngine``: per-slot dense caches, or with ``paged=True`` shared
    page pools (``models/paged.py``) addressed through per-slot block
    tables over a ``BlockPool``; ``admit_many`` writes the admitted
    requests into free slots (paged: only their pages, a pinned prefix
    mapped instead of rewritten), ``step_block`` runs ``block_size``
    decode steps with the next token (the argmax, or a sample at
    ``temperature > 0``, :func:`sample_tokens`) fed back on the device and
    one host sync per block (on the card a replay of the captured graph),
    or at ``spec_k > 0`` ``block_size`` greedy verify rounds of
    ``spec_k`` n-gram drafts each (one graph too), ``step`` one eager
    greedy token.  ``warmup_admission`` / ``warmup_block`` (called by
    ``PrefillEngine.warmup``) run admission and the block once before
    traffic; the latter is the capture.
  * ``RegionScheduler``: admit ready requests -> one prefill unit -> one
    decode block, per tick; ``stats()`` as the reference's.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.blockpool import PREFIX, BlockPool
from repro_torch.kernels import build as _build
from repro_torch.kernels.paged_prefill_attn import require_bf16_pages
from repro_torch.models import Model, prepare_decode_caches
from repro_torch.models.model import require_token_only
from repro_torch.models.kvcache import quantize_cache_for_wire
from repro_torch.models import paged as paged_mod
from repro_torch.models.tree import tree_map
from repro_torch.serving.api import Request, Response

_SEQ_LEAVES = ("k", "v", "ckv", "kpe")


def next_pow2(n: int, lo: int = 1) -> int:
    v = max(int(lo), 1)
    while v < n:
        v *= 2
    return v


def _device_of(params) -> torch.device:
    return params["embed"].device


_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A bijection of [0, 2^32) (Wellons' "lowbias32" constants) on
    Python ints or int64 tensors.  Both multipliers are below 2^31, so no
    product of a 32-bit value reaches 2^63, where int64 would wrap."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def sample_hash(seed: int, step: torch.Tensor, rows: int, cols: int):
    """(rows, cols) int64 in [0, 2^32): a stateless hash of (``seed``,
    ``step``, row, column), all integer ops on ``step``'s device, so the
    same inputs give the same bits on the CPU and the card.  ``step`` is a
    0-d int64 tensor: a captured graph reads it at each replay."""
    dev = step.device
    key = _mix32((step & _MASK32) ^ _mix32(int(seed) & _MASK32))
    r = _mix32(key ^ torch.arange(rows, dtype=torch.long, device=dev))
    return _mix32(r[:, None] ^ torch.arange(cols, dtype=torch.long,
                                            device=dev)[None, :])


def sample_tokens(logits, step, *, temperature: float, top_k: int = 0,
                  seed: int = 0):
    """A token for each row of (rows, vocab) ``logits`` drawn from
    softmax(logits / temperature) over the ``top_k`` largest (all when 0;
    ties with the k-th kept), as the reference's ``DecodeEngine._select``
    at ``temperature > 0``.  It is the Gumbel-max argmax of logits /
    temperature + Gumbel noise, the noise a function of (``seed``,
    ``step``, row, vocabulary index) alone (:func:`sample_hash`), so a
    replayed graph draws fresh noise at each step and a stream does not
    depend on how it is cut into blocks."""
    x = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = x.masked_fill(x < kth, float("-inf"))
    h = sample_hash(seed, step, x.shape[0], x.shape[1])
    # the top 23 bits: v + 0.5 is exact in float32 for v < 2^23, so u
    # lies in [2^-24, 1 - 2^-24] and the Gumbel noise is finite (with 24
    # bits, 2^24 - 0.5 rounds to 2^24: u = 1, noise +inf, and a masked
    # -inf column would score NaN)
    u = ((h >> 9).float() + 0.5) * 2.0 ** -23
    return torch.argmax(x - torch.log(-torch.log(u)), dim=-1)


class PrefillEngine:
    """Bucketed (and, past ``max_bucket``, chunked) prefill.

    ``min_bucket``: smallest pow2 length bucket.  ``max_bucket``: prompts
    whose bucket exceeds it are prefilled in fixed ``max_bucket``-token
    chunks.  The batch is rounded up to a power of two as well.
    """

    def __init__(self, model: Model, params, *, min_bucket: int = 32,
                 max_bucket: Optional[int] = None):
        require_token_only(model.cfg, "the serving engines")
        self.model = model
        self.params = params
        self.device = _device_of(params)
        self.min_bucket = next_pow2(min_bucket)
        if max_bucket is not None and next_pow2(max_bucket) != max_bucket:
            raise ValueError("max_bucket must be a power of two")
        self.max_bucket = max_bucket
        self.tokens_prefilled = 0        # valid prompt tokens computed
        # the shapes run, keyed as the reference keys its jit programs
        self._shape_keys = set()

    @property
    def compiles(self) -> int:
        """Distinct prefill shapes run: full prefills (batch, length
        bucket), chunk steps (batch, chunk, index, offset), the carry and
        the epilogue.  The reference compiles one program for each."""
        return len(self._shape_keys)

    def warmup(self, batch_sizes: Sequence[int], lengths: Sequence[int],
               decode: Optional["DecodeEngine"] = None):
        """Run every (batch bucket, length bucket) pair once, and for a
        length past ``max_bucket`` its ``ceil(L / max_bucket)`` chunks
        (which covers every shorter chunked prompt), as the reference's
        warm-up compiles them.  Given the region's ``decode`` engine, then
        warm its paged admission (``warmup_admission``) and its block
        (``warmup_block``, on the card the graph's capture)."""
        shapes = set()
        for n in lengths:
            if self.is_chunked(n):
                C = self.max_bucket
                shapes.add(-(-int(n) // C) * C)
            else:
                shapes.add(self.bucket_for(n))
        for b in sorted({next_pow2(b) for b in batch_sizes}):
            for n in sorted(shapes):
                self.prefill(np.zeros((b, n), np.int32),
                             np.full((b,), n, np.int32))
        if decode is not None and decode.paged:
            decode.warmup_admission(batch_sizes, lengths)
        if decode is not None:
            decode.warmup_block()

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
            self._shape_keys.add(("prefill",) + toks.shape)
            with torch.no_grad():
                logits, caches = self.model.prefill(
                    self.params, {"tokens": self._tensor(toks).long(),
                                  "lengths": self._tensor(lens)})
                first = torch.argmax(logits, dim=-1).to(torch.int32)
            first = first.cpu().numpy()[:B]
            self.tokens_prefilled += int(lens[:B].sum())
        return first, caches, time.perf_counter() - t0

    def start_chunked(self, tokens: np.ndarray, lengths=None
                      ) -> "ChunkedPrefill":
        """Begin a chunked prefill the scheduler advances one chunk per
        tick.  The prompt batch must be past ``max_bucket``."""
        toks, lens, B, chunked = self._pad(tokens, lengths)
        if not chunked:
            raise ValueError("prompt fits a plain bucket; use prefill()")
        return ChunkedPrefill(self, toks, lens, B)

    def start_suffix(self, tokens, prior_caches, cached_len: int
                     ) -> "ChunkedPrefill":
        """Suffix-only prefill of a device prefix hit: tokens [cached_len,
        L) as chunks over ``prior_caches``, positions offset by
        ``cached_len`` (the chunk path masks exactly as a full prefill
        would, so tokens and merged caches match; only the cached prefix's
        compute is skipped).  Batch of 1, scheduled like a chunked unit."""
        suffix = np.asarray(tokens, np.int32).reshape(-1)[cached_len:]
        n_suffix = int(suffix.shape[0])
        if n_suffix <= 0:
            raise ValueError("suffix prefill needs >= 1 uncached token")
        C = self.bucket_for(n_suffix)
        if self.max_bucket is not None:
            C = min(C, self.max_bucket)
        toks = np.zeros((1, -(-n_suffix // C) * C), np.int32)
        toks[0, :n_suffix] = suffix
        return ChunkedPrefill(self, toks, np.array([n_suffix], np.int32), 1,
                              caches=prior_caches, pos_offset=cached_len,
                              chunk=C)


class ChunkedPrefill:
    """One in-flight chunked prefill, advanced a fixed-shape chunk at a time.

    ``step()`` runs one ``max_bucket``-token chunk through
    ``model.prefill_chunk`` and folds the chunk's hidden states into the
    (B, 1, d) last-valid-hidden carry; ``finish()`` computes the first
    decode token from the carry.  Wall time accumulates across steps.

    A suffix prefill (``PrefillEngine.start_suffix``) starts from prior
    ``caches`` covering [0, ``pos_offset``): chunk positions start there and
    ``lens`` count suffix tokens.  A table-direct prior (GQA pool pages and
    block table, ``paged.build_prior``) is stripped from the caches
    ``finish()`` returns, which keep the suffix rows and the ``off``
    marker."""

    def __init__(self, eng: PrefillEngine, toks: np.ndarray,
                 lens: np.ndarray, n_valid: int, *, caches=None,
                 pos_offset: int = 0, chunk: Optional[int] = None):
        self.eng = eng
        self.toks = toks                     # (Bb, Sb), Sb = n_chunks * C
        self.lens = lens
        self.n_valid = n_valid
        self.C = eng.max_bucket if chunk is None else chunk
        self.n_chunks = toks.shape[1] // self.C
        self.i = 0
        self.caches = caches
        self.off = int(pos_offset)
        self.table_direct = caches is not None and _has_leaf(caches, "pk")
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
        eng._shape_keys.add(("chunk", Bb, C, i, self.off)
                            + (("paged",) if self.table_direct else ()))
        eng._shape_keys.add(("carry", Bb, C))
        pos = np.repeat(np.arange(self.off + i * C, self.off + (i + 1) * C,
                                  dtype=np.int32)[None], Bb, axis=0)
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
        self.eng._shape_keys.add(("finish", Bb))
        with torch.no_grad():
            logits = self.eng.model.last_logits(
                self.eng.params, self._last,
                torch.ones((Bb,), dtype=torch.int32, device=self._last.device))
            first = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.eng.tokens_prefilled += int(self.lens[:self.n_valid].sum())
        self.wall_s += time.perf_counter() - t0
        caches = self.caches
        if self.table_direct:
            caches = _strip_prior_pages(caches)
        return first[:self.n_valid], caches


class DecodeEngine:
    """Slot-based continuous-batching decode over dense per-slot caches or
    (``paged=True``) shared page pools; greedy, or sampled at
    ``temperature > 0`` from the ``top_k`` largest logits (0: all) with
    the noise of step ``i`` of a block keyed by (``seed``, tokens emitted
    before the block + ``i``), as the reference's ``fold_in(key, step0 +
    i)``.

    On the card the decode block is one CUDA graph, captured once (by
    ``warmup_block``, or after the first block, which runs eagerly as the
    capture's warm-up) and replayed by every later block: it reads its
    inputs from static device buffers that each block fills from the host
    arrays, and reads and writes the engine's own caches in place.  A
    failed capture raises.  ``graphs=False`` runs the block eagerly (for
    comparisons in tests and ``chip_smoke.py``, as ``use_kernels=False``);
    so does a CPU engine.

    Paged: the attention leaves are pools of ``pool``'s pages (default: as
    many as the dense layout's ``num_slots * capacity`` tokens) plus one
    sink page; each slot maps its logical pages to pool pages through its
    row of ``table_seq``.  Admission allocates the request's pages (a
    pinned prefix, ``req.device_pin``, is mapped read-only instead of
    rewritten), ``_ensure_pages`` grows each slot's table before a block,
    and retirement releases its references: prompt pages the prefix cache
    registered stay LRU-resident, the rest free at once."""

    def __init__(self, model: Model, params, num_slots: int, capacity: int,
                 block_size: int = 8, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, paged: bool = False,
                 pool: Optional[BlockPool] = None, page_tokens: int = 16,
                 spec_k: int = 0, spec_ngram: int = 2, graphs: bool = True):
        require_token_only(model.cfg, "the serving engines")
        self.spec_k = max(0, int(spec_k))
        self.spec_ngram = max(1, int(spec_ngram))
        if self.spec_k and temperature > 0.0:
            raise ValueError("speculative decode verifies the longest "
                             "greedy-matching prefix; it requires "
                             "temperature=0 (got spec_k "
                             f"{spec_k}, temperature {temperature})")
        if self.spec_k:
            # the SWA ring rollback restores the q = spec_k + 1 rows a
            # verify rewrites, distinct only while q fits the ring
            w_min = min([min(b.mixer.window, capacity)
                         for g in model.cfg.groups for b in g.blocks
                         if getattr(b.mixer, "kind", "") == "swa"
                         and getattr(b.mixer, "window", 0) > 0]
                        or [capacity])
            if self.spec_k + 1 > w_min:
                raise ValueError(f"spec_k + 1 = {self.spec_k + 1} exceeds "
                                 f"the smallest SWA ring buffer ({w_min})")
        self.model = model
        self.params = params
        self.device = _device_of(params)
        self.num_slots = num_slots
        self.capacity = capacity
        self.block_size = max(1, int(block_size))
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self._steps = 0                # tokens-emitted counter (noise key)
        self.paged = bool(paged)
        if self.paged:
            if pool is None:
                pool = BlockPool(num_slots * capacity // page_tokens,
                                 page_tokens)
            if pool.block_tokens != page_tokens:
                raise ValueError(f"pool block_tokens {pool.block_tokens} != "
                                 f"page_tokens {page_tokens}")
            if (self.device.type == "cuda" and model.cfg.dtype == "bfloat16"
                    and paged_mod.has_paged_prefill(model.cfg)):
                # refused here, not at the first prefix-hit suffix prefill
                require_bf16_pages("DecodeEngine", page_tokens)
            self.pool = pool
            lay = paged_mod.paged_layout(model.cfg, capacity, page_tokens,
                                         pool.num_blocks)
            self._layout = lay
            self.caches = paged_mod.init_paged_cache(model.cfg, num_slots,
                                                     lay, self.device)
            # device bytes of one pool page across every paged leaf
            self.page_bytes = paged_mod.page_bytes(model.cfg, lay)
            # host-side block tables; retired / empty rows name the sink
            self.table_seq = np.full((num_slots, lay.seq_cols), lay.sink,
                                     np.int32)
            self.table_ring = np.full((num_slots, lay.ring_cols), lay.sink,
                                      np.int32)
            self._slot_shared: List[List[int]] = [[] for _ in range(num_slots)]
            self._slot_owned: List[List[int]] = [[] for _ in range(num_slots)]
            self._seq_pages: List[List[int]] = [[] for _ in range(num_slots)]
            # deployment hook: prefix-cache registration at admission (the
            # pages' content is final then); fn(req, prompt_len, seq_ids,
            # snapshot)
            self.on_admit = None
            self.page_fail_retires = 0
            # set by deployments that admit offloaded prefills in their int8
            # wire form (dequantized inside the page write)
            self.wire_admission = False
            # page-write shapes, keyed as the reference keys its scatter
            # programs
            self._admit_keys = set()
        else:
            self.caches = model.init_cache(num_slots, capacity, self.device)
        self._warming = False            # hooks muted during warm-ups
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
        # the block's static device inputs and output
        dev = self.device
        self._tok_in = torch.zeros((num_slots,), dtype=torch.long, device=dev)
        self._len_in = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=dev)
        if self.paged:
            self._tbl_in = torch.as_tensor(self.table_seq, device=dev).clone()
            self._ring_in = torch.as_tensor(self.table_ring,
                                            device=dev).clone()
        self._step_in = torch.zeros((), dtype=torch.long, device=dev)
        self._out = torch.zeros((self.block_size, num_slots),
                                dtype=torch.int32, device=dev)
        # speculative decode: the accept telemetry; each slot's history
        # (prompt + accepted stream) for the n-gram drafter, on the host
        # and on the device, there with a trash column where the rejected
        # and out-of-range history writes land
        self.verify_rounds = 0
        self.accepted_tokens = 0
        if self.spec_k:
            q = self.spec_k + 1
            self._hist = np.zeros((num_slots, capacity), np.int32)
            self._hist_in = torch.zeros((num_slots, capacity + 1),
                                        dtype=torch.long, device=dev)
            # each round's predictions (q) and accept count, one buffer so
            # the block reaches the host in one copy
            self._spec_out = torch.zeros((self.block_size, num_slots, q + 1),
                                         dtype=torch.int32, device=dev)
            # the O(1) mixer leaves after each verify step and the SWA ring
            # rows it overwrites, for the commit
            self._pending = model.verify_buffers(self.caches, q, num_slots,
                                                 paged=self.paged)
        self.graphs = bool(graphs)
        self._graph = None
        self._graph_launches = None      # kernel launches of one replay
        self._captures = 0

    @property
    def block_compiles(self) -> int:
        """CUDA graphs captured for the plain decode block: 1 once the
        first has been, for good (0 on the CPU, with ``graphs=False`` and
        on a speculative engine)."""
        return 0 if self.spec_k else self._captures

    @property
    def spec_compiles(self) -> int:
        """CUDA graphs captured for the speculative block (0 on the CPU,
        with ``graphs=False`` and at ``spec_k = 0``)."""
        return self._captures if self.spec_k else 0

    @property
    def accepted_tokens_per_dispatch(self) -> float:
        """Mean tokens emitted per verify round (1.0 for the plain
        path)."""
        if self.verify_rounds == 0:
            return 1.0
        return self.accepted_tokens / self.verify_rounds

    @property
    def admit_compiles(self) -> int:
        """Distinct paged page-write shapes admitted (pow2 page count x
        pow2 ring page count x pow2 entry count x wire form), as the
        reference counts its scatter programs; 0 for the dense layout."""
        return len(self._admit_keys) if self.paged else 0

    def free_slots(self) -> List[int]:
        return list(self._free)

    def admit(self, req: Request, first_token: int, one_cache,
              prompt_len: int) -> bool:
        """Place one request's shipped KV into a free slot."""
        return self.admit_many([(req, first_token, one_cache,
                                 prompt_len)]) == 1

    def _start(self, slot: int, req: Request, first_token: int,
               prompt_len: int):
        self.lengths[slot] = prompt_len
        self.tokens[slot] = first_token
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens
        self.slot_req[slot] = req.rid
        self.outputs[req.rid] = Response(req.rid, [int(first_token)])
        if self.spec_k:
            # the drafter's history: the prompt, then the first token
            self._hist[slot, :] = 0
            L = min(prompt_len, self.capacity)
            self._hist[slot, :L] = np.asarray(req.tokens[:L], np.int32)
            if prompt_len < self.capacity:
                self._hist[slot, prompt_len] = first_token
        if not self._warming:
            self._admit_wall[req.rid] = time.perf_counter()

    def admit_many(self, entries: Sequence[Tuple]) -> int:
        """entries: [(req, first_token, one_cache, prompt_len), ...].
        Admits up to the number of free slots, in order, and returns the
        number admitted.  Dense: each request's prefill cache (batch of 1)
        is zero-padded to capacity and written into its slot.  Paged: only
        the request's pages are written, and admission also needs pool
        pages, so it may admit fewer than the free slots."""
        if self.paged:
            return self._admit_paged(entries)
        n = min(len(entries), len(self._free))
        take = list(entries[:n])
        slots = [self._free.popleft() for _ in range(n)]
        for slot, (req, first_token, cache, prompt_len) in zip(slots, take):
            placed = prepare_decode_caches(self.model.cfg, cache,
                                           self.capacity)
            tree_map(lambda buf, new: buf[:, slot].copy_(new[:, 0]),
                     self.caches, placed)
            self._start(slot, req, first_token, prompt_len)
        return n

    # ---------------------------------------------------------- paged admit
    def _write_pages(self, payload, ids: List[int], ring_ids: List[int],
                     slot: int):
        """Write one admitted request into the pools in place: its new
        pages land at ``ids`` in every append-only attention layer's pool
        and its ring pages at ``ring_ids`` in every SWA layer's
        (``index_copy_``), its linear state in its slot.  Wire-form pages
        (int8 + scale) dequantize here with the reference's op chain
        (int8 -> float32, times the float32 scale, cast to the pool dtype),
        so the pool bytes equal a dense admission's."""
        dev = self.device
        for gi, g in enumerate(self.model.cfg.groups):
            pools = self.caches["groups"][gi]
            state = payload["state"][gi]
            for part, at in (("seq", ids), ("ring", ring_ids)):
                idx = torch.as_tensor(at, dtype=torch.long, device=dev)
                for key, pages in (payload[part][gi] or {}).items():
                    for name, pg in pages.items():
                        buf = pools[key][name]
                        if paged_mod.is_wire(pg):
                            pg = pg["q"].float() * pg["scale"].float()
                        dim = 2 if buf.dim() == 5 else 1   # k/v vs latent
                        buf.index_copy_(dim, idx, pg.to(buf.dtype))
            for key, leaves in (state or {}).items():
                tree_map(lambda new, buf: buf[:, slot].copy_(new[:, 0]),
                         leaves, {n: pools[key][n] for n in leaves})

    def _admit_paged(self, entries: Sequence[Tuple]) -> int:
        lay = self._layout
        T = lay.page_tokens
        taken = []
        for req, first, cache, L in entries[:len(self._free)]:
            pin = req.device_pin
            c = pin.cached_len if pin is not None else 0
            need = -(-(L - c) // T) if lay.seq_cols else 0
            ids = self.pool.allocate(need + lay.ring_cols, PREFIX)
            if ids is None:
                break                    # pool exhausted: request stays ready
            taken.append((req, first, cache, L, pin, c, list(ids[:need]),
                          list(ids[need:])))
        if taken:
            n_ids = sum(len(t[6]) for t in taken)
            n_ring = sum(len(t[7]) for t in taken)
            # ring pages dequantize before the write: only int8 seq pages
            # make another write program
            self._admit_keys.add((next_pow2(n_ids) if n_ids else 0,
                                  next_pow2(n_ring) if n_ring else 0,
                                  next_pow2(len(taken)),
                                  n_ids > 0 and all(_has_leaf(t[2], "q")
                                                    for t in taken)))
        for req, first, cache, L, pin, c, ids, ring_ids in taken:
            slot = self._free.popleft()
            payload = paged_mod.build_admit_payload(self.model.cfg, cache,
                                                    lay, c, L)
            self._write_pages(payload, ids, ring_ids, slot)
            shared = list(pin.seq_ids) if pin is not None else []
            seq_all = shared + ids
            self.table_seq[slot, :] = lay.sink
            self.table_seq[slot, :len(seq_all)] = seq_all
            self.table_ring[slot, :] = lay.sink
            self.table_ring[slot, :len(ring_ids)] = ring_ids
            self._slot_shared[slot] = shared
            self._slot_owned[slot] = ids + ring_ids
            self._seq_pages[slot] = seq_all
            self._start(slot, req, first, L)
            if self.on_admit is not None and not self._warming:
                snap = ({"ring": payload["ring"], "state": payload["state"]}
                        if L % T == 0 else None)
                self.on_admit(req, L, seq_all, snap)
        return len(taken)

    def _ensure_pages(self):
        """Before a decode block: grow each active slot's seq table to cover
        the block's writes.  A slot the pool cannot serve retires truncated
        (the paged counterpart of the dense capacity wall)."""
        lay = self._layout
        if not lay.seq_cols:
            return
        T = lay.page_tokens
        # a speculative block advances up to spec_k + 1 tokens a round
        stride = self.block_size * (self.spec_k + 1)
        for slot in np.where(self.active)[0]:
            end = min(int(self.lengths[slot]) + stride, self.capacity)
            need = -(-end // T)
            have = len(self._seq_pages[slot])
            if need <= have:
                continue
            ids = self.pool.allocate(need - have, PREFIX)
            if ids is None:
                self.page_fail_retires += 1
                self._retire(int(slot), force_truncate=True)
                continue
            self.table_seq[slot, have:need] = ids
            self._seq_pages[slot].extend(ids)
            self._slot_owned[slot].extend(ids)

    def _retire(self, slot: int, force_truncate: bool = False):
        rid = self.slot_req[slot]
        resp = self.outputs[rid]
        resp.finished = True
        # at the KV-capacity wall with budget left, or out of pool pages
        # mid-stream: not a clean finish
        truncated = force_truncate or (self.lengths[slot] >= self.capacity - 1
                                       and self.budget[slot] > 0)
        resp.truncated = bool(truncated)
        self.truncations += int(truncated)
        t_admit = self._admit_wall.pop(rid, None)
        if t_admit is not None and not self._warming:
            n_tok = len(resp.output_tokens)
            self.tbt_s.append((time.perf_counter() - t_admit)
                              / max(1, n_tok - 1))
        self.active[slot] = False
        self.slot_req[slot] = None
        self._free.append(slot)
        if self.paged:
            # drop the prefix pins and the slot's own pages: registered
            # prompt pages stay LRU-resident for later hits, decode-tail
            # and ring pages free at once; the table rows name the sink, so
            # the slot's writes in later blocks land where no live request
            # reads
            self.pool.release(self._slot_shared[slot])
            self.pool.release(self._slot_owned[slot])
            self._slot_shared[slot] = []
            self._slot_owned[slot] = []
            self._seq_pages[slot] = []
            self.table_seq[slot, :] = self._layout.sink
            self.table_ring[slot, :] = self._layout.sink

    def _tables_kw(self):
        """The page arguments of a decode step of the block: the static
        block tables, page size and capacity (none for the dense
        layout)."""
        if not self.paged:
            return {}
        return dict(tables={"seq": self._tbl_in, "ring": self._ring_in},
                    page_tokens=self._layout.page_tokens,
                    capacity=self.capacity)

    def _run_block(self):
        """``block_size`` decode steps from the static input buffers into
        the static output, all on the device: each step's token (argmax or
        sample, keyed by ``_step_in`` + the step) is the next step's input.
        No host sync, so a graph can capture it."""
        kw = self._tables_kw()
        toks, lens = self._tok_in, self._len_in
        with torch.no_grad():
            for i in range(self.block_size):
                logits, self.caches = self.model.decode_step(
                    self.params, toks, self.caches, lens, **kw)
                if self.temperature > 0.0:
                    toks = sample_tokens(logits, self._step_in + i,
                                         temperature=self.temperature,
                                         top_k=self.top_k, seed=self.seed)
                else:
                    toks = torch.argmax(logits, dim=-1)
                self._out[i].copy_(toks)
                lens = lens + 1

    # --------------------------------------------------- speculative decode
    def _draft(self, hist, lens):
        """The n-gram (prompt-lookup) drafter on the device: ``spec_k``
        tokens a slot, what followed the latest earlier occurrence of the
        last ``spec_ngram`` tokens of ``hist[b, :lens[b] + 1]`` (prompt +
        accepted stream).  A slot with no match proposes what lies there;
        a wrong draft costs only its rejection.  hist (B, C) long, lens
        (B,) long; returns (B, spec_k) long."""
        n, k = self.spec_ngram, self.spec_k
        B, C = hist.shape
        pos = torch.arange(C, device=hist.device)[None]
        ok = (pos >= n - 1) & (pos < lens[:, None])
        for d in range(n):
            shifted = hist if d == 0 else F.pad(hist, (d, 0))[:, :C]
            tgt = hist.gather(1, torch.clamp(lens[:, None] - d, 0, C - 1))
            ok &= shifted == tgt
        j = torch.where(ok, pos, -1).max(dim=1).values        # latest or -1
        cols = torch.clamp(j[:, None] + 1 + torch.arange(
            k, device=hist.device)[None], 0, C - 1)
        return hist.gather(1, cols)

    def _run_spec_block(self):
        """``block_size`` draft -> verify -> accept -> commit rounds from
        the static inputs into ``_spec_out``, all on the device, as the
        reference's ``_spec_round`` under a scan: step j's prediction is
        held against draft j, ``accept`` is the matching prefix's length,
        and the prediction after the last accepted draft rides along, so a
        round emits accept + 1 tokens and a slot's length advances by as
        many.  The history takes the accepted predictions at ``lens + 1 +
        j``; the rest land in its trash column.  No host sync, so a graph
        can capture it."""
        kw = self._tables_kw()
        k, q, C = self.spec_k, self.spec_k + 1, self.capacity
        toks, lens, hist = self._tok_in, self._len_in, self._hist_in
        step = torch.arange(q, device=self.device)[None]
        with torch.no_grad():
            for r in range(self.block_size):
                drafts = self._draft(hist[:, :C], lens.long())
                seq = torch.cat([toks[:, None], drafts], dim=1)
                logits, self.caches, _ = self.model.decode_verify(
                    self.params, seq, self.caches, lens,
                    pending=self._pending, **kw)
                preds = torch.argmax(logits, dim=-1)              # (B, q)
                match = (preds[:, :k] == drafts).int()
                accept = torch.cumprod(match, dim=1).sum(dim=1)   # (B,)
                self.model.commit_verify(self.caches, self._pending, accept)
                toks = preds.gather(1, accept[:, None].long())[:, 0]
                col = lens.long()[:, None] + 1 + step
                hist.scatter_(1, torch.where(
                    (step <= accept[:, None]) & (col < C), col, C), preds)
                self._spec_out[r, :, :q].copy_(preds)
                self._spec_out[r, :, q].copy_(accept)
                lens = lens + (accept + 1).to(lens.dtype)

    def _capture(self, run):
        """Run the block (``run``) once eagerly on a side stream (kernel
        builds, ``cudaFuncSetAttribute`` and allocator growth happen there,
        outside the capture), then capture it.  A capture launches nothing,
        so the launches the wrappers count during it are kept for the
        replays."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _build.captured_launches() as rec, torch.cuda.graph(graph):
            run()
        self._graph, self._graph_launches = graph, rec
        self._captures += 1

    def _block(self, tokens, lengths):
        """One block from host ``tokens`` / ``lengths`` (the block tables,
        the tokens emitted before it, which key the sampling noise, and on
        a speculative engine the drafter's history): the static inputs are
        filled, the graph replayed (the first block on the card runs
        eagerly and captures it; a CPU or ``graphs=False`` engine runs
        eagerly), and the block's output reaches the host once: the (block,
        slots) tokens, or on a speculative engine the (block, slots,
        spec_k + 2) predictions with each round's accept count last."""
        self._tok_in.copy_(torch.from_numpy(tokens))
        self._len_in.copy_(torch.from_numpy(lengths))
        if self.paged:
            self._tbl_in.copy_(torch.from_numpy(self.table_seq))
            self._ring_in.copy_(torch.from_numpy(self.table_ring))
        if self.temperature > 0.0:
            self._step_in.fill_(self._steps)
        if self.spec_k:
            self._hist_in[:, :self.capacity].copy_(
                torch.from_numpy(self._hist))
        run, out = ((self._run_spec_block, self._spec_out) if self.spec_k
                    else (self._run_block, self._out))
        if self._graph is not None:
            self._graph.replay()
            _build.LAUNCHES.update(self._graph_launches)
        elif self.graphs and self.device.type == "cuda":
            self._capture(run)
        else:
            run()
        return out.to("cpu", copy=True).numpy()

    def warmup_block(self):
        """One throwaway block with every slot inactive (tokens and lengths
        0), as the reference's warm-up: dense garbage lands in rows a later
        admission rewrites, paged writes in the sink page that every table
        row names.  On the card this is the capture, so no block captures
        after it (``block_compiles``, or ``spec_compiles`` on a speculative
        engine, stays 1).  Raises when a slot is active: the block would
        overwrite its state."""
        if self.active.any():
            raise RuntimeError("warmup_block needs every slot inactive")
        zeros = np.zeros((self.num_slots,), np.int32)
        self._block(zeros, zeros)

    def warmup_admission(self, batch_sizes: Sequence[int],
                         lengths: Sequence[int]):
        """Paged admission of the traffic's shapes before traffic:
        zero-payload requests (and their int8 wire form when
        ``wire_admission`` is set) are admitted into real slots and retired
        at once, so the pool round-trips (allocated == freed) and no hook,
        output or TBT sample is left behind.  A no-op for the dense
        layout."""
        if not self.paged:
            return
        self._warming = True
        try:
            for b in sorted({next_pow2(min(int(x), self.num_slots))
                             for x in batch_sizes}):
                for n in sorted({int(x) for x in lengths}):
                    payload = paged_mod.zero_request_payload(
                        self.model.cfg, n, self.device)
                    payloads = [payload]
                    if self.wire_admission:
                        payloads.append(quantize_cache_for_wire(payload)[0])
                    for p in payloads:
                        self.admit_many([
                            (Request(rid=-(10_000 + i),
                                     tokens=np.zeros((n,), np.int32),
                                     max_new_tokens=1), 0, p, n)
                            for i in range(b)])
                        for slot in range(self.num_slots):
                            rid = self.slot_req[slot]
                            if rid is not None and rid <= -10_000:
                                self._retire(slot)
                                self.outputs.pop(rid, None)
        finally:
            self._warming = False

    def step(self):
        """One eager decode step of every active slot, one host round trip
        per token (the reference's baseline for ``step_block``).  Dense
        only: the paged engine grows its pages per block.  Returns
        #active."""
        if self.paged:
            raise RuntimeError("the paged engine decodes in blocks "
                               "(page growth is per-block); use step_block")
        if not self.active.any():
            return 0
        with torch.no_grad():
            logits, self.caches = self.model.decode_step(
                self.params, torch.as_tensor(self.tokens,
                                             device=self.device).long(),
                self.caches, torch.as_tensor(self.lengths,
                                             device=self.device))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i in range(self.num_slots):
            if not self.active[i]:
                continue
            self.outputs[self.slot_req[i]].output_tokens.append(int(nxt[i]))
            self.lengths[i] += 1
            self.tokens[i] = nxt[i]
            self.budget[i] -= 1
            if self.budget[i] <= 0 or self.lengths[i] >= self.capacity - 1:
                self._retire(i)
        return int(self.active.sum())

    def step_block(self):
        """Advance every active stream by up to ``block_size`` tokens with
        one host sync.  Returns #active.

        Inactive slots decode garbage into cache rows a later admission
        rewrites (paged: into the sink page); streams that reach their
        budget or the capacity wall mid-block keep only their valid
        tokens."""
        if not self.active.any():
            return 0
        if self.paged:
            self._ensure_pages()          # may retire page-starved slots
            if not self.active.any():
                return 0
        if self.spec_k:
            return self._step_block_spec()
        t0 = time.perf_counter()
        toks = self._block(self.tokens, self.lengths)  # (block, num_slots)
        self._steps += self.block_size
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

    def _step_block_spec(self):
        """Speculative ``step_block``: ``block_size`` verify rounds in one
        block, each emitting 1..spec_k + 1 tokens a slot, unpacked on the
        host into variable-stride budget, length and retire accounting.  A
        slot whose budget or capacity wall lands inside its stream keeps
        only the valid prefix and retires, so the device's frontier stays
        exact for the slots that continue."""
        t0 = time.perf_counter()
        out = self._block(self.tokens, self.lengths)
        q = self.spec_k + 1
        preds, accepts = out[..., :q], out[..., q]
        idx = np.where(self.active)[0]
        wall = time.perf_counter() - t0
        self.decode_wall_s += wall
        self.slot_busy_s += len(idx) * wall
        self.verify_rounds += int(accepts[:, idx].size)
        self.accepted_tokens += int((accepts[:, idx] + 1).sum())
        for i in idx:
            stream = np.concatenate([preds[r, i, :accepts[r, i] + 1]
                                     for r in range(preds.shape[0])])
            valid = int(np.clip(min(self.budget[i],
                                    self.capacity - 1 - self.lengths[i]),
                                1, len(stream)))
            take = stream[:valid]
            self.outputs[self.slot_req[i]].output_tokens.extend(
                int(t) for t in take)
            L = int(self.lengths[i])
            hi = min(L + 1 + valid, self.capacity)
            self._hist[i, L + 1:hi] = take[:max(0, hi - (L + 1))]
            self.tokens[i] = take[-1]
            self.lengths[i] += valid
            self.budget[i] -= valid
            self.tokens_out += valid
            if self.budget[i] <= 0 or self.lengths[i] >= self.capacity - 1:
                self._retire(int(i))
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
        pin = req0.device_pin
        if pin is not None and pin.cached_len > 0 and self.decode.paged:
            # device prefix hit: prefill only the uncached suffix, reading
            # the cached prefix straight out of the pinned pool pages
            self.queue.popleft()
            dec = self.decode
            prior = paged_mod.build_prior(
                dec.model.cfg, dec.caches, dec._layout, pin.seq_ids,
                None if pin.snapshot is None else pin.snapshot.payload,
                pin.cached_len, table_direct=True)
            lengths = np.array([len(req0.tokens)], np.int32)
            self._inflight = (e0.start_suffix(req0.tokens, prior,
                                              pin.cached_len),
                              [req0], lengths)
            self._prefill_one()              # its first chunk runs now
            return
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

    def stats(self) -> dict:
        return {"boundaries": self.boundaries,
                "max_admit_wait": self.max_admit_wait,
                "starved_boundaries": self.starved_boundaries,
                "occupancy": self.occupancy(),
                "goodput_tok_s": self.goodput_tok_s(),
                "tokens_out": self.decode.tokens_out,
                "truncations": self.decode.truncations,
                "accepted_tokens_per_dispatch":
                    self.decode.accepted_tokens_per_dispatch}


def _has_leaf(tree, name: str) -> bool:
    if isinstance(tree, dict):
        return name in tree or any(_has_leaf(v, name) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_leaf(v, name) for v in tree)
    return False


def _strip_prior_pages(node):
    """Drop the table-direct prior operands (pool page leaves + block
    table) from a finished suffix prefill's caches, keeping the dense
    suffix rows and the ``off`` start marker."""
    if isinstance(node, dict):
        return {k: _strip_prior_pages(v) for k, v in node.items()
                if k not in ("pk", "pv", "tbl")}
    if isinstance(node, list):
        return [_strip_prior_pages(v) for v in node]
    return node


def trim_request_cache(caches, idx: int, length: int):
    """Request ``idx`` of a bucket-padded batched prefill cache, with its
    sequence leaves (k/v/ckv/kpe) trimmed to ``length``: the bytes that
    cross the wire.  O(1) state leaves pass through (batch of 1).

    A block carrying an ``off`` marker (table-direct suffix prefill) holds
    only rows [off, length) in its sequence leaves, so those trim to
    ``length - off``."""
    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        off = int(node["off"].reshape(-1)[0]) if "off" in node else 0
        return {name: cut(name, v, off) if isinstance(v, torch.Tensor)
                else walk(v) for name, v in node.items()}

    def cut(name, leaf, off):
        leaf = leaf[:, idx:idx + 1]
        if name in _SEQ_LEAVES:
            leaf = leaf[:, :, :min(max(length - off, 0), leaf.shape[2])]
        return leaf.contiguous()

    return walk(caches)
