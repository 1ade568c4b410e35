"""The bf16 decode core's launch plan, shape rule and cache addressing, on
the CPU: the pure functions the kernels' wrappers run before a launch
(``repro_torch.kernels.decode_attn``), the split of the live keys into
balanced runs that the kernels derive on the device (mirrored by
``tile_runs`` / ``row_workers``), and a split-then-combine decode built on
that split against the reference's oracle.  The kernels themselves run on
the card (``tests/test_torch_gpu.py``).

Tolerance: float32 2e-5 (sums in other orders), as
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import (TC_GROUP, cache_rows,
                                             require_bf16_decode, row_workers,
                                             split_plan, stream_shape,
                                             tile_runs)

torch.set_num_threads(1)


@pytest.mark.parametrize("Dk,Dv,offset,ok", [
    (536, 472, 0, True),       # absorbed MLA
    (128, 128, 0, True),       # mistral-nemo GQA
    (64, 64, 0, True),         # zamba2 MHA
    (1024, 512, 0, True),      # the widest the wrappers take
    (8, 8, 0, True),
    (36, 64, 0, False),        # not a multiple of 8: 16-byte chunks
    (64, 44, 0, False),
    (1032, 512, 0, False),     # wider than 1024
    (512, 520, 0, False),      # value wider than 512
    (64, 64, 1, False),        # 2 bytes past a 16-byte boundary
])
def test_bf16_decode_shape_rule(Dk, Dv, offset, ok):
    """What the bf16 decode core refuses, checked before any launch (shapes
    and addresses only, so it runs on the CPU)."""
    buf = torch.zeros(72, dtype=torch.bfloat16)
    t = buf[offset:offset + 64]
    assert buf.data_ptr() % 16 == 0
    if ok:
        require_bf16_decode("core", Dk, Dv, t)
    else:
        with pytest.raises(ValueError):
            require_bf16_decode("core", Dk, Dv, t)


@pytest.mark.parametrize("B,Hq,Hkv,Dk,Dv,S,core,heads,tile", [
    (8, 64, 1, 536, 472, 16384, "wgmma", 64, 32),    # kimi MLA
    (8, 128, 1, 1024, 512, 16384, "wgmma", 64, 16),  # Q + 2 stages of 32 too big
    (2, 16, 1, 536, 472, 320, "wgmma", 64, 32),      # G = TC_GROUP
    (8, 32, 8, 128, 128, 16384, "stream", 4, 8),     # mistral-nemo GQA
    (8, 32, 32, 64, 64, 16384, "stream", 1, 16),     # zamba2 MHA
    (3, 4, 1, 48, 32, 100, "stream", 4, 16),
    (2, 8, 1, 536, 472, 100, "stream", 2, 1),        # MLA widths, G 8
    (2, 12, 1, 256, 256, 100, "stream", 8, 4),       # G 12: 8 + 4 heads
])
def test_split_plan_picks_core(B, Hq, Hkv, Dk, Dv, S, core, heads, tile):
    plan = split_plan(B, Hq, Hkv, Dk, Dv, S, torch.bfloat16, 132)
    assert (plan.core, plan.heads, plan.tile) == (core, heads, tile)
    assert (plan.core == "wgmma") == (Hq // Hkv >= TC_GROUP)
    if core == "stream":
        C, XC = stream_shape(Dk, Dv)
        assert C * XC * 8 >= max(Dk, Dv) and plan.heads * XC <= 8
        assert plan.workers % 4 == 0
    # never more workers than tiles the rows could hold (rounded to a block)
    assert plan.workers <= max(4, B * -(-S // tile) + 3)
    acc, ml = plan.scratch(B, Hq, Dv, "cpu")
    assert acc.shape == (plan.workers + B - 1, Hq, Dv)
    assert ml.shape == (plan.workers + B - 1, Hq, 2)


def test_split_plan_float32_keeps_the_simt_plan():
    """float32 keeps decode_core.cuh's plan: G query heads a block (G * Dv
    <= 8192) and key splits per row."""
    plan = split_plan(8, 64, 1, 536, 472, 16384, torch.float32, 132)
    assert (plan.core, plan.heads, plan.tile) == ("simt", 16, 16)
    assert plan.workers == 9          # ceil(2 * 132 / (8 * 4 blocks))
    acc, ml = plan.scratch(8, 64, 472, "cpu")
    assert acc.shape == (8, 64, 9, 472) and ml.shape == (8, 64, 9, 2)


_RUN_CASES = [
    # lengths, S, window, tile, workers
    ((16384, 12001, 9000, 5601, 3800, 1501, 701, 101), 16384, 0, 32, 132),
    ((4000,) * 8, 16384, 0, 8, 200),
    ((4000,) * 8, 16384, 0, 16, 52),
    ((0, 1, 37, 0, 64, 65), 80, 0, 16, 12),         # empty rows, partial tiles
    ((0, 1, 37, 0, 64, 65), 80, 20, 16, 12),        # window
    ((300, 5, 300), 300, 50, 8, 64),                # more workers than tiles
    ((100, 40), 64, 0, 16, 3),                      # lengths past S
    ((7,), 10, 3, 1, 5),
]


@pytest.mark.parametrize("lengths,S,window,tile,workers", _RUN_CASES)
def test_tile_runs_split_every_live_key_once(lengths, S, window, tile,
                                             workers):
    """Every live key falls in exactly one run; runs are whole tiles of
    their row; the workers' loads are within one tile of each other; keys
    outside the window or past the length are never in a run; the partial
    slots (worker + row) are distinct and fit the scratch."""
    runs = tile_runs(lengths, S, window, tile, workers)
    seen = {b: np.zeros(S, np.int64) for b in range(len(lengths))}
    loads, slots = [], []
    for i, segs in enumerate(runs):
        n_tiles = 0
        for b, k0, k1 in segs:
            L = lengths[b]
            lo = max(0, L - window) if window > 0 else 0
            assert lo <= k0 < k1 <= min(L, S)
            assert (k0 - lo) % tile == 0
            assert (k1 - lo) % tile == 0 or k1 == min(L, S)
            seen[b][k0:k1] += 1
            n_tiles += -(-(k1 - k0) // tile)
            slots.append(i + b)
        loads.append(n_tiles)
    for b, L in enumerate(lengths):
        lo = max(0, L - window) if window > 0 else 0
        want = np.zeros(S, np.int64)
        want[lo:min(L, S)] = 1
        np.testing.assert_array_equal(seen[b], want)
    assert max(loads) - min(loads) <= 1
    assert len(set(slots)) == len(slots)
    assert all(0 <= s < workers + len(lengths) - 1 for s in slots)


@pytest.mark.parametrize("lengths,S,window,tile,workers", _RUN_CASES)
def test_row_workers_find_each_rows_runs(lengths, S, window, tile, workers):
    """The combine kernel's range of a row's workers holds exactly the
    workers whose runs meet the row."""
    runs = tile_runs(lengths, S, window, tile, workers)
    counts = []
    for L in lengths:
        lo = max(0, L - window) if window > 0 else 0
        n = min(L, S)
        counts.append(-(-(n - lo) // tile) if n > lo else 0)
    total, first = sum(counts), 0
    for b, count in enumerate(counts):
        want = {i for i, segs in enumerate(runs) if any(r == b for r, *_ in segs)}
        assert set(row_workers(first, count, total, workers)) == want
        first += count


@pytest.mark.parametrize("Hq,Hkv,Dk,Dv,window,tile,workers", [
    (8, 1, 48, 32, 0, 16, 7),       # MQA, Dk != Dv
    (8, 2, 32, 32, 20, 8, 11),      # GQA with a window
    (4, 4, 16, 16, 0, 4, 30),       # MHA, more workers than tiles
])
def test_split_combine_matches_reference(Hq, Hkv, Dk, Dv, window, tile,
                                         workers):
    """The bf16 core's arithmetic on its split, in float64 numpy: each
    worker's (max, sum, unnormalised accumulator) per segment, merged per
    row over ``row_workers``, equals the reference's decode oracle; a row
    with no live key gives 0."""
    r = np.random.default_rng(7)
    B, S = 5, 60
    lengths = np.array([60, 0, 1, 33, 17], np.int32)
    q = r.standard_normal((B, Hq, Dk)).astype(np.float32)
    k = r.standard_normal((B, Hkv, S, Dk)).astype(np.float32)
    v = r.standard_normal((B, Hkv, S, Dv)).astype(np.float32)
    scale = Dk ** -0.5
    G = Hq // Hkv
    runs = tile_runs(lengths, S, window, tile, workers)
    part = {}
    for i, segs in enumerate(runs):
        for b, k0, k1 in segs:
            for h in range(Hq):
                s = k[b, h // G, k0:k1] @ q[b, h].astype(np.float64) * scale
                m = s.max()
                e = np.exp(s - m)
                part[(i + b, h)] = (m, e.sum(), e @ v[b, h // G, k0:k1])
    counts = []
    for L in lengths:
        lo = max(0, L - window) if window > 0 else 0
        counts.append(-(-(min(L, S) - lo) // tile) if min(L, S) > lo else 0)
    total, first = sum(counts), 0
    out = np.zeros((B, Hq, Dv))
    for b, count in enumerate(counts):
        for h in range(Hq):
            got = [part[(i + b, h)] for i in row_workers(first, count, total,
                                                         workers)]
            if got:
                mt = max(m for m, _, _ in got)
                den = sum(np.exp(m - mt) * l for m, l, _ in got)
                out[b, h] = sum(np.exp(m - mt) * a for m, _, a in got) / den
        first += count
    oracle = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths),
                                       window=window)
    np.testing.assert_allclose(out, np.asarray(oracle), atol=2e-5, rtol=2e-5)


def _storage_rows(t, rows, B, H, S):
    """Key rows of ``t`` read as the kernel reads them: row (b, h, j) at
    element (b * rB + h * rH + j * rS) * D of the storage from data_ptr."""
    D = t.shape[-1]
    flat = torch.as_strided(t, (t.untyped_storage().nbytes()
                                // t.element_size() - t.storage_offset(),),
                            (1,))
    rB, rH, rS = rows
    idx = (torch.arange(B)[:, None, None] * rB
           + torch.arange(H)[None, :, None] * rH
           + torch.arange(S)[None, None, :] * rS)
    return flat[(idx[..., None] * D + torch.arange(D)).reshape(-1)].reshape(
        B, H, S, D)


def test_cache_rows_read_the_model_buffers_in_place():
    """gqa_decode passes its (B, S, Hkv, D) buffers through transpose(1,
    2): the kernel's key-row arithmetic reads them in place; a contiguous
    cache and the MLA latent (one head) too; views whose rows differ
    between k and v, or are not contiguous, are refused."""
    g = torch.Generator().manual_seed(0)
    B, S, H, D = 3, 11, 4, 8
    kbuf, vbuf = (torch.randn((B, S, H, D), generator=g) for _ in range(2))
    k, v = kbuf.transpose(1, 2), vbuf.transpose(1, 2)
    rows = cache_rows(k, v)
    assert rows == (S * H, 1, H)
    assert torch.equal(_storage_rows(k, rows, B, H, S), k)
    assert torch.equal(_storage_rows(v, rows, B, H, S), v)
    kc = torch.randn((B, H, S, D), generator=g)
    assert cache_rows(kc, kc) == (H * S, S, 1)
    ckv = torch.randn((B, S, 6 * 8), generator=g)
    kpe = torch.randn((B, S, 8), generator=g)
    k_eff = torch.cat([ckv, kpe], dim=-1)[:, None]
    rows = cache_rows(k_eff, ckv[:, None])
    assert rows == (S, 0, 1)
    assert torch.equal(_storage_rows(ckv[:, None], rows, B, 1, S),
                       ckv[:, None])
    assert cache_rows(k_eff[..., :48], ckv[:, None]) is None   # k rows 56
    assert cache_rows(k, kc) is None                         # strides differ
    assert cache_rows(k[..., ::2], v[..., ::2]) is None      # not contiguous


@pytest.mark.parametrize("window", [0, 5])
def test_decode_on_the_strided_view_equals_the_contiguous_call(window):
    """ops.decode_attention on gqa_decode's strided (B, Hkv, S, D) view of
    its (B, S, Hkv, D) buffers equals the call on contiguous copies, and
    both equal the reference's oracle."""
    r = np.random.default_rng(3)
    B, S, Hkv, G, D = 3, 40, 2, 4, 16
    q = torch.from_numpy(r.standard_normal((B, Hkv * G, D)).astype(np.float32))
    kbuf = torch.from_numpy(r.standard_normal((B, S, Hkv, D)).astype(np.float32))
    vbuf = torch.from_numpy(r.standard_normal((B, S, Hkv, D)).astype(np.float32))
    lengths = torch.tensor([40, 1, 23], dtype=torch.int32)
    k, v = kbuf.transpose(1, 2), vbuf.transpose(1, 2)
    got = ops.decode_attention(q, k, v, lengths, window=window)
    want = ops.decode_attention(q, k.contiguous(), v.contiguous(), lengths,
                                window=window)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    oracle = jref.decode_attention_ref(jnp.asarray(q.numpy()),
                                       jnp.asarray(k.contiguous().numpy()),
                                       jnp.asarray(v.contiguous().numpy()),
                                       jnp.asarray(lengths.numpy()),
                                       window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)
