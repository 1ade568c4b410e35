"""The port's in-place wire encode of one request
(``kvcache.encode_request_for_wire``) against the reference's trim and
int8 encode (``serving.engine.trim_request_cache`` then
``models.kvcache.quantize_cache_for_wire``), on the CPU: byte-identical
wire pytrees, with the reference's Pallas kernel in interpret mode and
with its plain version, on the prefill caches of smoke ``kimi-linear-1t``
(MLA ckv / kpe beside KDA state and conv), ``mistral-nemo-12b`` (GQA k /
v), ``zamba2-1.2b`` (the shared block's k / v beside Mamba2 state and
conv), ``h2o-danube-1.8b`` (ring k / v), ``xlstm-350m`` (no wire leaf:
mLSTM's state and conv and sLSTM's nested state ship as they are),
``llama4-scout-17b-a16e`` (GQA k / v beside a MoE) and ``mixtral-8x22b``
(ring k / v beside a MoE), in
bf16 and float32, for each request of a padded batch and of a
chunked prefill.  The caches' structure comes from the port's prefill;
their values are drawn from a numpy seed and reach both frameworks as
the same bytes.

Then the kernel's leaf table, checked without CUDA: each entry's address,
segments, stride and length name exactly the trimmed leaf's elements
(widths 472, 64, 80 and 257, starts off the 16-byte grid), and the
blocks of the launch plan, walked as the kernel walks them, cover each
element once.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_identical
from repro.kernels import ops as jops
from repro.models.kvcache import cache_num_bytes as jax_num_bytes
from repro.models.kvcache import quantize_cache_for_wire as jax_quantize
from repro.serving import engine as jeng
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import quantize as kq
from repro_torch.models import Model
from repro_torch.models.kvcache import (WIRE_LEAVES, cache_num_bytes,
                                        encode_request_for_wire)
from repro_torch.params import init_params
from repro_torch.serving.engine import PrefillEngine, trim_request_cache

torch.set_num_threads(1)
ARCHS = ("kimi-linear-1t", "mistral-nemo-12b", "zamba2-1.2b",
         "h2o-danube-1.8b", "xlstm-350m", "llama4-scout-17b-a16e",
         "mixtral-8x22b")
DTYPES = (torch.float32, torch.bfloat16)


def _fill(tree, dtype, seed):
    """``tree`` with every float leaf redrawn from a numpy seed: the wire
    leaves in ``dtype``, the others float32; integer leaves kept."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if not node.dtype.is_floating_point:
            return node
        x = torch.from_numpy(rng.standard_normal(node.shape)
                             .astype(np.float32) * 3.0)
        return x.to(dtype if name in WIRE_LEAVES else torch.float32)

    return walk(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if tree.dtype == torch.bfloat16:          # numpy's bfloat16, same bits
        return jnp.asarray(tree.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


@functools.lru_cache(maxsize=None)
def _caches(arch, lengths, max_bucket=None):
    """The port's bucket-padded prefill cache of a batch of prompts."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    peng = PrefillEngine(Model(cfg), params, min_bucket=32,
                         max_bucket=max_bucket)
    rng = np.random.default_rng(1)
    toks = np.zeros((len(lengths), max(lengths)), np.int32)
    for i, L in enumerate(lengths):
        toks[i, :L] = rng.integers(0, cfg.vocab_size, (L,))
    _, caches, _ = peng.prefill(toks, np.asarray(lengths, np.int32))
    return caches


def _check_against_reference(caches, idx, length):
    wire, nbytes, raw = encode_request_for_wire(caches, idx, length)
    assert raw == cache_num_bytes(trim_request_cache(caches, idx, length))
    jtrim = jeng.trim_request_cache(_to_jax(caches), idx, length)
    assert raw == jax_num_bytes(jtrim)
    jwire, jbytes = jax_quantize(jtrim, use_kernel=False)
    assert nbytes == jbytes
    assert_trees_identical(jwire, wire)
    jops.FORCE_KERNEL_ON_CPU = True           # the Pallas kernel, interpreted
    try:
        kwire, kbytes = jax_quantize(jtrim, use_kernel=True)
    finally:
        jops.FORCE_KERNEL_ON_CPU = False
    assert kbytes == nbytes
    assert_trees_identical(kwire, wire)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_reference(arch, dtype):
    """A padded batch (bucket 32): request 0 fills the bucket, request 1
    stops in between, request 2 holds one token."""
    caches = _fill(_caches(arch, (32, 17, 1)), dtype, seed=2)
    for idx, length in ((0, 32), (1, 17), (2, 1)):
        _check_against_reference(caches, idx, length)


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_chunked_cache_matches_reference(arch):
    """The cache of a chunked prefill (three 32-token chunks), bf16."""
    caches = _fill(_caches(arch, (70, 45), max_bucket=32), torch.bfloat16,
                   seed=3)
    for idx, length in ((0, 70), (1, 45)):
        _check_against_reference(caches, idx, length)


def test_encode_honours_off_marker():
    """A table-direct suffix block holds rows [off, length) only: its k / v
    encode rows [0, length - off), its ``off`` trims like any leaf."""
    rng = np.random.default_rng(4)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    caches = {"groups": [{
        "b0": {"k": leaf(2, 1, 24, 2, 16).to(torch.bfloat16),
               "v": leaf(2, 1, 24, 2, 16).to(torch.bfloat16),
               "off": torch.full((2, 1), 16, dtype=torch.int32)},
        "b1": {"state": leaf(2, 1, 2, 16, 16)}}]}
    for length in (30, 40, 17):
        _check_against_reference(caches, 0, length)


def test_wire_wrapper_takes_cuda_tensors_only():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kq.quantize_int8_wire([kq.whole_leaf(x)])
    with pytest.raises(ValueError, match="contiguous"):
        kq.whole_leaf(x.t())


def test_plain_encode_propagates_nan_and_inf():
    """The plain version's scale is NaN for a leaf holding a NaN and inf for
    one holding an inf, as the reference's."""
    x = np.random.default_rng(5).standard_normal((3, 50)).astype(np.float32)
    for bad, check in ((np.nan, np.isnan), (np.inf, np.isinf)):
        y = x.copy()
        y[1, 7] = bad
        (_, s, _), = kq.quantize_int8_wire_ref(
            [kq.whole_leaf(torch.from_numpy(y))])
        _, js = jops.quantize_wire(jnp.asarray(y), use_kernel=False)
        assert check(float(s)) and check(float(js))


def _walk_blocks(entry, b):
    """The spans (segment, first element, count) block ``b`` covers, as
    ``csrc/quantize.cu``'s ``block_range`` / ``absmax_range`` walk them."""
    segments, length, b0, per = entry[5], entry[7], entry[8], entry[10]
    total = segments * length
    e0 = (b - b0) * per
    e1 = min(e0 + per, total)
    spans, e = [], e0
    while e < e1:
        r, a = divmod(e, length)
        n = min(length - a, e1 - e)
        spans.append((r, a, n))
        e += n
    return spans


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("width", [472, 64, 80, 257])
def test_wire_table_names_trimmed_leaves(width, dtype):
    """Leaves (3, 3, 40, width) and (2, 3, 40, 2, width // 2 or 1) read at
    each request and row count, one of them starting off the 16-byte grid:
    a gather through each table entry is the trimmed leaf, and the plan's
    blocks cover each of its elements once."""
    rng = np.random.default_rng(width)
    n4 = 3 * 3 * 40 * width
    base = torch.from_numpy(rng.standard_normal(n4 + 3).astype(np.float32))
    x4 = base.to(dtype)[3:].view(3, 3, 40, width)   # 3 elements in: unaligned
    h = 2 if width % 2 == 0 else 1
    x5 = torch.from_numpy(rng.standard_normal((2, 3, 40, h, width // h))
                          .astype(np.float32)).to(dtype)
    assert x4.data_ptr() % 16 != 0
    leaves, want = [], []
    for x in (x4, x5):
        for idx, rows in ((0, 40), (1, 17), (2, 1), (1, 0)):
            leaves.append(kq.request_leaf(x, idx, rows))
            want.append(x[:, idx:idx + 1, :rows])
    blocks, nblocks = kq.plan(leaves, sms=132)
    assert nblocks <= 132 * kq.BLOCKS_PER_SM + len(leaves)
    qs = [torch.empty(leaf.shape, dtype=torch.int8) for leaf in leaves]
    work = torch.empty((2 * len(leaves),), dtype=torch.float32)
    table = kq.wire_table(leaves, qs, work[:len(leaves)],
                          work[len(leaves):].view(torch.bfloat16), blocks)
    assert len(table) == 11 * len(leaves)
    first = 0
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        e = table[11 * i:11 * (i + 1)]
        x = leaf.x
        size = x.element_size()
        assert e[1] == qs[i].data_ptr() and e[4] == int(dtype == torch.bfloat16)
        off, rem = divmod(e[0] - x.data_ptr(), size)
        assert rem == 0
        got = torch.as_strided(x, (e[5], e[7]), (e[6], 1),
                               x.storage_offset() + off)
        assert torch.equal(got.reshape(w.shape), w)
        assert torch.equal(kq.gather(leaf), w)
        assert e[8] == first and e[9] >= 1
        first += e[9]
        seen = torch.zeros((e[5], e[7]), dtype=torch.int32)
        for b in range(e[8], e[8] + e[9]):
            for r, a, n in _walk_blocks(e, b):
                seen[r, a:a + n] += 1
        assert bool((seen == 1).all())
    assert first == nblocks


def test_plan_spreads_large_leaves():
    """A mistral-nemo-sized pair of leaves takes the whole grid, shared by
    size; a small leaf keeps at least one block of ``BLOCK_ELEMS``."""
    big = kq.WireLeaf(torch.empty(0), 0, 40, 0, 12000 * 1024, (0,))
    small = kq.WireLeaf(torch.empty(0), 0, 1, 0, 300, (0,))
    blocks, n = kq.plan([big, big, small], sms=132)
    assert n <= 132 * kq.BLOCKS_PER_SM + 3
    assert blocks[0][1] == blocks[1][1] >= 500
    assert blocks[2][1] == 1
    for b0, nb, per in blocks:
        assert per % 16 == 0
