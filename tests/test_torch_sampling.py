"""Sampled decode (``temperature > 0``, ``top_k``) on the port, on the
CPU, at the smoke size in float32 (``kimi-linear-1t``: KDA + MLA;
``zamba2-1.2b``: Mamba2 + a shared MHA block), dense and paged:

  * a fixed seed is deterministic, and another seed changes the samples
    (the reference's ``tests/test_region_scheduler.py`` checks);
  * ``top_k=1`` gives exactly the reference's greedy tokens;
  * with every request admitted at once, block sizes 2 and 4 give the
    same sampled streams (the noise is keyed by tokens emitted, not by
    dispatch);
  * no sample falls outside the top k of its logits;
  * over many draws of fixed logits the sampler's frequencies match
    softmax(logits / T) over the top k (a chi-square bound at the 0.999
    quantile of its degrees of freedom; the noise is a fixed hash of the
    seed, so the outcome does not vary from run to run).

The reference samples with ``jax.random`` and the port with its own
counter-based noise, so sampled tokens are not compared across the two.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import configs, drawn_params
from repro.models import Model as JaxModel
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.models import Model
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)
SLOTS, CAPACITY, PAGE = 4, 128, 16
LENS, BUDGETS = (24, 40, 33), (9, 12, 7)
ARCHS = ["kimi-linear-1t", "zamba2-1.2b"]
CASES = [(a, p) for a in ARCHS for p in (False, True)]
IDS = [f"{a}-{'paged' if p else 'dense'}" for a, p in CASES]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (L,)).astype(np.int32) for L in LENS]


def _decode(arch, paged, *, block=4, reference=False, **dec_kw):
    """Every prompt prefilled in one batch and admitted at once, then
    drained; {rid: output tokens}."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    if reference:
        eng, model, params, req = (jeng, JaxModel(jcfg, use_kernels=False),
                                   jparams, JaxRequest)
    else:
        eng, model, params, req = teng, Model(tcfg), tparams, Request
    prompts = _prompts()
    lengths = np.array(LENS, np.int32)
    toks = np.zeros((len(prompts), int(lengths.max())), np.int32)
    for i, t in enumerate(prompts):
        toks[i, :len(t)] = t
    first, caches, _ = eng.PrefillEngine(model, params,
                                         min_bucket=32).prefill(toks, lengths)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=block,
                           paged=paged, page_tokens=PAGE, **dec_kw)
    n = dec.admit_many([
        (req(rid=i, tokens=t, max_new_tokens=b), int(first[i]),
         eng.trim_request_cache(caches, i, int(lengths[i])), int(lengths[i]))
        for i, (t, b) in enumerate(zip(prompts, BUDGETS))])
    assert n == len(prompts)
    dec.run_until_drained()
    return {rid: r.output_tokens for rid, r in dec.outputs.items()}


@pytest.mark.parametrize("arch,paged", CASES, ids=IDS)
def test_fixed_seed_is_deterministic_and_seed_changes_samples(arch, paged):
    kw = dict(temperature=1.5, top_k=0)
    a = _decode(arch, paged, seed=123, **kw)
    assert a == _decode(arch, paged, seed=123, **kw)
    assert a != _decode(arch, paged, seed=124, **kw)
    assert [len(a[i]) for i in range(len(LENS))] == [1 + b for b in BUDGETS]


@pytest.mark.parametrize("arch,paged", CASES, ids=IDS)
def test_top_k_one_is_the_reference_greedy(arch, paged):
    want = _decode(arch, paged, reference=True)
    assert _decode(arch, paged, temperature=1.0, top_k=1, seed=99) == want
    assert _decode(arch, paged) == want


@pytest.mark.parametrize("arch,paged", CASES, ids=IDS)
def test_streams_do_not_depend_on_block_size(arch, paged):
    kw = dict(temperature=0.8, top_k=5, seed=7)
    two = _decode(arch, paged, block=2, **kw)
    assert two == _decode(arch, paged, block=4, **kw)
    assert two != _decode(arch, paged, block=4, temperature=0.8, top_k=5,
                          seed=8)


@pytest.mark.parametrize("arch,paged", CASES, ids=IDS)
def test_engine_samples_inside_top_k(arch, paged, monkeypatch):
    """Every draw the engine makes (the logits and temperature it passes
    to the sampler) lies in the top k of those logits, and the streams are
    made of those draws."""
    k, temp = 3, 2.0
    draws = []
    sample = teng.sample_tokens

    def recording(logits, step, **kw):
        toks = sample(logits, step, **kw)
        draws.append((logits.clone(), toks.clone(), kw))
        return toks

    monkeypatch.setattr(teng, "sample_tokens", recording)
    out = _decode(arch, paged, temperature=temp, top_k=k, seed=5)
    assert draws and all(kw == dict(temperature=temp, top_k=k, seed=5)
                         for _, _, kw in draws)
    seen = set()
    for logits, toks, _ in draws:
        top = torch.topk(logits, k, dim=-1).indices
        assert bool((top == toks[:, None]).any(dim=-1).all())
        seen.update(toks.tolist())
    assert {t for ts in out.values() for t in ts[1:]} <= seen


def _chi_square(obs, p):
    n = obs.sum()
    keep = p > 0
    assert obs[~keep].sum() == 0, "a draw outside the top k"
    e = n * p[keep]
    return float((((obs[keep] - e) ** 2) / e).sum())


# 0.999 quantiles of chi-square with 4 and 11 degrees of freedom
@pytest.mark.parametrize("top_k,bound", [(5, 18.467), (0, 31.264)])
def test_frequencies_match_softmax_over_top_k(top_k, bound):
    """20000 rows of the same 12 logits at T = 0.7, one draw a row (each
    row its own noise), then 5 steps more of 4000 rows: the counts
    against softmax(logits / T) restricted to the top k."""
    rng = np.random.default_rng(0)
    base = torch.as_tensor(rng.normal(0.0, 1.5, 12), dtype=torch.float32)
    temp = 0.7
    x = base / temp
    if top_k:
        kth = torch.topk(x, top_k).values[-1]
        x = x.masked_fill(x < kth, float("-inf"))
    p = torch.softmax(x.double(), 0).numpy()
    counts = np.zeros(12, np.int64)
    for step, rows in [(0, 20000)] + [(s, 4000) for s in range(1, 6)]:
        toks = teng.sample_tokens(
            base.expand(rows, 12), torch.tensor(step), temperature=temp,
            top_k=top_k, seed=11)
        counts += np.bincount(toks.numpy(), minlength=12)
    assert counts.sum() == 40000
    assert _chi_square(counts, p) < bound


def test_sample_hash_is_a_function_of_its_key():
    """The noise differs between seeds, steps, rows and columns, and two
    calls with one key give the same bits; every value is a 32-bit
    integer."""
    h = teng.sample_hash(3, torch.tensor(5), 8, 1000)
    assert h.dtype == torch.long and h.shape == (8, 1000)
    assert int(h.min()) >= 0 and int(h.max()) < 2 ** 32
    assert torch.equal(h, teng.sample_hash(3, torch.tensor(5), 8, 1000))
    for other in (teng.sample_hash(4, torch.tensor(5), 8, 1000),
                  teng.sample_hash(3, torch.tensor(6), 8, 1000)):
        assert float((other == h).double().mean()) < 1e-3
    assert len(set(h.flatten().tolist())) > 0.999 * h.numel()


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF])
def test_extreme_hash_values_give_finite_noise(monkeypatch, fill, top_k):
    """Every hash at its least or its largest 32-bit value: the noise is
    the same finite number in every column, so the draw is the argmax of
    the logits (an infinite noise would score every column +inf, or a
    masked one NaN, and take another column)."""
    rng = np.random.default_rng(1)
    logits = torch.as_tensor(rng.normal(0.0, 1.0, (4, 1000)),
                             dtype=torch.float32)
    logits[:, 0] = -10.0
    monkeypatch.setattr(teng, "sample_hash", lambda seed, step, r, c:
                        torch.full((r, c), fill, dtype=torch.long))
    toks = teng.sample_tokens(logits, torch.tensor(0), temperature=0.8,
                              top_k=top_k, seed=0)
    assert torch.equal(toks, logits.argmax(dim=-1))


def test_largest_hash_outside_top_k_is_not_drawn(monkeypatch):
    """The column that would draw the largest noise lies outside the top
    k in every row: the draw stays inside the top k."""
    rng = np.random.default_rng(2)
    logits = torch.as_tensor(rng.normal(0.0, 1.0, (8, 4096)),
                             dtype=torch.float32)
    out = logits.argmin(dim=-1)
    real = teng.sample_hash

    def hashed(seed, step, r, c):
        h = real(seed, step, r, c)
        h[torch.arange(r), out] = 0xFFFFFFFF
        return h

    monkeypatch.setattr(teng, "sample_hash", hashed)
    for step in range(4):
        toks = teng.sample_tokens(logits, torch.tensor(step),
                                  temperature=0.8, top_k=50, seed=step)
        top = torch.topk(logits, 50, dim=-1).indices
        assert bool((top == toks[:, None]).any(dim=-1).all())
