"""The port's speculative decode against its own plain greedy decode, on the
CPU (float32 smoke models, weights drawn from a seed), mirroring the
reference's ``tests/test_spec_decode.py``:

  * through ``RegionScheduler`` (slot churn, a chunked prompt, budgets
    ending inside a block), ``spec_k=2`` streams equal the plain greedy
    streams on kimi-linear-1t, mistral-nemo-12b, zamba2-1.2b,
    h2o-danube-1.8b (sliding-window rings), xlstm-350m (sLSTM's nested
    state), llama4-scout-17b-a16e and mixtral-8x22b (MoE FFNs: the scan
    verify; mixtral's rings roll back), dense and paged, and ``spec_k=0``
    is the plain path (no speculative buffers);
  * the scan verify is bitwise q ``decode_step``s; the parallel verify is
    within 1e-5 of them, with the same argmax;
  * drafting the model's own continuation accepts in full, a wrong draft
    accepts nothing and still emits the plain next token, and after a
    commit of 0, 1 or 2 accepted drafts every cache leaf a continuing
    stream reads is that of the accepted tokens' plain steps (bitwise on
    the scan path);
  * the greedy-only guard; a tight pool retires page-starved speculative
    slots and conserves its pages; ``stats()`` reports the acceptance;
  * the launcher with ``--spec-k 2 --freeze-thresholds --cross-validate``
    agrees on every route and prices the replay with the live acceptance.

The reference's functions are held against in
``tests/test_torch_spec_parity.py``; the captured speculative block on the
card in ``tests/test_torch_gpu.py`` (``-k spec``).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.blockpool import BlockPool
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.params import init_params
from repro_torch.serving.api import Request
from repro_torch.serving.engine import (DecodeEngine, PrefillEngine,
                                        RegionScheduler)

torch.set_num_threads(1)
SLOTS, CAPACITY, BLOCK, MAX_BUCKET, PAGE = 4, 384, 8, 64, 16
SPEC_K = 2
ARCHS = ["kimi-linear-1t", "mistral-nemo-12b", "zamba2-1.2b",
         "h2o-danube-1.8b", "xlstm-350m", "llama4-scout-17b-a16e",
         "mixtral-8x22b"]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_smoke_config(arch)
    return cfg, Model(cfg), init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")


def _requests(cfg, lens, budgets, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (L,))
                    .astype(np.int32), max_new_tokens=b)
            for i, (L, b) in enumerate(zip(lens, budgets))]


def _run(arch, reqs, *, paged=False, spec_k=0, pool=None):
    cfg, model, params = _setup(arch)
    dec = DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                       paged=paged, pool=pool, page_tokens=PAGE,
                       spec_k=spec_k, spec_ngram=1)
    sched = RegionScheduler(PrefillEngine(model, params, min_bucket=32,
                                          max_bucket=MAX_BUCKET), dec,
                            max_prefill_batch=3)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert not sched.has_work
    return {rid: r.output_tokens for rid, r in dec.outputs.items()}, dec, sched


# one prompt past MAX_BUCKET (chunked prefill); budgets end inside blocks
LENS = [24, 40, 70, 16, 33, 64]
BUDGETS = [30, 44, 25, 38, 27, 21]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_matches_plain(arch, paged):
    cfg = _setup(arch)[0]
    plain, _, _ = _run(arch, _requests(cfg, LENS, BUDGETS), paged=paged)
    spec, dec, sched = _run(arch, _requests(cfg, LENS, BUDGETS), paged=paged,
                            spec_k=SPEC_K)
    assert spec == plain
    assert dec.verify_rounds > 0
    assert dec.accepted_tokens >= dec.verify_rounds
    assert sched.stats()["accepted_tokens_per_dispatch"] == (
        dec.accepted_tokens / dec.verify_rounds)
    assert dec.spec_compiles == dec.block_compiles == 0   # eager on the CPU
    if paged:
        s = dec.pool.stats
        assert s["allocated"] == s["freed"] + s["evicted"] + dec.pool.resident
        dec.pool.check_invariants()


def test_spec_k0_is_the_plain_path():
    """``spec_k=0`` builds no speculative buffer and counts no round."""
    cfg, model, params = _setup("kimi-linear-1t")
    _, dec, sched = _run("kimi-linear-1t", _requests(cfg, LENS[:3],
                                                     BUDGETS[:3]))
    for name in ("_hist", "_hist_in", "_spec_out", "_pending"):
        assert not hasattr(dec, name), name
    assert dec.spec_compiles == 0 and dec.verify_rounds == 0
    assert dec.accepted_tokens_per_dispatch == 1.0
    assert sched.stats()["accepted_tokens_per_dispatch"] == 1.0


def _random_caches(model, B, S, seed):
    caches = model.init_cache(B, S, "cpu")
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.from_numpy(
        (rng.standard_normal(tuple(x.shape)) * 0.02).astype(np.float32)),
        caches)


def _clone(caches):
    return tree_map(lambda x: x.clone(), caches)


def _steps(model, params, seq, caches, lens):
    """q plain ``decode_step``s of ``seq``'s columns: (logits (B, q, V),
    caches)."""
    out = []
    for j in range(seq.shape[1]):
        lg, caches = model.decode_step(params, seq[:, j], caches, lens + j)
        out.append(lg)
    return torch.stack(out, dim=1), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_against_sequential_steps(arch):
    """The scan verify (kimi, zamba2) is bitwise the q steps, logits and
    caches; the parallel verify (mistral-nemo) within 1e-5 of them with
    the same argmax, and its caches' written rows within 1e-5."""
    cfg, model, params = _setup(arch)
    assert model._verify_parallel == (arch == "mistral-nemo-12b")
    caches = _random_caches(model, SLOTS, CAPACITY, seed=90)
    lens = torch.tensor([5, 17, 120, 300], dtype=torch.int32)
    seq = torch.randint(0, cfg.vocab_size, (SLOTS, SPEC_K + 1),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lg_v, c_v, _ = model.decode_verify(params, seq, _clone(caches), lens)
        lg_s, c_s = _steps(model, params, seq, _clone(caches), lens)
    if model._verify_parallel:
        torch.testing.assert_close(lg_v, lg_s, atol=1e-5, rtol=1e-5)
        assert torch.equal(lg_v.argmax(-1), lg_s.argmax(-1))
        for a, b in zip(tree_leaves(c_v), tree_leaves(c_s)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(lg_v, lg_s)
        for a, b in zip(tree_leaves(c_v), tree_leaves(c_s)):
            assert torch.equal(a, b)


def _mid_stream(arch):
    """A dense speculative engine with every slot admitted and decoding
    (lengths, history and caches past their admission)."""
    cfg, model, params = _setup(arch)
    dec = DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                       spec_k=SPEC_K, spec_ngram=1)
    sched = RegionScheduler(PrefillEngine(model, params, min_bucket=32,
                                          max_bucket=MAX_BUCKET), dec,
                            max_prefill_batch=4)
    for r in _requests(cfg, [24, 40, 16, 33], [64] * 4, seed=5):
        sched.submit(r)
    for _ in range(20):
        sched.tick()
        if dec.active.all():
            break
    assert dec.active.all()
    sched.tick()
    return dec


@pytest.mark.parametrize("accept", [0, 1, SPEC_K])
@pytest.mark.parametrize("arch", ARCHS)
def test_acceptance_and_rollback(arch, accept):
    """Drafts that follow the model's own continuation for ``accept``
    tokens and then go wrong: every slot accepts exactly ``accept``,
    position 0 is the plain next token, and after the commit every leaf a
    continuing stream reads equals the accepted tokens' plain steps
    (linear states and conv windows whole, sequence rows below the new
    length): bitwise on the scan path, within 1e-5 on the parallel one."""
    cfg, model, params = _setup(arch)
    dec = _mid_stream(arch)
    toks = torch.as_tensor(dec.tokens).long()
    lens = torch.as_tensor(dec.lengths)
    with torch.no_grad():
        caches, cont = _clone(dec.caches), []
        t = toks
        for j in range(SPEC_K):
            lg, caches = model.decode_step(params, t, caches, lens + j)
            t = lg.argmax(-1)
            cont.append(t)
        cont = torch.stack(cont, dim=1)                       # (B, k)
        drafts = cont.clone()
        drafts[:, accept:] = (cont[:, accept:] + 1) % cfg.vocab_size
        seq = torch.cat([toks[:, None], drafts], dim=1)
        logits, ver, pend = model.decode_verify(params, seq,
                                                _clone(dec.caches), lens)
        preds = logits.argmax(-1)
        match = (preds[:, :SPEC_K] == drafts).int()
        got = torch.cumprod(match, dim=1).sum(dim=1)
        assert got.tolist() == [accept] * SLOTS
        assert torch.equal(preds[:, 0], cont[:, 0])
        committed = model.commit_verify(ver, pend, got)
        _, stepped = _steps(model, params, seq[:, :accept + 1],
                            _clone(dec.caches), lens)
    exact = not model._verify_parallel
    for gc, gs in zip(committed["groups"], stepped["groups"]):
        for key in gc:
            for name, c in gc[key].items():
                s = gs[key][name]
                if name in ("k", "v", "ckv", "kpe"):
                    # (R, B, S, ...): rows the continuing stream reads
                    for b in range(SLOTS):
                        r = int(lens[b]) + accept + 1
                        pair = (c[:, b, :r], s[:, b, :r])
                        if exact:
                            assert torch.equal(*pair), (key, name, b)
                        else:
                            torch.testing.assert_close(*pair, atol=1e-5,
                                                       rtol=1e-5)
                else:                       # sLSTM's state is nested
                    for a, b in zip(tree_leaves(c), tree_leaves(s)):
                        assert torch.equal(a, b), (key, name)


def test_greedy_only_guard():
    cfg, model, params = _setup("mistral-nemo-12b")
    with pytest.raises(ValueError, match="temperature"):
        DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                     spec_k=1, temperature=0.8)


def test_pool_exhaustion_during_spec_growth_retires_cleanly():
    """Paged speculative slots reserve pages at the block_size x (k + 1)
    stride; a tight pool (224 tokens for four slots) exhausts, retires the
    page-starved slots, answers every request and conserves its pages."""
    cfg = _setup("mistral-nemo-12b")[0]
    pool = BlockPool(14, PAGE, 1)
    out, dec, _ = _run("mistral-nemo-12b",
                       _requests(cfg, [32] * 4, [120] * 4, seed=9),
                       paged=True, spec_k=SPEC_K, pool=pool)
    assert dec.page_fail_retires > 0
    assert len(out) == 4 and all(len(t) >= 1 for t in out.values())
    pool.check_invariants()
    s = pool.stats
    assert s["allocated"] == s["freed"] + s["evicted"] + pool.resident


def test_launcher_prices_the_replay_with_the_live_acceptance():
    args = serve.build_parser().parse_args(
        ["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu",
         "--requests", "12", "--batches", "3", "--pd-clusters", "3",
         "--threshold", "64", "--link-gbps", "10", "--pd-mesh-gbps", "10",
         "--wire-compression", "--freeze-thresholds", "--cross-validate",
         "--spec-k", "2", "--spec-ngram", "1"])
    rep = serve.run_serve(args)
    cv, m = rep["cross_validate"], rep["deployment"]
    assert cv["route_agreement"] == 1.0 and not cv["mismatches"]
    assert len(rep["_outputs"]) == 12
    assert m["accepted_tokens_per_dispatch"] > 1.0     # drafts accepted
    assert cv["spec_accept_rate"] == m["accepted_tokens_per_dispatch"] - 1.0
    assert all(c["accepted_tokens_per_dispatch"] >= 1.0
               for c in m["clusters"].values())
