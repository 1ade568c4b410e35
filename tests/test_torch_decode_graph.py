"""The decode engine's surface around the captured block, held against the
reference on the CPU (float32 smoke ``kimi-linear-1t``, the reference's
params carried over):

  * the capture-safe MoE form (every expert over the block's tokens, gates
    zero off each token's top-k) equals the sorted loop and the
    reference's ``apply_moe_dropless`` at decode shapes;
  * ``DecodeEngine.step`` emits the reference's ``step`` tokens, and
    ``step_block`` the tokens of ``step`` (the reference's
    ``test_block_matches_per_token``);
  * ``admit`` is ``admit_many`` of one;
  * ``PrefillEngine.warmup`` with its region's decode engine
    (``warmup_admission``, ``warmup_block``) leaves no active slot, no
    output, no hook call and a conserved pool, and later tokens unchanged;
  * after the same warm-up and traffic (smoke ``mistral-nemo-12b``, whose
    reference programs compile in a third of kimi's time, and smoke
    ``h2o-danube-1.8b``, whose pages are rings), ``compiles`` /
    ``admit_compiles`` count the reference's shapes and
    ``RegionScheduler.stats()`` has the reference's keys and counts.

Both frameworks run the weights the port draws from a seed
(``_torch_parity.drawn_params``).

On the CPU the block runs eagerly (``block_compiles`` 0); the replayed
graph is held against the eager block on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import configs, drawn_params, to_jax
from repro.models import Model as JaxModel
from repro.models.layers import apply_moe_dropless as jax_moe
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.models import Model
from repro_torch.models.layers import apply_moe_decode, apply_moe_dropless
from repro_torch.models.tree import tree_leaves
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)
SLOTS, CAPACITY, BLOCK, MAX_BUCKET, PAGE = 4, 192, 4, 64, 16
MLA, GQA, SWA = "kimi-linear-1t", "mistral-nemo-12b", "h2o-danube-1.8b"


@functools.lru_cache(maxsize=None)
def _setup(arch=MLA):
    jcfg, tcfg = configs(arch=arch)
    jparams, tparams = drawn_params(tcfg)
    return jcfg, tcfg, jparams, tparams


def _side(port: bool, arch=MLA):
    """(engine module, model, params, Request) of one framework."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    if port:
        return teng, Model(tcfg), tparams, Request
    return jeng, JaxModel(jcfg, use_kernels=False), jparams, JaxRequest


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (L,)).astype(np.int32) for L in lens]


def _moe_block(cfg):
    """(group, block) of the first MoE FFN."""
    for gi, g in enumerate(cfg.groups):
        for bi, b in enumerate(g.blocks):
            if b.ffn.kind == "moe":
                return gi, f"b{bi}", b.ffn
    raise AssertionError("the smoke config has no MoE block")


@pytest.mark.parametrize("rows", [1, 8])
def test_moe_decode_form_matches_sorted_loop_and_reference(rows):
    """Decode-shaped input (rows, 1, d): every expert at once equals the
    sorted loop and the reference within 1e-5 (float32; the sums run in
    another order)."""
    import jax
    import jax.numpy as jnp

    jcfg, tcfg, jparams, tparams = _setup()
    gi, key, spec = _moe_block(tcfg)
    assert spec.num_experts > spec.top_k
    jp = {k: v[0] for k, v in
          jparams["groups"][gi]["stacked"][key]["ffn"].items()
          if k != "shared"}
    tp = {k: v[0] for k, v in
          tparams["groups"][gi]["stacked"][key]["ffn"].items()
          if k != "shared"}
    if "shared" in tparams["groups"][gi]["stacked"][key]["ffn"]:
        jp["shared"] = {k: v[0] for k, v in jparams["groups"][gi][
            "stacked"][key]["ffn"]["shared"].items()}
        tp["shared"] = {k: v[0] for k, v in tparams["groups"][gi][
            "stacked"][key]["ffn"]["shared"].items()}
    x = np.random.default_rng(rows).standard_normal(
        (rows, 1, tcfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(jax_moe, static_argnums=2)(
        jp, jnp.asarray(x), spec))
    loop = apply_moe_dropless(tp, torch.from_numpy(x), spec).numpy()
    dense = apply_moe_decode(tp, torch.from_numpy(x), spec).numpy()
    np.testing.assert_allclose(dense, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dense, loop, atol=1e-5, rtol=1e-5)
    assert np.abs(want).max() > 1e-3


def _prefilled(side, lens, seed, max_new):
    """One bucketed prefill of ``lens`` prompts -> admission entries."""
    eng, model, params, req = side
    prompts = _prompts(lens, seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, t in enumerate(prompts):
        toks[i, :len(t)] = t
    first, caches, _ = eng.PrefillEngine(model, params).prefill(
        toks, np.asarray(lens, np.int32))
    return [(req(rid=i, tokens=t, max_new_tokens=max_new), int(first[i]),
             eng.trim_request_cache(caches, i, len(t)), len(t))
            for i, t in enumerate(prompts)]


def _decode(side, entries, per_token: bool, paged: bool = False):
    eng, model, params, _ = side
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                           paged=paged, page_tokens=PAGE)
    assert dec.admit_many(entries) == len(entries)
    while dec.active.any():
        dec.step() if per_token else dec.step_block()
    return {rid: (r.output_tokens, r.finished, r.truncated)
            for rid, r in dec.outputs.items()}, dec


LENS, MAX_NEW = [16, 24, 33, 40], 6


@pytest.mark.parametrize("pair", ["port_step_vs_reference_step",
                                  "port_block_vs_port_step"])
def test_step_tokens(pair):
    """Greedy tokens of the per-token ``step``: the port's equal the
    reference's; and ``step_block`` equals ``step`` in the port (budgets
    end mid-block)."""
    port = _side(True)
    entries = _prefilled(port, LENS, 3, MAX_NEW)
    got, dec = _decode(port, entries, per_token=True)
    assert all(len(t) == 1 + MAX_NEW and f and not tr
               for t, f, tr in got.values())
    assert dec.tokens_out == 0           # step keeps no block telemetry
    if pair == "port_step_vs_reference_step":
        # the reference decodes from the port's prefill caches (prefill
        # parity is held in tests/test_torch_serving.py)
        want, _ = _decode(_side(False), [
            (JaxRequest(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens), first,
             to_jax(cache), L) for r, first, cache, L in entries],
            per_token=True)
    else:
        want, _ = _decode(port, _prefilled(port, LENS, 3, MAX_NEW),
                          per_token=False)
    assert got == want


def test_paged_step_raises():
    eng, model, params, _ = _side(True)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, paged=True,
                           page_tokens=PAGE)
    with pytest.raises(RuntimeError, match="step_block"):
        dec.step()


@pytest.mark.parametrize("paged", [False, True])
def test_admit_is_admit_many_of_one(paged):
    port = _side(True)
    (entry,) = _prefilled(port, [29], 4, 5)
    eng, model, params, _ = port
    a, b = (eng.DecodeEngine(model, params, SLOTS, CAPACITY,
                             block_size=BLOCK, paged=paged, page_tokens=PAGE)
            for _ in range(2))
    assert a.admit(*entry) is True
    assert b.admit_many([entry]) == 1
    for x, y in zip(tree_leaves(a.caches), tree_leaves(b.caches)):
        assert torch.equal(x, y)
    a.run_until_drained()
    b.run_until_drained()
    assert a.outputs[0].output_tokens == b.outputs[0].output_tokens
    full = eng.DecodeEngine(model, params, 1, CAPACITY, paged=paged,
                            page_tokens=PAGE)
    assert full.admit(*entry) and not full.admit(*entry)


WARM_LENS = [20, 100]                    # 100: two chunks of MAX_BUCKET


@pytest.mark.parametrize("mode", ["dense", "paged", "paged_wire"])
def test_warmups_leave_no_trace(mode):
    """After ``PrefillEngine.warmup(..., decode=dec)``: no active slot, no
    output, no TBT sample, no ``on_admit`` call, the pool round-tripped
    (allocated == freed); traffic then emits the tokens of an engine that
    was never warmed."""
    port = _side(True)
    eng, model, params, req = port
    paged = mode != "dense"
    calls = []

    def engines():
        peng = eng.PrefillEngine(model, params, min_bucket=32,
                                 max_bucket=MAX_BUCKET)
        dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY,
                               block_size=BLOCK, paged=paged,
                               page_tokens=PAGE)
        if paged:
            dec.on_admit = lambda *a: calls.append(a)
            dec.wire_admission = mode == "paged_wire"
        return peng, dec

    peng, dec = engines()
    peng.warmup([1, 2], WARM_LENS, decode=dec)
    assert not dec.active.any() and dec.outputs == {} and dec.tbt_s == []
    assert len(dec.free_slots()) == SLOTS and calls == []
    assert dec.block_compiles == 0       # the CPU runs the block eagerly
    if paged:
        s = dec.pool.stats
        assert s["allocated"] > 0 and s["allocated"] == s["freed"]
        assert dec.pool.resident == 0 and dec.admit_compiles > 0
        dec.pool.check_invariants()
    prompts = _prompts([30, 70, 12], seed=5)

    def serve(peng, dec):
        sched = eng.RegionScheduler(peng, dec, max_prefill_batch=2)
        for i, t in enumerate(prompts):
            sched.submit(req(rid=i, tokens=t, max_new_tokens=7))
        sched.run()
        return {rid: r.output_tokens for rid, r in dec.outputs.items()}

    assert serve(peng, dec) == serve(*engines())
    assert len(calls) == (2 * len(prompts) if paged else 0)


def test_warmup_block_refuses_active_slots():
    port = _side(True)
    eng, model, params, _ = port
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK)
    dec.admit_many(_prefilled(port, [18], 6, 4))
    with pytest.raises(RuntimeError, match="inactive"):
        dec.warmup_block()


def _warm_and_serve(side):
    """A paged engine with wire admission, warmed for batches of one, then
    traffic inside the warmed shapes through the scheduler, one request a
    prefill unit.  Returns (compiles after warm-up, after traffic, stats,
    the reference's own count, tokens)."""
    eng, model, params, req = side
    peng = eng.PrefillEngine(model, params, min_bucket=32,
                             max_bucket=MAX_BUCKET)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK,
                           paged=True, page_tokens=PAGE)
    dec.wire_admission = True
    peng.warmup([1], WARM_LENS, decode=dec)
    warm = (len(peng._shape_keys), dec.admit_compiles)
    sched = eng.RegionScheduler(peng, dec, max_prefill_batch=1)
    budgets = [9, 5, 12, 7]
    for i, (t, b) in enumerate(zip(_prompts([20, 17, 90, 70], 7),
                                   budgets)):
        sched.submit(req(rid=i, tokens=t, max_new_tokens=b))
    sched.run()
    after = (len(peng._shape_keys), dec.admit_compiles)
    return (warm, after, sched.stats(), peng.compiles,
            {rid: r.output_tokens for rid, r in dec.outputs.items()})


def test_compiles_and_stats_match_reference():
    """The same warm-up and traffic on both sides: the port's shape counts
    equal the reference's (its jit programs too), traffic inside the warmed
    shapes adds none, and ``stats()`` has the reference's keys, counts and
    tokens; the wall-clock shares are in range."""
    _compiles_and_stats(GQA)


def test_compiles_and_stats_match_reference_on_rings():
    """The same on smoke ``h2o-danube-1.8b``, whose paged admission writes
    ring pages alone (one ring table of 64 / 16 pages a slot)."""
    _compiles_and_stats(SWA)


def _compiles_and_stats(arch):
    # the reference's ``compiles`` sums jit cache sizes, and its chunk
    # carry (``PrefillEngine._carry_last_impl``, a staticmethod) shares one
    # cache across every engine in the process: an earlier test's chunked
    # prefill at another batch leaves an entry this run does not make
    jax.clear_caches()
    jwarm, jafter, jstats, jcompiles, jtoks = _warm_and_serve(
        _side(False, arch))
    warm, after, stats, compiles, toks = _warm_and_serve(_side(True, arch))
    assert warm == jwarm and after == jafter == warm
    assert compiles == jcompiles == warm[0]
    assert toks == jtoks
    assert set(stats) == set(jstats)
    for k in ("boundaries", "max_admit_wait", "starved_boundaries",
              "tokens_out", "truncations", "accepted_tokens_per_dispatch"):
        assert stats[k] == jstats[k], k
    assert stats["accepted_tokens_per_dispatch"] == 1.0
    assert 0.0 < stats["occupancy"] <= 1.0 and stats["goodput_tok_s"] > 0
