"""The port's serving engines and wire format against the reference's, on
smoke ``kimi-linear-1t`` (float32, the reference's params carried over):

  * the int8 wire pytree of a cache is byte-identical to the reference's;
  * a wire payload the reference produced, admitted by the port, decodes to
    the reference's greedy tokens;
  * ``PrefillEngine`` / ``ChunkedPrefill`` / ``DecodeEngine`` under the
    ``RegionScheduler`` emit the reference's greedy tokens, truncation
    flags included.
"""
import functools

import numpy as np
import torch

from _torch_parity import (assert_trees_identical, configs, shared_params,
                           to_torch)
from repro.models import Model as JaxModel
from repro.models.kvcache import cache_num_bytes as jax_num_bytes
from repro.models.kvcache import \
    dequantize_cache_from_wire as jax_dequantize
from repro.models.kvcache import quantize_cache_for_wire as jax_quantize
from repro.models.kvcache import wire_compression_ratio as jax_ratio
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.models import Model
from repro_torch.models.kvcache import (cache_num_bytes,
                                        dequantize_cache_from_wire,
                                        quantize_cache_for_wire,
                                        wire_compression_ratio)
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)
SLOTS, CAPACITY, BLOCK, MAX_BUCKET = 4, 160, 4, 64


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = configs()
    jparams, tparams = shared_params(jcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lens]


def _jax_prefill_one(jcfg, jparams, toks):
    """The reference's trimmed single-request prefill cache."""
    peng = jeng.PrefillEngine(JaxModel(jcfg), jparams, min_bucket=32)
    first, caches, _ = peng.prefill(toks[None], np.array([len(toks)]))
    return int(first[0]), jeng.trim_request_cache(caches, 0, len(toks))


def test_wire_pytree_byte_identical():
    jcfg, tcfg, jparams, _ = _setup()
    (toks,) = _prompts(tcfg, [37])
    _, jcache = _jax_prefill_one(jcfg, jparams, toks)
    jwire, jbytes = jax_quantize(jcache)
    wire, nbytes = quantize_cache_for_wire(to_torch(jcache))
    assert nbytes == jbytes
    assert cache_num_bytes(to_torch(jcache)) == jax_num_bytes(jcache)
    assert_trees_identical(jwire, wire)
    assert_trees_identical(jax_dequantize(jwire),
                           dequantize_cache_from_wire(wire))
    assert wire_compression_ratio(to_torch(jcache)) == jax_ratio(jcache)


def test_reference_wire_payload_decodes_to_reference_tokens():
    """A payload quantized by the reference crosses into the port: after
    dequantization and admission the port decodes the reference's greedy
    tokens."""
    jcfg, tcfg, jparams, tparams = _setup()
    (toks,) = _prompts(tcfg, [45], seed=1)
    first, jcache = _jax_prefill_one(jcfg, jparams, toks)
    jwire, _ = jax_quantize(jcache)
    jdec = jeng.DecodeEngine(JaxModel(jcfg), jparams, 2, 96, block_size=BLOCK)
    jdec.admit(JaxRequest(0, toks, max_new_tokens=10), first,
               jax_dequantize(jwire), len(toks))
    jdec.run_until_drained()
    dec = teng.DecodeEngine(Model(tcfg), tparams, 2, 96, block_size=BLOCK)
    dec.admit_many([(Request(0, toks, max_new_tokens=10), first,
                     dequantize_cache_from_wire(to_torch(jwire)), len(toks))])
    dec.run_until_drained()
    assert dec.outputs[0].output_tokens == jdec.outputs[0].output_tokens
    assert len(dec.outputs[0].output_tokens) == 1 + 10


def _run_scheduler(eng, model, params, prompts, budgets):
    peng = eng.PrefillEngine(model, params, min_bucket=32,
                             max_bucket=MAX_BUCKET)
    dec = eng.DecodeEngine(model, params, SLOTS, CAPACITY, block_size=BLOCK)
    sched = eng.RegionScheduler(peng, dec, max_prefill_batch=2)
    req = JaxRequest if eng is jeng else Request
    for i, (t, b) in enumerate(zip(prompts, budgets)):
        sched.submit(req(rid=i, tokens=t, max_new_tokens=b))
    sched.run()
    return ({rid: (r.output_tokens, r.truncated)
             for rid, r in dec.outputs.items()}, dec.truncations)


def test_scheduler_tokens_match_reference():
    """Bucketed batches, a chunked long prompt (three 64-token chunks),
    more requests than slots and one stream stopped by the capacity wall:
    every token and truncation flag equals the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    lens = [20, 45, 150, 9, 33, 60]
    budgets = [5, 9, 30, 12, 3, 7]
    prompts = _prompts(tcfg, lens, seed=2)
    want, jtrunc = _run_scheduler(jeng, JaxModel(jcfg), jparams, prompts,
                                  budgets)
    got, trunc = _run_scheduler(teng, Model(tcfg), tparams, prompts, budgets)
    assert got == want
    assert trunc == jtrunc == 1
    assert len(got) == len(lens)
