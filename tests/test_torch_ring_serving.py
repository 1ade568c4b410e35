"""The port's serving path on smoke ``ring-2.5-1t`` (Lightning:MLA 7:1,
MoE) against the reference's, on the CPU, the reference's params carried
over (float32):

  * greedy tokens through ``RegionScheduler``, paged (the Lightning state
    in per-slot slots, the MLA latents in pool pages) and dense, equal the
    reference's paged tokens;
  * speculative decode (``spec_k`` 2, one-token n-grams), dense and
    paged: the reference's streams, verify rounds and accepted tokens (the
    scan verify snapshots each Lightning block's ``state`` and ``conv``
    and rolls back the rejected steps).

The deployment is ``tests/test_torch_ring_deployment.py``.

Tokens are compared exactly; timings are not compared.
"""
import pytest
import torch

import test_torch_paged_serving as paged_serving
import test_torch_spec_parity as spec_parity
from test_torch_ring import _setup
from repro.models import Model as JaxModel
from repro.serving import engine as jeng
from repro.serving.api import Request as JaxRequest
from repro_torch.models import Model
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Request

torch.set_num_threads(1)


# (engine module, model, params, Request) of each framework
def _reference():
    jcfg, _, jparams, _ = _setup()
    return jeng, JaxModel(jcfg, use_kernels=False), jparams, JaxRequest


def _port():
    _, tcfg, _, tparams = _setup()
    return teng, Model(tcfg), tparams, Request


def test_paged_tokens_match_dense_and_reference():
    """Mixed lengths, more requests than slots, a chunked prompt past
    max_bucket: the port's paged tokens equal the reference's paged
    tokens and the port's dense ones; the pool comes back whole."""
    prompts = paged_serving._prompts([24, 40, 70, 16, 33, 64], seed=0)
    budgets = [12, 20, 9, 16, 11, 7]
    want, jdec = paged_serving._serve(_reference(), prompts, budgets,
                                      paged=True)
    got, dec = paged_serving._serve(_port(), prompts, budgets, paged=True)
    dense, _ = paged_serving._serve(_port(), prompts, budgets, paged=False)
    assert got == want == dense
    assert dec.pool.stats == jdec.pool.stats
    s = dec.pool.stats
    assert s["allocated"] > 0
    assert s["allocated"] == s["freed"] + s["evicted"] + dec.pool.resident
    assert dec.pool.resident == 0
    dec.pool.check_invariants()


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_streams_match_reference(paged):
    """``spec_k`` 2 over repeated phrases, dense and paged: the reference's
    streams, verify rounds and accepted tokens.  This random smoke model's
    greedy streams do not repeat the phrases, so every draft is rejected
    and rolled back (``test_torch_ring.py`` holds partial accepts)."""
    want = spec_parity._scheduled(_reference(), paged)
    got = spec_parity._scheduled(_port(), paged)
    assert got[:3] == want[:3]
    assert got[2] >= got[1] > 0
