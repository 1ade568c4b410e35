"""``CrossDCDeployment`` on smoke ``ring-2.5-1t`` (Lightning:MLA 7:1, MoE)
against the reference's, on the CPU, the reference's params carried over
(float32), with int8 wire compression, dense and paged: per request the
route, cached prefix, pin, wire bytes and tokens equal the reference's;
the MLA latents go int8 and the Lightning state and conv window ship as
they are, so the measured compression is the reference's, above 1.

Tokens are compared exactly; timings are not compared.
"""
import numpy as np
import pytest
import torch

import test_torch_paged_serving as paged_serving
import test_torch_xlstm_serving as xlstm_serving
from test_torch_ring import _setup
from repro.models import Model as JaxModel
from repro.serving import CrossDCDeployment as JaxDeployment
from repro.serving import DeploymentConfig as JaxDeploymentConfig
from repro.serving.api import Request as JaxRequest
from repro_torch.models import Model
from repro_torch.serving import CrossDCDeployment, DeploymentConfig
from repro_torch.serving.api import Request

torch.set_num_threads(1)


@pytest.mark.parametrize("paged", [False, True])
def test_wire_deployment_matches_reference(paged):
    """A first turn of four prompts (threshold 40: the long ones offloaded
    over the int8 wire), then a session extension that hits the prefix
    cache; paged, the decode engine's pages are its region cache's."""
    jcfg, tcfg, jparams, tparams = _setup()
    base = xlstm_serving._prompts([30, 64, 90, 12], seed=0)
    ext = np.concatenate([base[1], xlstm_serving._prompts([30], seed=1)[0]])
    batches = [list(zip(range(4), base, [6, 5, 7, 4])), [(4, ext, 5)]]
    kw = dict(paged_serving.DEP, threshold=40, wire_compression=True,
              paged_kv=paged)
    jdep = JaxDeployment(JaxModel(jcfg, use_kernels=False), jparams,
                         JaxDeploymentConfig(**kw))
    dep = CrossDCDeployment(Model(tcfg), tparams, DeploymentConfig(**kw))
    jreqs, jout = xlstm_serving._deploy(jdep, JaxRequest, batches)
    reqs, out = xlstm_serving._deploy(dep, Request, batches)
    xlstm_serving._same_requests(jreqs, jout, reqs, out)
    assert {r.route for r in reqs} == {"prfaas", "pd"}
    assert any(r.cached_tokens > 0 for r in reqs)
    assert all(r.kv_bytes < r.kv_bytes_raw for r in reqs
               if r.route == "prfaas")
    assert dep.measured_compression() == jdep.measured_compression() > 1.0
