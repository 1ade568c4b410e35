"""The port's serving path on smoke ``h2o-danube-1.8b`` (sliding-window
GQA, window 64) against the reference's, on the CPU: greedy tokens through
``RegionScheduler``, paged (each slot's private ring table) and dense
(rings of 64 rows), with prompts and streams past the window; a
suffix-only resume from a page-aligned prefix, whose window is un-rung
from the ring snapshot; pool conservation; ``CrossDCDeployment`` paged,
with and without int8 wire admission (int8 ring pages dequantized at
admission), and dense over one and two regions, with a chunked prompt and
a prefix-cache hit; the launcher on the CPU.  The checks are those of
``tests/test_torch_paged_serving.py`` and ``tests/test_torch_deployment.py``,
kept in a file of their own to bound each file's time.  Tokens are
compared exactly.
"""
import pytest
import torch

import test_torch_deployment as deployment
import test_torch_paged_serving as paged_serving

torch.set_num_threads(1)
SWA = "h2o-danube-1.8b"


@pytest.mark.parametrize("arch", [SWA])
def test_paged_tokens_match_dense_and_reference(arch):
    paged_serving.test_paged_tokens_match_dense_and_reference(arch)


@pytest.mark.parametrize("arch", [SWA])
def test_prefix_hit_prefills_only_the_suffix(arch):
    paged_serving.test_prefix_hit_prefills_only_the_suffix(arch)


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
def test_paged_deployment_matches_reference(wire):
    paged_serving.test_paged_deployment_matches_reference(wire, arch=SWA)


@pytest.mark.parametrize("regions", [1, 2])
def test_dense_deployment_matches_reference(regions):
    deployment.test_deployment_matches_reference(regions, False, None,
                                                 arch=SWA)


def test_launcher_serves_every_request_on_cpu():
    deployment.test_launcher_serves_every_request_on_cpu(arch=SWA)
