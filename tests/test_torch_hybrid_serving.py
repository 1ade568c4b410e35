"""The port's serving path on smoke ``zamba2-1.2b`` (Mamba2 mixers and one
parameter-tied attention + FFN block) against the reference's, on the CPU:
greedy tokens through ``RegionScheduler``, paged and dense; a suffix-only
resume from a page-aligned prefix (the attention pages through the
paged-prefill path, the Mamba2 states from the page-aligned snapshot);
pool conservation; ``CrossDCDeployment(paged_kv=True)`` with and without
int8 wire admission; the dense ``CrossDCDeployment`` with int8 wire
compression, a chunked prompt and a prefix-cache hit; the launcher on the
CPU.  The checks are those of ``tests/test_torch_paged_serving.py`` and
``tests/test_torch_deployment.py``, kept in a file of their own to bound
each file's time.  Tokens are compared exactly.
"""
import pytest
import torch

import test_torch_deployment as deployment
import test_torch_paged_serving as paged_serving

torch.set_num_threads(1)
HYBRID = "zamba2-1.2b"


@pytest.mark.parametrize("arch", [HYBRID])
def test_paged_tokens_match_dense_and_reference(arch):
    paged_serving.test_paged_tokens_match_dense_and_reference(arch)


@pytest.mark.parametrize("arch", [HYBRID])
def test_prefix_hit_prefills_only_the_suffix(arch):
    paged_serving.test_prefix_hit_prefills_only_the_suffix(arch)


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
def test_paged_deployment_matches_reference(wire):
    paged_serving.test_paged_deployment_matches_reference(wire, arch=HYBRID)


def test_dense_deployment_matches_reference():
    deployment.test_deployment_matches_reference(1, arch=HYBRID)


def test_launcher_serves_every_request_on_cpu():
    deployment.test_launcher_serves_every_request_on_cpu(arch=HYBRID)
