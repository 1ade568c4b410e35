"""The port's paged serving path on smoke ``kimi-linear-1t`` (MLA latent
pools + per-slot KDA state) against the reference's, on the CPU: paged
tokens equal the reference's paged tokens and the port's dense tokens, and
a page-aligned prefix hit (gathered latents + the exact-length state
snapshot) prefills only its suffix and emits the reference's tokens.
The checks are those of ``tests/test_torch_paged_serving.py``, kept in a
file of their own to bound each file's time.
"""
import pytest
import torch

import test_torch_paged_serving as paged_serving

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", [paged_serving.MLA])
def test_paged_tokens_match_dense_and_reference(arch):
    paged_serving.test_paged_tokens_match_dense_and_reference(arch)


@pytest.mark.parametrize("arch", [paged_serving.MLA])
def test_prefix_hit_prefills_only_the_suffix(arch):
    paged_serving.test_prefix_hit_prefills_only_the_suffix(arch)
