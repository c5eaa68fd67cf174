"""The port's expert-parallel MoE train step on gloo ranks under ring and
Ulysses attention, and with a tied router that drops tokens and starves an
expert rank, against the reference's mesh step: the meshes
``expert2_seq2_ring``, ``expert2_seq2_ulysses`` and ``fsdp2_expert2_tied``
of ``test_torch_dist_moe.py``, whose helpers, tolerances and docstring
hold here.  The MoE keeps the whole sequence outside attention, so a
routing group is a whole batch row (the capacity from the full sequence,
the cumsum over the whole row), as the reference's
``test_seq_parallel_composes_with_ep`` requires of it.
"""

import pytest

from test_torch_dist_attention import run_ranks
from test_torch_dist_moe import (check_gradients, check_step, grads_of,
                                 make_tokens, make_trees, moe_rank)

HERE = ("expert2_seq2_ring", "expert2_seq2_ulysses", "fsdp2_expert2_tied")


@pytest.fixture(scope="module")
def trees():
    return make_trees(("random", "tied"))


@pytest.fixture(scope="module")
def tokens():
    return make_tokens()


@pytest.fixture(scope="module")
def world4(trees, tokens, tmp_path_factory):
    return run_ranks(4, moe_rank, trees, tokens, HERE,
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def reference_grads(trees, tokens):
    return grads_of(trees, tokens)


@pytest.mark.parametrize("name", HERE)
def test_expert_sharded_gradients_match_reference(world4, reference_grads,
                                                  name):
    check_gradients(world4, reference_grads, name)


@pytest.mark.parametrize("name", HERE)
def test_expert_sharded_step_matches_reference(world4, trees, tokens, name):
    check_step(world4, trees, tokens, name)
