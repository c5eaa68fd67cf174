"""The dry run's rank launcher (``graft.launch_ranks``): results in rank
order, and a rank that raises, dies or hangs fails the call with a message
that names it and leaves no process behind.  The rank functions are
top-level here because the spawned ranks unpickle them by import."""

import multiprocessing
import os
import time

import pytest

def raise_on_rank1(rank, world, device):
    if rank == 1:
        raise ValueError("rank one's fault")
    return rank


def die_on_rank1(rank, world, device):
    if rank == 1:
        os._exit(3)
    return rank


def hang_on_rank1(rank, world, device):
    if rank == 1:
        time.sleep(600)
    return rank


def rank_number(rank, world, device):
    return rank


@pytest.mark.parametrize("fn,message,timeout", [
    (raise_on_rank1, r"rank 1 raised:(.|\n)*rank one's fault", 60),
    (die_on_rank1, "rank 1 died with exit code 3", 60),
    (hang_on_rank1, r"ranks \[(0, )?1\] gave no result within 6 s", 6),
])
def test_a_failing_rank_fails_the_call_and_leaves_no_process(fn, message,
                                                             timeout):
    """A rank that raises, dies or hangs fails the call with a message
    that names it, and every rank process is gone on return."""
    from tpu_network_operator_torch import graft

    with pytest.raises(RuntimeError, match=message):
        graft.launch_ranks(2, fn, device_type="cpu", timeout=timeout)
    assert not multiprocessing.active_children()


def test_launch_ranks_returns_results_in_rank_order():
    from tpu_network_operator_torch import graft

    assert graft.launch_ranks(2, rank_number, device_type="cpu",
                              timeout=60) == [0, 1]
    assert not multiprocessing.active_children()
