"""The dry run's sections 2, 2b and 3 (``graft.dryrun_rank``) on one world
of 4 gloo ranks against the reference's steps on the 4-device CPU mesh,
with the same plans, constant tokens and parameters, in f32
(``test_torch_graft_sections.py`` has the helpers and sections 1, 1b).

* Section 2: GPipe over pipe 2 x seq 2 (ring attention inside the stage),
  4 microbatches, against the reference's ``make_pipeline_train_step``.
* Section 2b: the tiny Llama at 4 layers, GPipe, 1F1B and interleaved
  (2 chunks a stage) on that mesh.  Each of the port's three losses is
  held to the reference's GPipe step: the reference's 1F1B under a seq
  axis deadlocks now and then on XLA's CPU backend (as in
  ``test_torch_pipeline_dense.py``), and the three compute the same loss.
* Section 3: the tiny MoE over expert 4 against the reference's
  ``moe.make_train_step(cfg, mesh)``.

Each section takes two steps on both sides, so the second loss reads the
first step's gradient and update.

Tolerance: each loss to 1e-5 relative (f32 summation order), as the
sharded steps are held in ``test_torch_pipeline_dense.py`` and
``test_torch_dist_moe.py``.
"""

import pytest

from test_torch_graft_sections import (hold_steps, reference_cfg,
                                       reference_mesh, reference_two_steps,
                                       run_sections)

HERE = ("2", "2b", "3")


@pytest.fixture(scope="module")
def world():
    return run_sections(HERE)


def reference_pipeline_losses(section, tree):
    from tpu_network_operator.parallel import make_pipeline_train_step

    mesh = reference_mesh(section)
    seq = dict(zip(mesh.axis_names, mesh.devices.shape))["seq"]
    step, _, opt = make_pipeline_train_step(
        reference_cfg(section), mesh, n_microbatches=4,
        seq_axis="seq" if seq > 1 else None, schedule="gpipe",
        virtual_stages=2)
    return reference_two_steps(step, opt, section, tree)


def test_every_rank_reports_the_same_losses(world):
    _, results = world
    for r in results:
        assert list(r["sections"]) == list(HERE)
        for section in HERE:
            for key in ("loss", "next_loss"):
                assert r["sections"][section][key] == \
                    results[0]["sections"][section][key]
        for key in ("losses", "next_losses"):
            assert r["sections"]["2b"][key] == \
                results[0]["sections"]["2b"][key]


def test_pipeline_section_matches_reference(world):
    trees, results = world
    hold_steps(results[0]["sections"]["2"],
               reference_pipeline_losses("2", trees["2"]))


@pytest.fixture(scope="module")
def reference_2b(world):
    """The reference's two GPipe losses of section 2b (one compile for
    the three schedules' cases)."""
    return reference_pipeline_losses("2b", world[0]["2b"])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_schedules_section_matches_reference_gpipe(world, reference_2b,
                                                   schedule):
    _, results = world
    res = results[0]["sections"]["2b"]
    hold_steps({"loss": res["losses"][schedule],
                "next_loss": res["next_losses"][schedule]}, reference_2b)


def test_moe_section_matches_reference(world):
    from tpu_network_operator.models.moe import make_train_step

    trees, results = world
    step, _, opt = make_train_step(reference_cfg("3"), reference_mesh("3"))
    hold_steps(results[0]["sections"]["3"],
               reference_two_steps(step, opt, "3", trees["3"]))
