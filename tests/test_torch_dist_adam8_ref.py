"""The reference's 8-bit AdamW on the virtual CPU mesh against the port's
bits (``test_torch_dist_adam8.py`` has the inputs and the gloo world;
this file is one worker's share apart).

The jnp path (``TPUNET_ADAM8_FUSED=0``), eager as the reference runs an
update outside ``jit``, two steps: GSPMD partitions every operation and a
block's maximum is exact under any partition, so the mesh update is the
single-device update, which the port's sharded update is on every mesh.
It runs at the mesh of each tree where the most leaves take the port's
global-block path: ``tensor4`` for both (the dense lm_head's 128-wide
shards straddle 256-blocks; the MoE's expert w_gate / w_up are whole rows
of 128 cut in four).  Every eager operation compiles for its shardings,
about 15 s a tree here, which is why the other meshes are not run.
"""

import numpy as np
import pytest

from test_torch_dist_adam8 import (assert_same_bits, jcfg, make_inputs,
                                   reference_update, single_device)


@pytest.fixture(scope="module")
def inputs():
    return {tree: make_inputs(tree) for tree in ("llama", "moe")}


@pytest.mark.parametrize("tree", ["llama", "moe"])
def test_reference_mesh_update_is_the_port_bits(monkeypatch, inputs, tree):
    monkeypatch.setenv("TPUNET_ADAM8_FUSED", "0")
    got = reference_update(tree, *inputs[tree], "tensor4")
    assert_same_bits(got, single_device(tree, *inputs[tree]),
                     f"the reference's {tree} update at tensor4")


def test_reference_pallas_mesh_step_within_one_step_rule(monkeypatch,
                                                         inputs):
    """One step of the reference's per-shard Pallas path (interpret mode)
    at ``fsdp4`` on lm_head, the leaf of the tree whose shards its plan
    admits ([16, 512]: 32 rows of 256-blocks; the other leaves take the
    jnp path, held above), in bf16, the dtype of
    ``test_torch_optim8bit.py``'s one-step rule for that kernel: the
    port's parameter the same bits, its scales within one ulp (XLA folds
    the kernel's division by 127 and 448 into a multiplication by the
    reciprocal), its codes within one step.  In f32 the kernel's update,
    jitted, also takes XLA's fused multiply-adds (two f32 ulps of the
    update, measured), which bf16's rounding of the update hides."""
    import jax
    import ml_dtypes

    from tpu_network_operator.models import llama, optim8bit
    from tpu_network_operator.parallel import make_mesh, plan_axes

    monkeypatch.setenv("TPUNET_ADAM8_FUSED", "1")
    params, grads = ({"lm_head": t["lm_head"].astype(ml_dtypes.bfloat16)}
                     for t in (inputs["llama"][0], inputs["llama"][1][0]))
    grads = [grads]
    mesh = make_mesh(plan_axes(4, fsdp=4), devices=jax.devices()[:4])
    specs = llama.param_specs(jcfg("llama"))
    assert optim8bit._mesh_leaf_plan(mesh, specs["lm_head"],
                                     params["lm_head"].shape) is not None
    got = reference_update("llama", params, grads, "fsdp4")
    want = single_device("llama", params, grads)
    assert got.keys() == want.keys()
    worst = {}
    for k in want:
        a, b = got[k].astype(np.int64), want[k].astype(np.int64)
        if k.startswith("m/") and k.endswith("/q"):      # int8 codes
            a, b = (x.view(np.int8).astype(np.int64)
                    for x in (got[k], want[k]))
        worst[k] = int(np.abs(a - b).max()) if a.size else 0
    assert all(worst[k] == 0 for k in worst if k.startswith("p/")), {
        k: w for k, w in worst.items() if w}
    assert all(w <= 1 for w in worst.values()), worst
