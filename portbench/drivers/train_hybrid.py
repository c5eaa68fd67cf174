"""Closed-loop train steps of a hybrid-attention dropless MoE (the
``hybrid_moe`` family: Mellum2's block) through the port's
``moe.make_train_step``.

The train driver's loop, check and traced readings (``drivers/train.py``,
reused by import) over this family's own pieces: the port's config from
the published keys (an explicit head dim, the per-layer window, a RoPE per
layer type, dropless routing over all experts: ``HybridMoEConfig``), the
weights drawn under
:func:`..reference.hybrid_moe.leaf_view`'s keys, and the reference of
``reference/hybrid_moe.py``.  A program without that config fails at
once in set-up.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict

import torch

from portbench import weights
from portbench.drivers import train
from portbench.reference import hybrid_moe as reference

FIRST_STEPS = train.FIRST_STEPS


def port_config(cfg: Dict, traffic: Dict):
    """The port's HybridMoEConfig of a ``hybrid_moe`` configuration."""
    from tpu_network_operator_torch.models.moe import HybridMoEConfig

    if set(cfg["mlp_layer_types"]) != {"sparse"}:
        raise ValueError("every layer of this family is sparse")
    return HybridMoEConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        explicit_head_dim=cfg["head_dim"], ffn=cfg["moe_intermediate_size"],
        experts=cfg["num_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        routing=cfg["assumed"]["routing"],
        router_aux_weight=reference.aux_coef(cfg),
        max_seq=cfg["max_position_embeddings"],
        rope_theta=cfg["rope_parameters"]["full_attention"]["rope_theta"],
        rope_parameters=cfg["rope_parameters"],
        layer_types=tuple(cfg["layer_types"]),
        sliding_window=cfg["sliding_window"], rms_eps=cfg["rms_norm_eps"],
        dtype=torch.bfloat16, remat=True,
        remat_policy=traffic["remat_policy"], xent_chunk=traffic["xent_chunk"])


def planted(fault, step, pcfg, optimizer, device, seq: int):
    """The step with a fault the comparison must catch planted under it
    (tests and the calibration of limits; never in a run): the train
    driver's ``unchanged``; ``half_seq``, each step on the first half of
    its row (a batch of one has no half batch); ``no_window``, every layer
    attending causally over all keys, the sliding layers too."""
    from tpu_network_operator_torch.models import moe

    if fault == "half_seq":
        return lambda params, state, tokens: step(params, state,
                                                  tokens[:, :seq // 2 + 1])
    if fault == "no_window":
        full = dataclasses.replace(pcfg, layer_types=(), sliding_window=0)
        return moe.make_train_step(full, optimizer=optimizer,
                                   device=device)[0]
    return train.planted(fault, step, moe, pcfg, 2)


def run(ctx) -> Dict:
    from tpu_network_operator_torch.models import moe

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    view = reference.leaf_view(cfg)
    pcfg = port_config(cfg, tr)
    step, _, opt = moe.make_train_step(pcfg, optimizer=train.port_optimizer(tr),
                                       device=dev)
    if ctx.fault is not None:
        step = planted(ctx.fault, step, pcfg, opt, dev, tr["seq"])
    b, s = tr["batch"], tr["seq"]
    params = weights.draw(view, ctx.seed, dev)
    state = opt.init(params)
    batches = weights.token_rows(ctx.seed, tr["pool"], b, s + 1,
                                 cfg["vocab_size"], dev)

    prog: Dict = {"losses": []}
    for i in range(FIRST_STEPS):
        params, state, loss = step(params, state, batches[i])
        prog["losses"].append(float(loss))
        t = time.perf_counter()
        if i == 0:
            prog["grad_norms"], prog_first = train.first_grads(tr, state)
        if i == FIRST_STEPS - 1:
            prog["change_norms"] = train.change_norms(view, ctx.seed, params,
                                                      dev)
        ctx.clock.check_s += time.perf_counter() - t

    train._sync(dev)
    t_start = time.perf_counter()
    steps = 0
    while time.perf_counter() - t_start < ctx.seconds:
        params, state, _ = step(params, state,
                                batches[(FIRST_STEPS + steps) % tr["pool"]])
        steps += 1
    train._sync(dev)
    window = time.perf_counter() - t_start
    out = {"attempted": steps, "failed": 0,
           "setup_s": ctx.clock.setup_s(t_start),
           "e2e": {"train_tokens_per_s": steps * b * s / window}}

    if ctx.trace:
        out["trace"] = train.traced(ctx, pcfg, moe, step, params, state,
                                    batches, steps, window)
    out["memory_peak_bytes"] = ctx.memory_peak()
    del params, state, step, opt
    ctx.free_device()

    args = (cfg, ctx.seed, batches[:FIRST_STEPS], tr["optimizer"], tr["lr"],
            tr["weight_decay"], dev, FIRST_STEPS)
    against = [prog_first]
    if ctx.control:
        low = reference.follow(*args, "fp8", tr["xent_chunk"],
                               keep_first=True)
        against.append(low.pop("first"))
    ref = reference.follow(*args, chunk=tr["xent_chunk"], against=against)
    out["compared"] = train.compare(prog, ref, ref["grad_diffs"][0])
    print(f"portbench: {train.describe(prog, ref)}", file=sys.stderr)
    if ctx.control:
        out["control"] = train.compare(low, ref, ref["grad_diffs"][1])
        print(f"portbench: control {train.describe(low, ref)}",
              file=sys.stderr)
    return out
