"""Closed-loop train steps through the port's ``make_train_step``.

Set-up builds the one step object (the model's step with the port's
optimizer, on the benchmark's seeded weights) and drives it through its
first three steps on distinct rows, which build and warm every kernel;
the comparison reads each step's loss, the first gradient from the
optimizer's state after step 1 and each leaf's change after step 3.  The
window then runs the same object on the same feed until ``--seconds`` have
passed, with no synchronisation until its end.  After the window the
program's state is freed and the reference follows the first three steps
from the same draws and rows.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Dict

import torch

from portbench import weights
from portbench.reference import train as reference

FIRST_STEPS = 3


def port_config(cfg: Dict, traffic: Dict):
    common = dict(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], ffn=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"], rope_theta=cfg["rope_theta"],
        rms_eps=cfg["rms_norm_eps"], dtype=torch.bfloat16, remat=True,
        remat_policy=traffic["remat_policy"], xent_chunk=traffic["xent_chunk"])
    if cfg["hidden_size"] // cfg["num_attention_heads"] != cfg["head_dim"]:
        raise ValueError("the port derives head_dim as hidden / heads")
    if cfg["family"] == "moe":
        from tpu_network_operator_torch.models.moe import MoEConfig

        return MoEConfig(
            experts=cfg["num_local_experts"],
            experts_per_token=cfg["num_experts_per_tok"],
            capacity_factor=cfg["assumed"]["capacity_factor"],
            router_aux_weight=cfg["router_aux_loss_coef"], **common)
    from tpu_network_operator_torch.models.llama import LlamaConfig

    return LlamaConfig(rope_scaling=None, **common)


def port_optimizer(traffic: Dict):
    from tpu_network_operator_torch.models import optim8bit, training

    if traffic["optimizer"] == "adamw8bit":
        return optim8bit.adamw8bit(learning_rate=traffic["lr"],
                                   weight_decay=traffic["weight_decay"])
    return training.adamw(traffic["lr"], weight_decay=traffic["weight_decay"])


def first_grads(traffic: Dict, state: Dict):
    """Each leaf's step-1 gradient as the optimizer holds it, (1 - b1) g
    after one step, divided back, slice by slice (the reference's slices):
    ({leaf: norm}, {(leaf, slice): the slice in host memory, bfloat16})."""
    norms, copies = {}, {}
    if traffic["optimizer"] == "adamw8bit":
        omb1 = float(torch.tensor(0.1, dtype=torch.float32))

        def pieces(path, qt):
            for q, scale in zip(reference.slices(path, qt.q),
                                reference.slices(path, qt.scale)):
                rows = q.float().reshape(*scale.shape, -1) * scale[..., None]
                yield rows.reshape(q.shape) / omb1

        moments = weights.flat(state["m"])
    else:
        omb1 = torch.tensor(1 - 0.9, dtype=torch.float64).to(
            torch.bfloat16).item()

        def pieces(path, mu):
            for m in reference.slices(path, mu):
                yield m.float() / omb1

        moments = weights.flat(state["mu"])
    for path, moment in moments.items():
        total = 0.0
        for k, g in enumerate(pieces(path, moment)):
            total += float(g.double().pow(2).sum())
            copies[(path, k)] = g.to(torch.bfloat16).cpu()
        norms[path] = math.sqrt(total)
    return norms, copies


def change_norms(cfg: Dict, seed: int, params: Dict, device) -> Dict[str, float]:
    """Each leaf's distance from its seeded start, slice by slice."""
    out = {}
    with torch.no_grad():
        for path, p in weights.flat(params).items():
            start = weights.draw_leaf(cfg, seed, path, device)
            total = 0.0
            for a, b in zip(p.reshape(-1, p.shape[-1]).split(4096),
                            start.reshape(-1, p.shape[-1]).split(4096)):
                total += float((a.double() - b.double()).pow(2).sum())
            out[path] = math.sqrt(total)
            del start
    return out


def compare(prog: Dict, ref: Dict, diffs: Dict[str, float]) -> Dict[str, float]:
    """The numbers compared: the widest loss gap over the first steps, and
    by the worst leaf the gap of the first gradient's norms and of the
    change's norms, each against the reference's norm of that leaf or of
    the median leaf, whichever is larger; the median leaf's gradient gap,
    which routing flips near ties do not swing as they swing the router's
    own leaf; and the median leaf's norm of the difference of the first
    gradients over the reference's norm (``diffs``), which lower precision
    moves at first order where it moves a gap of norms at second.  Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    gr = ref["grad_norms"]
    g_med = statistics.median(gr.values())
    grad_gaps = sorted(abs(prog["grad_norms"][n] - gr[n]) / max(gr[n], g_med)
                       for n in gr)
    moving = [n for n in gr if gr[n] >= 1e-3 * g_med]
    cr = ref["change_norms"]
    c_med = statistics.median(cr[n] for n in moving)
    change_gap = max(abs(prog["change_norms"][n] - cr[n]) / max(cr[n], c_med)
                     for n in moving)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gaps[-1],
            "median_grad_gap": statistics.median(grad_gaps),
            "median_grad_diff": statistics.median(diffs.values()),
            "change_norm_gap": change_gap}


def describe(prog: Dict, ref: Dict) -> str:
    """One line of what the comparison read, leaf by leaf, for the log."""
    leaves = " ".join(
        f"{n}:g{prog['grad_norms'][n]:.6g}/{ref['grad_norms'][n]:.6g}"
        f":c{prog['change_norms'][n]:.6g}/{ref['change_norms'][n]:.6g}"
        for n in ref["grad_norms"])
    return (f"losses {prog['losses']} reference {ref['losses']} {leaves}")


def planted(fault, step, family, pcfg, batch):
    """The step with one of the faults the comparison must catch planted
    under it (tests and the calibration of limits; never in a run)."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(params, state, tokens):
            with torch.no_grad():
                return params, state, family.loss_fn(params, tokens, pcfg)
        return unchanged
    if fault == "half_batch":
        return lambda params, state, tokens: step(params, state,
                                                  tokens[:batch // 2])
    raise ValueError(f"no fault {fault!r} in a train cell")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> Dict:
    from tpu_network_operator_torch.models import llama, moe

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    pcfg = port_config(cfg, tr)
    family = moe if cfg["family"] == "moe" else llama
    step, _, opt = family.make_train_step(pcfg, optimizer=port_optimizer(tr),
                                          device=dev)
    b, s = tr["batch"], tr["seq"]
    params = weights.draw(cfg, ctx.seed, dev)
    state = opt.init(params)
    batches = weights.token_rows(ctx.seed, tr["pool"], b, s + 1,
                                 cfg["vocab_size"], dev)
    step = planted(ctx.fault, step, family, pcfg, b)

    prog: Dict = {"losses": []}
    for i in range(FIRST_STEPS):
        params, state, loss = step(params, state, batches[i])
        prog["losses"].append(float(loss))
        t = time.perf_counter()
        if i == 0:
            prog["grad_norms"], prog_first = first_grads(tr, state)
        if i == FIRST_STEPS - 1:
            prog["change_norms"] = change_norms(cfg, ctx.seed, params, dev)
        ctx.clock.check_s += time.perf_counter() - t

    _sync(dev)
    t_start = time.perf_counter()
    steps = 0
    while time.perf_counter() - t_start < ctx.seconds:
        params, state, _ = step(params, state,
                                batches[(FIRST_STEPS + steps) % tr["pool"]])
        steps += 1
    _sync(dev)
    window = time.perf_counter() - t_start
    out = {"attempted": steps, "failed": 0,
           "setup_s": ctx.clock.setup_s(t_start),
           "e2e": {"train_tokens_per_s": steps * b * s / window}}

    if ctx.trace:
        out["trace"] = traced(ctx, pcfg, family, step, params, state, batches,
                              steps, window)
    out["memory_peak_bytes"] = ctx.memory_peak()
    del params, state, step, opt
    gc.collect()
    ctx.free_device()

    args = (cfg, ctx.seed, batches[:FIRST_STEPS], tr["optimizer"], tr["lr"],
            tr["weight_decay"], dev, FIRST_STEPS)
    against = [prog_first]
    if ctx.control:
        low = reference.follow(*args, "fp8", tr["xent_chunk"],
                               keep_first=True)
        against.append(low.pop("first"))
    ref = reference.follow(*args, chunk=tr["xent_chunk"], against=against)
    out["compared"] = compare(prog, ref, ref["grad_diffs"][0])
    print(f"portbench: {describe(prog, ref)}", file=sys.stderr)
    if ctx.control:
        out["control"] = compare(low, ref, ref["grad_diffs"][1])
        print(f"portbench: control {describe(low, ref)}", file=sys.stderr)
    return out


def traced(ctx, pcfg, family, step, params, state, batches, steps,
           window) -> Dict:
    """The traced run's extra readings, after the window: two profiled
    steps (kernels, GEMMs by operands, idle gaps), then three full steps
    and three loss-and-backward calls timed alone for the optimizer's
    share."""
    from portbench import trace

    tr, dev = ctx.traffic, ctx.device
    pool = tr["pool"]
    box = {"params": params, "state": state}

    def two_steps():
        for i in range(2):
            box["params"], box["state"], _ = step(
                box["params"], box["state"], batches[(i + 1) % pool])

    prof, wall = trace.profile(two_steps, record_shapes=True)
    reading = trace.Reading(prof, wall)
    del prof

    def timed(fn):
        out = []
        for i in range(3):
            _sync(dev)
            t = time.perf_counter()
            fn(batches[(i + 5) % pool])
            _sync(dev)
            out.append(time.perf_counter() - t)
        return statistics.median(out)

    def full(tokens):
        box["params"], box["state"], _ = step(box["params"], box["state"],
                                              tokens)

    leaves = list(weights.flat(box["params"]).values())

    def grad(tokens):
        for p in leaves:
            p.requires_grad_(True)
        loss = family.loss_fn(box["params"], tokens, pcfg)
        torch.autograd.grad(loss, leaves)

    step_s, grad_s = timed(full), timed(grad)
    return {"kind": "train", "config": ctx.config, "traffic": tr,
            "device_kind": ctx.device_kind(), "steps": steps,
            "window_s": window, "reading": reading, "profiled_steps": 2,
            "step_s": step_s, "grad_s": grad_s,
            "leaves": [(p.numel(), p.element_size()) for p in leaves]}
