"""A closed loop of greedy ``generate`` calls through the port.

Set-up draws the weights and a pool of seeded prompt batches and runs one
short call at the cell's shapes (the prefill at the prompt length and
decode steps over the cache length the full calls attend), which builds
and warms every kernel.  The window runs full calls back to back; none
starts after ``--seconds``, and the window ends when the last one is done.
After it, the reference runs once over a seeded sample of served rows,
prompt and served tokens together, and reads at every served position
how far the served token's logit lies below the reference's best.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import weights
from portbench.drivers.train import port_config
from portbench.reference import model as ref_model
from portbench.reference.train import strict_f32


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def planted(fault, gen, vocab: int, prompt: int, new: int):
    """``gen`` with a fault the comparison must catch planted under it:
    one served token of every row altered where it is produced."""
    if fault is None:
        return gen
    if fault == "token":
        def altered(*args, **kw):
            out = gen(*args, **kw).clone()
            at = prompt + new // 2
            if out.shape[1] > at:
                out[:, at] = (out[:, at] + 1) % vocab
            return out
        return altered
    raise ValueError(f"no fault {fault!r} in a decode cell")


def logit_gap(cfg: Dict, ref_params: Dict, served: torch.Tensor,
              prompt: int, control: bool = False) -> float:
    """The widest gap, over every served position of ``served`` [R, P + N],
    between the reference's best logit and the logit of the served token
    (``control``: of the token the float8 reference puts first)."""
    inp = served[:, :-1].long()
    at = slice(prompt - 1, served.shape[1] - 1)
    z = ref_model.logits_at(cfg, ref_params, inp, at)
    if control:
        pick = ref_model.logits_at(cfg, ref_params, inp, at, "fp8").argmax(
            -1, keepdim=True)
    else:
        pick = served[:, prompt:].long()[..., None]
    return float((z.amax(-1, keepdim=True) - z.gather(-1, pick)).max())


def traced(ctx, gen, params, prompt, pcfg, kw) -> Dict:
    """Two profiled calls on one prompt batch, of 2 and of 2 +
    ``trace_steps`` new tokens: the second's trace is the traced window;
    their difference is ``trace_steps`` decode steps and nothing else (the
    profiler's parse of a whole call's events would outlast the run)."""
    from portbench import trace

    tr = ctx.traffic
    readings = []
    for new in (2, 2 + tr["trace_steps"]):
        prof, wall = trace.profile(lambda: gen(params, prompt, pcfg, new,
                                               max_len=tr["prompt"]
                                               + tr["new_tokens"], **kw))
        readings.append(trace.Reading(prof, wall))
        del prof
    short, reading = readings
    return {"kind": "decode", "config": ctx.config, "traffic": tr,
            "device_kind": ctx.device_kind(), "reading": reading,
            "step_launches": (reading.launches - short.launches)
            / tr["trace_steps"]}


def run(ctx) -> Dict:
    from tpu_network_operator_torch.models.generate import generate

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    pcfg = port_config(cfg, {"remat_policy": "full", "xent_chunk": 0})
    b, p, new = tr["batch"], tr["prompt"], tr["new_tokens"]
    params = weights.draw(cfg, ctx.seed, dev)
    prompts = weights.token_rows(ctx.seed, tr["pool"], b, p,
                                 cfg["vocab_size"], dev)
    gen = planted(ctx.fault, generate, cfg["vocab_size"], p, new)
    kw = dict(decode_block=tr["decode_block"], kv_dtype=tr["kv_dtype"])
    gen(params, prompts[0], pcfg, 2, max_len=p + new, **kw)
    _sync(dev)

    t_start = time.perf_counter()
    outs = []
    while time.perf_counter() - t_start < ctx.seconds:
        outs.append(gen(params, prompts[len(outs) % tr["pool"]], pcfg, new,
                        **kw))
    _sync(dev)
    window = time.perf_counter() - t_start
    calls = len(outs)
    out = {"attempted": calls, "failed": 0,
           "setup_s": ctx.clock.setup_s(t_start),
           "e2e": {"decode_tokens_per_s": calls * b * new / window}}

    if ctx.trace:
        out["trace"] = traced(ctx, gen, params, prompts[0], pcfg, kw)
        out["trace"]["calls"] = calls
        out["trace"]["window_s"] = window
    out["memory_peak_bytes"] = ctx.memory_peak()
    ctx.free_device()

    g = weights.generator("cpu", weights.mix(ctx.seed, 7))
    # calls of distinct prompt batches, so the sample does not hang on how
    # many calls the window held beyond the pool
    order = torch.randperm(tr["pool"], generator=g).tolist()
    pick = [c for c in order if c < calls][:tr["check_calls"]]
    rows = [torch.randperm(b, generator=g)[:tr["check_rows"]] for _ in pick]
    served = torch.cat([outs[c][r.to(outs[c].device)]
                        for c, r in zip(pick, rows)])
    del outs
    if torch.device(dev).type == "cuda":
        strict_f32()
    ref = ref_model.from_leaves(params)
    del params
    out["compared"] = {"logit_gap": logit_gap(cfg, ref, served, p)}
    if ctx.control:
        out["control"] = {"logit_gap": logit_gap(cfg, ref, served, p, True)}
    return out
