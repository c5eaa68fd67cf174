"""``workload train``: training throughput on one device."""

from __future__ import annotations

import time

import torch

from .. import resolve_device
from .common import emit, llama_presets, log, pick_preset, sync


def cmd_train(args) -> int:
    from ..models.llama import make_train_step

    device = resolve_device(args.device)
    cfg = pick_preset(llama_presets(), args.preset, args.model)
    step, init_all, _ = make_train_step(cfg, device=device)
    params, opt_state = init_all(torch.Generator(device).manual_seed(0))
    # a fixed synthetic batch, as the reference trains without --data
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.seq_len + 1), device=device,
        generator=torch.Generator(device).manual_seed(1),
    )

    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, tokens)
    loss_val = float(loss)
    first_dt = time.perf_counter() - t0
    log(f"first step {first_dt:.1f}s loss {loss_val:.4f}")

    timed_steps = args.steps - 1
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        params, opt_state, loss = step(params, opt_state, tokens)
    loss_val = float(loss)
    sync(device)
    dt = time.perf_counter() - t0
    if timed_steps == 0:
        log("steps=1: throughput includes the first step's set-up")
        timed_steps, dt = 1, first_dt

    emit({
        "metric": f"{args.model}:{args.preset} train throughput",
        "value": round(args.batch * args.seq_len * timed_steps / dt, 1),
        "unit": "tokens/sec/chip",
        "steps": args.steps,
        "final_loss": round(loss_val, 4),
        "mesh": {"devices": 1, "device": str(device)},
    })
    return 0
