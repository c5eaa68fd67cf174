"""``workload train``: training throughput on one device, with resumable
checkpoints (``--checkpoint-dir``) and a token file (``--data``)."""

from __future__ import annotations

import time

import torch

from .. import resolve_device
from .common import emit, llama_presets, log, moe_presets, pick_preset, sync


def cmd_train(args) -> int:
    if args.model == "moe":
        from ..models.moe import make_train_step

        presets = moe_presets()
    else:
        from ..models.llama import make_train_step

        presets = llama_presets()
    device = resolve_device(args.device)
    cfg = pick_preset(presets, args.preset, args.model)
    optimizer = "adam8bit" if args.optimizer == "adam8bit" else None
    step, init_all, _ = make_train_step(cfg, optimizer=optimizer,
                                        device=device)
    params, opt_state = init_all(torch.Generator(device).manual_seed(0))

    start_step = 0
    ckpt = None
    if args.checkpoint_dir:
        from ..models.checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(args.checkpoint_dir,
                                 max_to_keep=args.keep_checkpoints)
        if ckpt.latest_step() is not None:
            # loaded in place into the fresh init: one copy of the state
            start_step, params, opt_state = ckpt.restore((params, opt_state))
            log(f"resumed from checkpoint step {start_step}")

    if args.data:
        from ..data import DataConfig, MemmapTokens, device_batches

        # resumable by construction: the iterator starts at the restored
        # step, reproducing exactly the batches an uninterrupted run sees
        data_it = device_batches(
            MemmapTokens(args.data, vocab_size=cfg.vocab_size),
            DataConfig(batch=args.batch, seq_len=args.seq_len),
            device, start_step=start_step,
        )
        next_batch = lambda: next(data_it)   # noqa: E731
    else:
        # a fixed synthetic batch, as the reference trains without --data
        tokens = torch.randint(
            0, cfg.vocab_size, (args.batch, args.seq_len + 1), device=device,
            generator=torch.Generator(device).manual_seed(1),
        )
        next_batch = lambda: tokens          # noqa: E731

    def maybe_save(i: int, last: int):
        if ckpt is not None and (
            i == last
            or (args.checkpoint_every and i % args.checkpoint_every == 0)
        ):
            ckpt.save(i, params, opt_state)

    # the first step is optimizer update #start_step+1, so checkpoint
    # labels always equal update counts
    last = start_step + args.steps
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, next_batch())
    loss_val = float(loss)
    first_dt = time.perf_counter() - t0
    log(f"first step {first_dt:.1f}s loss {loss_val:.4f}")
    maybe_save(start_step + 1, last)

    timed_steps = args.steps - 1
    t0 = time.perf_counter()
    for i in range(start_step + 2, last + 1):
        params, opt_state, loss = step(params, opt_state, next_batch())
        maybe_save(i, last)
    loss_val = float(loss)
    sync(device)
    dt = time.perf_counter() - t0
    if ckpt is not None:
        ckpt.close()
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
        "resumed_from": start_step,
    })
    return 0
