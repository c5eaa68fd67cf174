"""``workload train`` / ``workload convert``: training throughput on one
device or over a mesh (dense Llama, and the MoE with its experts over
``--expert``), with AdamW or the 8-bit AdamW, resumable checkpoints
(``--checkpoint-dir``, sharded on a mesh, restorable onto another mesh
shape) and a token file (``--data``), and HF-checkpoint import, onto a
mesh too."""

from __future__ import annotations

import os
import time

import torch

from .common import (LATER_SLICE, batch_rows, build_mesh, emit,
                     init_distributed, llama_presets, log, maybe_profile,
                     mesh_report, moe_presets, pick_preset, sync)


def _train_step_factory(family: str):
    if family == "moe":
        from ..models.moe import make_train_step
    else:
        from ..models.llama import make_train_step
    return make_train_step


def _refuse_on_mesh(args) -> None:
    """What a mesh of more than one process does not run yet: it exits
    by name and does not fall back."""
    if args.pipe > 1:
        raise SystemExit(
            f"--pipe > 1 on a mesh of more than one process: not in the "
            f"port yet ({LATER_SLICE}): the pipeline schedules are item 3e"
        )


def _checkpointer(args, cfg, mesh, params, optimizer):
    """The run's :class:`..models.checkpoint.TrainCheckpointer`: on a mesh,
    sharded by the family's specs and the optimizer's state specs."""
    from ..models.checkpoint import TrainCheckpointer
    from ..models.convert import param_specs

    specs = None
    if mesh is not None:
        specs = param_specs(cfg)
        specs = (specs, optimizer.state_specs(params, specs))
    return TrainCheckpointer(args.checkpoint_dir, mesh=mesh, specs=specs,
                             max_to_keep=getattr(args, "keep_checkpoints",
                                                 3))


def _sp_attn_fn(args, mesh):
    """Sequence-parallel attention for --seq > 1."""
    if mesh is None or args.seq <= 1:
        return None
    if args.sp_impl == "ulysses":
        from ..parallel.ulysses import make_ulysses_attn_fn

        return make_ulysses_attn_fn(mesh)
    from ..parallel.ring import make_ring_attn_fn

    return make_ring_attn_fn(mesh)


def cmd_train(args) -> int:
    # the reference's refusals: an axis the model would not use
    if args.model != "moe" and args.expert > 1:
        raise SystemExit("--expert requires --model moe")
    if args.pipe > 1 and args.seq > 1 and args.sp_impl == "ulysses":
        raise SystemExit(
            "--sp-impl ulysses cannot nest inside the pipeline region; "
            "use --sp-impl ring with --pipe"
        )
    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
    if mesh is not None and mesh.plan.size() > 1:
        _refuse_on_mesh(args)
    # an imported checkpoint (workload convert) carries its own geometry,
    # family and rope scaling included, which beats --model / --preset
    sidecar_cfg = None
    sidecar = os.path.join(args.checkpoint_dir or "", "cfg.json")
    if args.checkpoint_dir and os.path.exists(sidecar):
        from ..models.convert import cfg_from_json, family

        with open(sidecar) as f:
            sidecar_cfg = cfg_from_json(f.read())
        args.model = family(sidecar_cfg)
        log(f"config from {sidecar} ({args.model}; overrides "
            "--model/--preset)")
    presets = moe_presets() if args.model == "moe" else llama_presets()
    cfg = sidecar_cfg or pick_preset(presets, args.preset, args.model)
    optimizer = "adam8bit" if args.optimizer == "adam8bit" else None
    step, init_all, opt = _train_step_factory(args.model)(
        cfg, optimizer=optimizer, device=device, mesh=mesh,
        attn_fn=_sp_attn_fn(args, mesh))
    params, opt_state = init_all(torch.Generator(device).manual_seed(0))

    start_step = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = _checkpointer(args, cfg, mesh, params, opt)
        if ckpt.latest_step() is not None:
            # loaded in place into the fresh init: one copy of the state
            start_step, params, opt_state = ckpt.restore((params, opt_state))
            log(f"resumed from checkpoint step {start_step}")

    if args.data:
        from ..data import (DataConfig, MemmapTokens, device_batches,
                            sharded_batches)

        # resumable by construction: the iterator starts at the restored
        # step, reproducing exactly the batches an uninterrupted run sees
        source = MemmapTokens(args.data, vocab_size=cfg.vocab_size)
        dcfg = DataConfig(batch=args.batch, seq_len=args.seq_len)
        data_it = (device_batches(source, dcfg, device, start_step=start_step)
                   if mesh is None else
                   sharded_batches(source, dcfg, mesh, start_step=start_step))
        next_batch = lambda: next(data_it)   # noqa: E731
    else:
        # a fixed synthetic batch, as the reference trains without --data:
        # drawn whole on every rank, each keeping its rows
        tokens = batch_rows(torch.randint(
            0, cfg.vocab_size, (args.batch, args.seq_len + 1), device=device,
            generator=torch.Generator(device).manual_seed(1),
        ), mesh)
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
    first_loss = loss_val = float(loss)
    first_dt = time.perf_counter() - t0
    log(f"first step {first_dt:.1f}s loss {loss_val:.4f}")
    maybe_save(start_step + 1, last)

    timed_steps = args.steps - 1
    with maybe_profile(args.profile, "train", device):
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

    world = 1 if mesh is None else mesh.plan.size()
    emit({
        "metric": f"{args.model}:{args.preset} train throughput",
        "value": round(args.batch * args.seq_len * timed_steps / dt / world,
                       1),
        "unit": "tokens/sec/chip",
        "steps": args.steps,
        "final_loss": round(loss_val, 4),
        # the first step's loss, unrounded: an imported checkpoint's is
        # the imported weights' loss on the first batch
        "first_loss": first_loss,
        "mesh": mesh_report(mesh, device),
        "resumed_from": start_step,
    })
    return 0


def cmd_convert(args) -> int:
    """HF checkpoint (Llama or Mixtral) -> a step-0 train checkpoint of the
    imported parameters and the optimizer's fresh state, plus the
    ``cfg.json`` sidecar; ``workload train --checkpoint-dir`` resumes from
    it with the checkpoint's own geometry (rope scaling included).  The
    optimizer must be the one ``train`` is then given.  Over a mesh (the
    process group and mesh flags ``train`` takes), every rank imports the
    whole tree, keeps its shards in the family's training layout
    (``convert.shard_params``, the reference's ``assign_shardings``) and
    saves them with its slice of the optimizer state; rank 0 writes the
    sidecar.  A checkpoint of one process restores onto a mesh too."""
    import torch.distributed as dist

    from ..models.convert import (cfg_to_json, family, load_hf_checkpoint,
                                  shard_params)

    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
    if mesh is not None and mesh.plan.size() > 1:
        _refuse_on_mesh(args)
    with maybe_profile(args.profile, "convert", device):
        params, cfg = load_hf_checkpoint(args.hf_path, device=device)
        log(f"imported {cfg.num_params() / 1e9:.2f}B params from "
            f"{args.hf_path}")
        # the family's make_train_step picks the optimizer, so the
        # saved state has the structure cmd_train restores into
        optimizer = "adam8bit" if args.optimizer == "adam8bit" else None
        _, _, optimizer = _train_step_factory(family(cfg))(
            cfg, optimizer=optimizer, device=device, mesh=mesh)
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        opt_state = optimizer.init(params)
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        if mesh is None or dist.get_rank() == 0:
            with open(os.path.join(args.checkpoint_dir, "cfg.json"),
                      "w") as f:
                f.write(cfg_to_json(cfg))
        with _checkpointer(args, cfg, mesh, params, optimizer) as ckpt:
            ckpt.save(0, params, opt_state)
    emit({
        "metric": "hf checkpoint import",
        "value": round(cfg.num_params() / 1e9, 3),
        "unit": "B params",
        "checkpoint_dir": args.checkpoint_dir,
        "family": family(cfg),
        "rope_scaling": bool(getattr(cfg, "rope_scaling", None)),
        "mesh": mesh_report(mesh, device),
    })
    return 0
