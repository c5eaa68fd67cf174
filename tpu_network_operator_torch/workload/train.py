"""``workload train`` / ``workload convert``: training throughput on one
device or over a mesh (dense Llama, and the MoE with its experts over
``--expert``; pipeline stages over ``--pipe`` with ``--pp-schedule``
gpipe, 1f1b or interleaved), with AdamW or the 8-bit AdamW, resumable
checkpoints (``--checkpoint-dir``, sharded on a mesh, restorable onto
another mesh shape) and a token file (``--data``), and HF-checkpoint
import, onto a mesh too."""

from __future__ import annotations

import os
import time

import torch

from .common import (batch_rows, build_mesh, emit, init_distributed,
                     llama_presets, log, maybe_profile, mesh_report,
                     moe_presets, pick_preset, sync)


def check_train_flags(args) -> None:
    """The reference's refusals of ``train``'s flags, before any process
    group starts: an axis the model would not use, Ulysses inside the
    pipeline, and a pipeline schedule it does not know."""
    if args.model != "moe" and args.expert > 1:
        raise SystemExit("--expert requires --model moe")
    if args.pipe > 1 and args.seq > 1 and args.sp_impl == "ulysses":
        raise SystemExit(
            "--sp-impl ulysses cannot nest inside the pipeline region; "
            "use --sp-impl ring with --pipe"
        )
    if args.pipe > 1:
        from ..parallel.pipeline import _parse_schedule

        _parse_schedule(args.pp_schedule, args.virtual_stages)


def _pipeline_step(args, cfg, mesh, optimizer, device):
    """The pipeline's (step, init_all, optimizer) over ``--pipe``."""
    from ..parallel.pipeline import make_pipeline_train_step

    return make_pipeline_train_step(
        cfg, mesh, n_microbatches=args.microbatches, optimizer=optimizer,
        seq_axis="seq" if args.seq > 1 else None, schedule=args.pp_schedule,
        virtual_stages=args.virtual_stages, device=device)


def _checkpointer(args, cfg, mesh, params, optimizer, specs=None):
    """The run's :class:`..models.checkpoint.TrainCheckpointer`: on a mesh,
    sharded by ``specs`` (default: the family's) and the optimizer's
    state specs."""
    from ..models.checkpoint import TrainCheckpointer
    from ..models.convert import param_specs

    if mesh is not None:
        specs = specs or param_specs(cfg)
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
    check_train_flags(args)
    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
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
    # the pipeline's microbatches (1: the plain step): each rank takes
    # its share of every microbatch's rows
    micro, specs = 1, None
    if args.pipe > 1:
        step, init_all, opt = _pipeline_step(args, cfg, mesh, optimizer,
                                             device)
        micro, specs = args.microbatches, step.specs
    else:
        from ..models.llama import make_train_step

        step, init_all, opt = make_train_step(
            cfg, optimizer=optimizer, device=device, mesh=mesh,
            attn_fn=_sp_attn_fn(args, mesh))
    params, opt_state = init_all(torch.Generator(device).manual_seed(0))

    start_step = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = _checkpointer(args, cfg, mesh, params, opt, specs)
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
                   sharded_batches(source, dcfg, mesh, start_step=start_step,
                                   microbatches=micro))
        next_batch = lambda: next(data_it)   # noqa: E731
    else:
        # a fixed synthetic batch, as the reference trains without --data:
        # drawn whole on every rank, each keeping its rows
        tokens = batch_rows(torch.randint(
            0, cfg.vocab_size, (args.batch, args.seq_len + 1), device=device,
            generator=torch.Generator(device).manual_seed(1),
        ), mesh, micro)
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
        "mesh": mesh_report(mesh, device, step if args.pipe > 1 else None),
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

    from ..models import training
    from ..models.convert import (cfg_to_json, family, load_hf_checkpoint,
                                  param_specs, shard_params)

    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
    with maybe_profile(args.profile, "convert", device):
        params, cfg = load_hf_checkpoint(args.hf_path, device=device)
        log(f"imported {cfg.num_params() / 1e9:.2f}B params from "
            f"{args.hf_path}")
        # the optimizer a train step of the family builds, so the saved
        # state has the structure cmd_train restores into; over --pipe the
        # plain specs (pipe replicates), which a pipeline run's restore
        # reshards
        optimizer = training.resolve_optimizer(
            "adam8bit" if args.optimizer == "adam8bit" else None, mesh,
            None if mesh is None else param_specs(cfg))
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
