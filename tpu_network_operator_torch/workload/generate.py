"""``workload generate``: KV-cache decode throughput on one device or
over a mesh of data x fsdp x tensor ranks (the seq, expert and pipe axes
replicate)."""

from __future__ import annotations

import time

import torch

from .common import (batch_rows, build_mesh, emit,
                     init_distributed, llama_presets, log, maybe_profile,
                     mesh_report, pick_preset, sync)


def cmd_generate(args) -> int:
    from ..models.generate import make_generate_fn
    from ..models.llama import init_params, shard_params

    bootstrap, device = init_distributed(args.bootstrap, args.device)
    mesh = build_mesh(args, bootstrap, device)
    cfg = pick_preset(llama_presets(), args.preset, "llama")
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    prompt = batch_rows(torch.ones((args.batch, args.prompt_len),
                                   dtype=torch.int64, device=device), mesh)
    gen = make_generate_fn(
        cfg, args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        decode_block=args.decode_block, kv_dtype=args.kv_dtype, mesh=mesh,
    )

    def run_once():
        out = gen(params, prompt, torch.Generator(device).manual_seed(1))
        sync(device)
        return out

    t0 = time.perf_counter()
    out = run_once()
    log(f"first call {time.perf_counter() - t0:.1f}s")
    with maybe_profile(args.profile, "generate", device):
        t0 = time.perf_counter()
        out = run_once()
        dt = time.perf_counter() - t0

    emit({
        "metric": f"{args.preset} decode throughput",
        "value": round(args.batch * args.max_new_tokens / dt, 1),
        "unit": "tokens/sec",
        "batch": args.batch,
        "new_tokens": args.max_new_tokens,
        "kv_dtype": args.kv_dtype,
        "out_shape": list(out.shape),
        "mesh": mesh_report(mesh, device),
    })
    return 0
