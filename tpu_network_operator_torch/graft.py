"""The flagship's forward at compile-check size, and one sharded train
step over every parallel axis, in the port.

Counterpart of ``__graft_entry__.py``:

* :func:`entry` gives the flagship forward (Llama-3 architecture at
  ``__graft_entry__.py:42-61``'s size) with its arguments;
* :func:`dryrun_plans` is the reference's mesh arithmetic as a pure
  function, one plan a section;
* :func:`dryrun_rank` runs the reference's sections on this rank of an
  initialized process group: dp / fsdp / sp / tp on the dense model with
  chunked cross entropy and ``adam8bit`` (1), the same mesh at a geometry
  whose every kernel runs on the card (1b), the GPipe pipeline with ring
  attention inside the stage (2), GPipe, 1F1B and interleaved 1F1B on one
  mesh (2b), and expert parallelism with Ulysses (3), one train step each;
* :func:`dryrun_multichip` starts the ranks (gloo processes on the CPU, one
  NCCL process a GPU, or this process at a world of one on one GPU) and
  prints rank 0's lines, ending in the reference's ``OK`` line.

Every section takes two train steps where the reference takes one: the
first step's loss is computed before its update, so only the second's
reads the gradient and the optimizer's update (on the CPU the tests hold
both to the reference's two steps).

Section 1b differs from the reference on purpose in two more ways.  The
reference holds its Pallas kernels against its jnp paths on the mesh; the
port has no switch between a kernel and its plain version, so on the card
it also runs two steps of the kernels on seeded random tokens and holds
each loss to the same weights' plain steps on the CPU, within the
reference's 5e-2.  The dry run's constant tokens make every value row one
vector, which attention returns for any weights, so only random tokens
bring the flash kernels' softmax, mask and scale into the loss.  And it
takes 128 positions where the reference takes 64: the flash shape gate
(the reference's, kept verbatim) refuses blocks under 128 rows, so at 64
no flash kernel would run in the section whose purpose is to run the
kernels on the mesh.

Every section takes its parameters whole: drawn from a seeded CPU
generator (the same tree at every world size and on every device), or
given as numpy trees in the reference's layout, so the tests hold each
loss to the reference's step on the same plan and weights.  Each rank
keeps its shards.  The tiny configs' head_dim is 16, so sections 1, 2,
2b and 3 take plain attention on the card (``flash_attention.use_flash``,
the gate of every path); section 1b and :func:`entry` (head_dim 64) carry
the flash kernels.

    python -m tpu_network_operator_torch.graft [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Mapping, Optional

import torch

from . import resolve_device

SEQ_LEN = 64
# section 1b's positions: the fused geometry's max_seq, which the flash
# gate admits (see the module's docstring)
FUSED_SEQ_LEN = 128
MICROBATCHES = 4
SCHEDULES = ("gpipe", "1f1b", "interleaved")
# the reference's budget for a loss computed two ways (kernels against
# plain, one schedule against another)
DRIFT_TOL = 5e-2
SECTIONS = ("1", "1b", "2", "2b", "3")
RANK_TIMEOUT_S = 600
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
OK_LINE = "dryrun_multichip OK: dp fsdp sp tp pp ep all exercised"


# -- entry ----------------------------------------------------------------------


def entry_config():
    """The flagship architecture at compile-check scale (~170M params),
    ``__graft_entry__.py:51-54``."""
    from .models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=32_000, hidden=1024, layers=8, heads=16, kv_heads=8,
        ffn=4096, max_seq=512, remat=False,
    )


def entry(device=None):
    """(fn, (params, tokens)): the flagship forward on one device,
    ``fn(params, tokens) -> logits [2, 128, 32000]`` f32, with parameters
    drawn from a generator seeded 0 on ``device`` (None means CUDA, and
    raises without it) and tokens ``ones(2, 128)``.  ``fn.keywords["cfg"]``
    is the config."""
    from .models import llama

    dev = resolve_device(device)
    cfg = entry_config()
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.ones((2, 128), dtype=torch.long, device=dev)
    return functools.partial(llama.forward, cfg=cfg), (params, tokens)


# -- the dry run's plans ------------------------------------------------------------


def _split_rest(rest: int):
    """(data, fsdp) of the ranks left over: fsdp the largest power of two
    dividing them (fsdp must shard power-of-two parameter dims), data the
    odd factor."""
    fsdp = rest & -rest
    return rest // fsdp, fsdp


def dryrun_plans(n: int) -> Dict[str, object]:
    """Section -> :class:`.parallel.mesh.MeshPlan` over ``n`` ranks, the
    reference's arithmetic (``__graft_entry__.py:126-133, 141-144,
    202-206, 226-229, 256-260``); "2b" is None where pipe is 1 (the
    section is skipped)."""
    from .parallel.mesh import plan_axes

    even = n % 2 == 0
    tensor = 2 if even else 1
    seq = 2 if n % (tensor * 2) == 0 else 1
    data, fsdp = _split_rest(n // (tensor * seq))
    dense = plan_axes(n, tensor=tensor, seq=seq, data=data, fsdp=fsdp)

    pipe = 2 if even else 1
    pp_seq = 2 if n % (pipe * 2) == 0 else 1
    pp_tensor = 2 if n % (pipe * pp_seq * 2) == 0 else 1
    stage = pipe * pp_seq * pp_tensor
    data, fsdp = _split_rest(n // stage)
    pipeline = plan_axes(n, pipe=pipe, seq=pp_seq, tensor=pp_tensor,
                         data=data, fsdp=fsdp)
    schedules = (plan_axes(n, pipe=pipe, seq=pp_seq, tensor=pp_tensor,
                           data=n // stage) if pipe > 1 else None)

    expert = 4 if n % 4 == 0 else (2 if even else 1)
    moe_seq = 2 if n % (expert * 2) == 0 else 1
    data, fsdp = _split_rest(n // (expert * moe_seq))
    moe = plan_axes(n, expert=expert, seq=moe_seq, data=data, fsdp=fsdp)
    return {"1": dense, "1b": dense, "2": pipeline, "2b": schedules,
            "3": moe}


def section_configs(dtype: Optional[torch.dtype] = None) -> Dict:
    """Section -> the model config it trains (``dtype`` None: the configs'
    own, bf16)."""
    from .models.llama import LlamaConfig
    from .models.moe import MoEConfig

    tiny = LlamaConfig.tiny()
    cfgs = {
        "1": dataclasses.replace(tiny, xent_chunk=16),
        "1b": LlamaConfig(vocab_size=512, hidden=512, layers=2, heads=8,
                          kv_heads=8, ffn=1024, max_seq=128, remat=False),
        "2": tiny,
        # v=2 needs layers divisible by pipe x 2
        "2b": dataclasses.replace(tiny, layers=4),
        "3": MoEConfig.tiny(),
    }
    if dtype is not None:
        cfgs = {k: dataclasses.replace(c, dtype=dtype)
                for k, c in cfgs.items()}
    return cfgs


def section_tokens(section: str, plan) -> torch.Tensor:
    """The section's global batch, the reference's constant tokens."""
    s = plan.axis_sizes
    rows = {"1": 2 * s["data"] * s["fsdp"], "1b": 2 * s["data"] * s["fsdp"],
            "2": MICROBATCHES * s["data"] * s["fsdp"],
            "2b": MICROBATCHES * s["data"] * s["fsdp"],
            "3": 2 * s["data"] * s["fsdp"]}[section]
    length = FUSED_SEQ_LEN if section == "1b" else SEQ_LEN
    return torch.ones((rows, length + 1), dtype=torch.long)


def drift_tokens(cfg, like: torch.Tensor) -> torch.Tensor:
    """Section 1b's tokens for the card's kernels-against-plain check:
    ``like``'s shape, drawn uniformly from the vocabulary by a CPU
    generator seeded 1."""
    return torch.randint(0, cfg.vocab_size, like.shape,
                         generator=torch.Generator().manual_seed(1))


# -- one rank -------------------------------------------------------------------


def _whole(section: str, cfg, tree: Optional[Mapping], device):
    """A fresh whole parameter tree of ``section`` on ``device``: ``tree``
    (numpy, the reference's layout) or drawn from a CPU generator seeded
    0 (the reference seeds every section alike)."""
    from .models import llama, moe

    if tree is not None:
        return llama.params_from_jax(tree, device)
    model = moe if section == "3" else llama
    whole = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return llama.params_to(whole, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _two_steps(step, params, state, batch) -> List[float]:
    """The losses of two train steps from (params, state) on ``batch``:
    the first before any update, the second after the first's."""
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, batch)
        losses.append(loss.item())
    return losses


def _dense_step(cfg, mesh, dev, whole, tokens):
    from .models import llama
    from .parallel.ring import make_ring_attn_fn
    from .workload.common import batch_rows

    attn = make_ring_attn_fn(mesh) if mesh.size("seq") > 1 else None
    step, _, opt = llama.make_train_step(cfg, optimizer="adam8bit",
                                         device=dev, mesh=mesh, attn_fn=attn)
    params = llama.shard_params(whole, cfg, mesh)
    return _two_steps(step, params, opt.init(params),
                      batch_rows(tokens.to(dev), mesh))


def _plain_cpu_step(cfg, whole, tokens):
    """The single-device plain steps on the CPU (the 1b comparison)."""
    from .models import llama

    step, _, opt = llama.make_train_step(cfg, optimizer="adam8bit",
                                         device="cpu")
    return _two_steps(step, whole, opt.init(whole), tokens)


def _pipeline_step(cfg, mesh, dev, whole, tokens, schedule):
    from .models import llama
    from .parallel import pipeline

    step, _, opt = pipeline.make_pipeline_train_step(
        cfg, mesh, n_microbatches=MICROBATCHES, schedule=schedule,
        seq_axis="seq" if mesh.size("seq") > 1 else None,
        virtual_stages=2, device=dev)
    params = llama.shard_tree(pipeline.chunked_layers(whole, step.v),
                              step.specs, mesh)
    return _two_steps(step, params, opt.init(params),
                      pipeline.microbatch_rows(tokens.to(dev), mesh,
                                               MICROBATCHES))


def _moe_step(cfg, mesh, dev, whole, tokens):
    from .models import moe
    from .parallel.ulysses import make_ulysses_attn_fn
    from .workload.common import batch_rows

    attn = make_ulysses_attn_fn(mesh) if mesh.size("seq") > 1 else None
    step, _, opt = moe.make_train_step(cfg, device=dev, mesh=mesh,
                                       attn_fn=attn)
    params = moe.shard_params(whole, cfg, mesh)
    return _two_steps(step, params, opt.init(params),
                      batch_rows(tokens.to(dev), mesh))


def dryrun_rank(n: int, device, params: Optional[Mapping] = None,
                dtype: Optional[torch.dtype] = None,
                sections=SECTIONS) -> Dict:
    """The dry run's ``sections`` on this rank of an initialized process
    group of ``n`` ranks, on ``device`` (this rank's GPU, or the CPU), two
    train steps each from the whole tree ``params[section]`` (numpy, the
    reference's layout; absent: drawn from a CPU generator seeded 0).
    ``dtype`` replaces the configs' (bf16).

    Returns ``{"sections": {section: {"plan", "loss", "next_loss",
    "seconds", "launches"}}, "lines": [...]}``: each section's global loss
    of the first step and of the second, its seconds (set-up and both
    steps), the kernels' launches in them (all 0 on the CPU), and the
    reference's lines.  On the card section 1b adds ``drift_losses`` (the
    kernels' two losses on :func:`drift_tokens` and the plain steps' on
    the CPU) and ``drift``, the larger gap; 2b adds every schedule's
    ``losses`` and ``next_losses``.  Raises where a loss computed two ways
    drifts by :data:`DRIFT_TOL` or more."""
    import torch.distributed as dist

    from .ops import _kernels
    from .parallel.mesh import make_mesh

    dev = torch.device(device)
    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_rank({n}) on a process group of "
                         f"{dist.get_world_size()} ranks")
    params = params or {}
    plans = dryrun_plans(n)
    cfgs = section_configs(dtype)
    steps = {"1": _dense_step, "1b": _dense_step,
             "2": functools.partial(_pipeline_step, schedule="gpipe"),
             "3": _moe_step}
    out: Dict[str, Dict] = {}
    lines: List[str] = []
    for section in sections:
        plan = plans[section]
        if plan is None:
            continue
        cfg, tokens = cfgs[section], section_tokens(section, plan)

        def tree(on):
            return _whole(section, cfg, params.get(section), on)

        mesh = make_mesh(plan, dev)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = {"plan": dict(plan.axis_sizes)}
        if section == "2b":
            runs = {sched: _pipeline_step(cfg, mesh, dev, tree(dev), tokens,
                                          sched)
                    for sched in SCHEDULES}
            res["losses"] = {sched: run[0] for sched, run in runs.items()}
            res["next_losses"] = {sched: run[1]
                                  for sched, run in runs.items()}
            res["loss"], res["next_loss"] = runs["gpipe"]
        else:
            res["loss"], res["next_loss"] = steps[section](
                cfg, mesh, dev, tree(dev), tokens)
        _sync(dev)
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = dict(_kernels.LAUNCHES)
        sizes = res["plan"]
        loss = f"loss={res['loss']:.4f} next={res['next_loss']:.4f}"
        if section == "1b":
            if dev.type == "cuda":
                mixed = drift_tokens(cfg, tokens)
                card = _dense_step(cfg, mesh, dev, tree(dev), mixed)
                plain = _plain_cpu_step(cfg, tree("cpu"), mixed)
                res["drift_losses"] = {"card": card, "plain_cpu": plain}
                res["drift"] = max(abs(a - b) for a, b in zip(card, plain))
                if not res["drift"] < DRIFT_TOL:
                    raise RuntimeError(
                        f"kernels/plain mesh loss drift {res['drift']} on "
                        f"random tokens: {card} on {dev}, {plain} plain on "
                        "the CPU")
                loss += (f" (random tokens: {card[0]:.4f} {card[1]:.4f}, "
                         f"plain on the CPU {plain[0]:.4f} {plain[1]:.4f})")
            else:
                loss += " (plain versions)"
        if section == "2b":
            for key in ("losses", "next_losses"):
                losses = res[key]
                for sched in SCHEDULES[1:]:
                    drift = abs(losses[sched] - losses["gpipe"])
                    if not drift < DRIFT_TOL:
                        raise RuntimeError(
                            f"{sched}/gpipe {key} drift {drift}: {losses}")
            loss = f"losses={res['losses']} next={res['next_losses']}"
        what = {"1": "dense dp/fsdp/sp/tp (chunked xent, adam8bit)",
                "1b": "fused-kernel mesh (rmsnorm+flash+adam8 kernels)",
                "2": "pipeline pp/sp/tp/dp",
                "2b": f"pipeline 1f1b+interleaved (sp={sizes['seq']})",
                "3": "moe ep/sp/dp"}[section]
        lines.append(f"dryrun {what}: mesh={sizes} {loss}")
        out[section] = res
    lines.append(OK_LINE)
    return {"sections": out, "lines": lines}


# -- the ranks --------------------------------------------------------------------


def _rank_main(fn: Callable, rank: int, world: int, device_type: str,
               store: str, timeout_s: float, results, args) -> None:
    """One rank process: join the group through the file store, run
    ``fn(rank, world, device, *args)``, report (rank, ok, value)."""
    import torch.distributed as dist

    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            BACKENDS[device_type], init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch_ranks(n: int, fn: Callable, *args, device_type: str = "cpu",
                 timeout: float = RANK_TIMEOUT_S) -> List:
    """``fn(rank, n, device, *args)`` in ``n`` spawned processes joined by
    a gloo (CPU) or NCCL (one GPU a rank) group, the rendezvous through a
    file store in a temporary directory: the results in rank order.
    ``fn`` must be a top-level function (it is pickled).  A rank that
    raises, dies or outlasts ``timeout`` seconds fails the call with a
    ``RuntimeError`` that names it; no process is left on return."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, tuple] = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, device_type, store, timeout,
                                   results, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while len(got) < n and time.monotonic() < deadline:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        failed = (f"rank {dead[0]} died with exit code "
                                  f"{procs[dead[0]].exitcode} before it "
                                  "reported")
                        break
                    continue
                got[rank] = (ok, value)
                if not ok:
                    failed = f"rank {rank} raised:\n{value}"
                    break
            if failed is None and len(got) < n:
                missing = [r for r in range(n) if r not in got]
                failed = (f"ranks {missing} gave no result within "
                          f"{timeout} s")
        finally:
            for p in procs:
                if p.is_alive() and failed is None:
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
            results.join_thread()
    if failed is not None:
        raise RuntimeError(f"launch_ranks({n}, {fn.__name__}): {failed}")
    return [got[r][1] for r in range(n)]


def _dryrun_entry(rank: int, world: int, device, params, dtype):
    return dryrun_rank(world, device, params, dtype)


def _world_of_one(device: torch.device, params, dtype) -> Dict:
    """The dry run in this process at a world of one (one GPU, NCCL)."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("dryrun_multichip(1) starts its own process "
                           "group; one is already initialized here")
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        dist.init_process_group(
            BACKENDS[device.type],
            init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            return dryrun_rank(1, device, params, dtype)
        finally:
            dist.destroy_process_group()


def dryrun_multichip(n: int, device=None, params: Optional[Mapping] = None,
                     dtype: Optional[torch.dtype] = None,
                     timeout: float = RANK_TIMEOUT_S) -> Dict:
    """One sharded train step of every section over ``n`` ranks (the
    reference's ``dryrun_multichip``): on the CPU (``device="cpu"``) ``n``
    gloo rank processes; on CUDA (None) one NCCL process a visible GPU,
    and at ``n == 1`` this process at a world of one.  Prints rank 0's
    lines, the last the reference's ``OK`` line, and returns rank 0's
    :func:`dryrun_rank` result.  Raises a ``RuntimeError`` naming the
    rank that failed, and where ``n`` exceeds the visible GPUs."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices, one a rank; "
                f"{count} visible")
    if dev.type == "cuda" and n == 1:
        result = _world_of_one(torch.device("cuda", 0), params, dtype)
    else:
        result = launch_ranks(n, _dryrun_entry, params, dtype,
                              device_type=dev.type, timeout=timeout)[0]
    for line in result["lines"]:
        print(line, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one sharded train step over dp, fsdp, sp, tp, pp and "
                    "ep on n ranks (the port's dryrun_multichip)")
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo rank processes (default: one CUDA "
                         "device a rank)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
