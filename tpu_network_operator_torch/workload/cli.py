"""Argument parsing and dispatch for the workload subcommands."""

from __future__ import annotations

import argparse

from .collectives import cmd_collectives
from .common import LLAMA_PRESET_NAMES
from .execbench import cmd_exec_bench
from .generate import cmd_generate
from .train import cmd_convert, cmd_train


def _device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions (default: cuda)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed "
                        "region (host ops; kernels and copies on CUDA) to "
                        "DIR/<subcommand>.trace.json")


def _mesh_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--bootstrap", default=None,
                   help="the agent's jax-coordinator.json: the process "
                        "group's rendezvous, rank and world (one process "
                        "per GPU); without it, a launcher's RANK / "
                        "WORLD_SIZE / MASTER_ADDR environment, or one "
                        "process")
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--expert", type=int, default=1)
    p.add_argument("--pipe", type=int, default=1)


def build_parser() -> argparse.ArgumentParser:
    from . import __doc__ as pkg_doc

    p = argparse.ArgumentParser(
        prog="tpu-network-operator-torch-workload",
        description=pkg_doc,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collectives", help="bandwidth sweep over a mesh axis")
    _device_flags(c)
    _mesh_flags(c)
    c.add_argument("--axis", default=None, help="mesh axis (default: largest)")
    c.add_argument("--sizes-mb", type=float, nargs="+",
                   default=[16.0, 64.0, 256.0])
    c.add_argument("--iters", type=int, default=5)
    c.set_defaults(fn=cmd_collectives)

    g = sub.add_parser("generate", help="decode throughput")
    _device_flags(g)
    _mesh_flags(g)
    g.add_argument("--preset", default="tiny", choices=LLAMA_PRESET_NAMES)
    g.add_argument("--batch", type=int, default=4)
    g.add_argument("--prompt-len", type=int, default=16)
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0,
                   help="truncate sampling to the k highest-prob ids")
    g.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling: smallest top-p probability mass")
    g.add_argument("--decode-block", type=int, default=256,
                   help="effective-length decode granularity; 0 = attend "
                        "over the full KV buffer every step")
    g.add_argument("--kv-dtype", default="native",
                   choices=["native", "int8"],
                   help="int8 block-quantizes the KV cache: half the "
                        "cache bytes at KV-quant noise")
    g.set_defaults(fn=cmd_generate)

    t = sub.add_parser("train", help="training throughput")
    _device_flags(t)
    _mesh_flags(t)
    t.add_argument("--model", choices=["llama", "moe"], default="llama")
    t.add_argument("--preset", default="tiny",
                   help="the model's preset (llama: %s; moe: tiny, small, "
                        "mixtral-8x7b)" % ", ".join(LLAMA_PRESET_NAMES))
    t.add_argument("--steps", type=int, default=10)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--seq-len", type=int, default=128)
    t.add_argument("--sp-impl", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel attention when --seq > 1: ring "
                        "(K/V chunks travel round the ring) or ulysses "
                        "(all-to-alls between sequence and heads)")
    t.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches (--pipe > 1: a later slice)")
    t.add_argument("--pp-schedule", default="gpipe",
                   choices=["gpipe", "1f1b", "interleaved"],
                   help="pipeline schedule (--pipe > 1: a later slice)")
    t.add_argument("--virtual-stages", type=int, default=2,
                   help="layer chunks per device for --pp-schedule="
                        "interleaved (a later slice)")
    t.add_argument("--data", default=None, metavar="TOKENS.bin",
                   help="memmapped token file (uint16/uint32); default: "
                        "synthetic fixed batch")
    t.add_argument("--optimizer", choices=["adamw", "adam8bit"],
                   default="adamw",
                   help="adamw: optax.adamw(3e-4, weight_decay=0.1) "
                        "semantics; adam8bit: int8/f8 moment storage, half "
                        "the optimizer memory of bf16 moments")
    t.add_argument("--checkpoint-dir", default=None,
                   help="save here, and resume from its latest step; a "
                        "cfg.json there (workload convert) gives the model "
                        "in place of --model / --preset")
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save every N updates (0: only the last)")
    t.add_argument("--keep-checkpoints", type=int, default=3)
    t.set_defaults(fn=cmd_train)

    cv = sub.add_parser(
        "convert", help="import an HF Llama or Mixtral checkpoint into a "
                        "train checkpoint (+cfg.json sidecar)")
    _device_flags(cv)
    _mesh_flags(cv)
    cv.add_argument("--hf-path", required=True,
                    help="local HF checkpoint directory (config.json and "
                         "*.safetensors or pytorch_model*.bin)")
    cv.add_argument("--checkpoint-dir", required=True)
    cv.add_argument("--optimizer", choices=["adamw", "adam8bit"],
                    default="adamw",
                    help="optimizer whose fresh state is saved beside the "
                         "imported params (train resumes with the same)")
    cv.set_defaults(fn=cmd_convert)

    x = sub.add_parser(
        "exec-bench",
        help="execute the bootstrap's topology plan: time the planned "
             "DCN all-reduce vs ring/hierarchical/naive on the live "
             "process group (worker half of tools/exec_bench_torch.py)")
    _device_flags(x)
    x.add_argument("--bootstrap", default=None,
                   help="the agent's jax-coordinator.json with its plan "
                        "block (required): the process group's rendezvous, "
                        "rank and world, one process per GPU")
    x.add_argument("--sizes-mb", type=float, nargs="+",
                   default=[0.25, 1.0, 4.0],
                   help="payload sizes of the timed gradient all-reduce")
    x.add_argument("--iters", type=int, default=5,
                   help="timed iterations per point (best-of)")
    x.set_defaults(fn=cmd_exec_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
