"""Shared plumbing for the workload subcommands: result emission and
model presets (the port's own copies of the reference's helpers)."""

from __future__ import annotations

import json
import sys

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(payload: dict) -> None:
    print(json.dumps(payload))


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def llama_presets():
    from ..models import LlamaConfig

    return {
        "tiny": LlamaConfig.tiny,
        "llama3-150m": LlamaConfig.llama3_150m,
        "llama3-1b": LlamaConfig.llama3_1b,
        "llama3-3b": LlamaConfig.llama3_3b,
        "llama3-8b": LlamaConfig.llama3_8b,
    }


def moe_presets():
    from ..models import MoEConfig

    return {
        "tiny": MoEConfig.tiny,
        "small": MoEConfig.small,
        "mixtral-8x7b": MoEConfig.mixtral_8x7b,
    }


LLAMA_PRESET_NAMES = (
    "tiny", "llama3-150m", "llama3-1b", "llama3-3b", "llama3-8b"
)


def pick_preset(presets: dict, name: str, model: str):
    if name not in presets:
        raise SystemExit(
            f"unknown preset {name!r} for model {model!r}; "
            f"choose from {sorted(presets)}"
        )
    return presets[name]()
