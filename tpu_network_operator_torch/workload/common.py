"""Shared plumbing for the workload subcommands: result emission, model
presets and ``--profile`` (the port's own copies of the reference's
helpers)."""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Optional

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


@contextlib.contextmanager
def maybe_profile(directory: Optional[str], name: str,
                  device: torch.device):
    """``torch.profiler`` over the block when ``directory`` is given (the
    ``--profile`` flag), else nothing: the host's ops and, on CUDA, the
    card's kernels and copies, written on exit as the Chrome trace
    ``<directory>/<name>.trace.json``."""
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        sync(device)
    path = os.path.join(directory, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    log(f"profile of {name} written to {path}")
