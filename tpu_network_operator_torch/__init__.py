"""PyTorch/CUDA port of the validation workload, beside the JAX package.

``tpu_network_operator`` (JAX, written for the TPU) stays the reference;
this package serves the same Llama-3 models with PyTorch on an NVIDIA
Hopper GPU, with the reference's Pallas kernels rewritten by hand in CUDA
(``ops/csrc``).  It imports nothing from the JAX package.

Entry points take a ``device``: None means CUDA and raises when no GPU is
present; ``device="cpu"`` runs the kernels' plain PyTorch versions (what
the CPU tests hold against the JAX package).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA.  Raises when CUDA is
    asked for (or implied) and no GPU is present: nothing carries on
    silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
