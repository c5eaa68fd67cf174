"""Validation-workload runner of the PyTorch port.

``python -m tpu_network_operator_torch.workload <subcommand>``, on one
device (``--device``, default cuda; ``cpu`` runs the kernels' plain
versions), with random weights:

* ``generate`` -- KV-cache decode throughput (tokens/sec) of a Llama-3
  preset;
* ``train`` -- training throughput (tokens/sec/chip) of a Llama-3 preset
  or, with ``--model moe``, a Mixtral-family MoE preset (tiny, small,
  mixtral-8x7b), with AdamW or 8-bit AdamW (``--optimizer adam8bit``), on
  a fixed synthetic batch or a token file (``--data``), resuming from and
  saving to ``--checkpoint-dir``.

The mesh flags, expert parallelism, HF import (``convert``), the
collectives sweep and the exec bench come with later slices.
"""

from .cli import build_parser, main
from .common import LLAMA_PRESET_NAMES, log

__all__ = ["build_parser", "main", "log", "LLAMA_PRESET_NAMES"]
