"""Validation-workload runner of the PyTorch port.

``python -m tpu_network_operator_torch.workload <subcommand>``, on one
device (``--device``, default cuda; ``cpu`` runs the kernels' plain
versions) or one process per device over a mesh (``--bootstrap``, or a
launcher's ``RANK`` / ``WORLD_SIZE`` environment; ``--tensor``, ``--seq``,
with fsdp taking the rest), with random weights:

* ``generate`` -- KV-cache decode throughput (tokens/sec) of a Llama-3
  preset;
* ``train`` -- training throughput (tokens/sec/chip) of a Llama-3 preset
  or, with ``--model moe``, a Mixtral-family MoE preset (tiny, small,
  mixtral-8x7b), with AdamW or 8-bit AdamW (``--optimizer adam8bit``), on
  a fixed synthetic batch or a token file (``--data``), resuming from and
  saving to ``--checkpoint-dir``, whose ``cfg.json`` (from ``convert``)
  gives the model;
* ``convert`` -- import a Hugging Face Llama or Mixtral checkpoint
  (``--hf-path``) as a step-0 train checkpoint plus its ``cfg.json``.

``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the timed
region.  Pipeline and expert parallelism, the MoE, adamw8bit and
checkpoints on a mesh of more than one process, the collectives sweep and
the exec bench come with later slices.
"""

from .cli import build_parser, main
from .common import LLAMA_PRESET_NAMES, log

__all__ = ["build_parser", "main", "log", "LLAMA_PRESET_NAMES"]
