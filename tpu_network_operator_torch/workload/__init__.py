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
  (``--hf-path``) as a step-0 train checkpoint plus its ``cfg.json``;
* ``collectives`` -- the all-reduce / all-gather / reduce-scatter /
  ppermute bandwidth sweep over one mesh axis (``--axis``, default the
  largest);
* ``exec-bench`` -- the operator's topology plan executed: the planned
  DCN all-reduce timed against ring, hierarchical and name-order axes
  (``--bootstrap`` required; ``tools/exec_bench_torch.py`` launches it).

``train --pipe N`` runs pipeline stages over N ranks (``--pp-schedule``
gpipe, 1f1b or interleaved with ``--virtual-stages``, ``--microbatches``;
with ``--seq``, ring attention inside each stage).  ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of the timed region.
"""

from .cli import build_parser, main
from .common import LLAMA_PRESET_NAMES, log

__all__ = ["build_parser", "main", "log", "LLAMA_PRESET_NAMES"]
