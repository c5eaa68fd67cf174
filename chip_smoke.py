"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device: the torch device and ``nvidia-smi``'s name and power limit;
2. build: compile the CUDA kernels from ``tpu_network_operator_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel), with ptxas's registers
   and spills per kernel; a note that ptxas serialized a kernel's
   ``wgmma`` instructions fails the run;
3. kernels: each kernel, forward and backward, against its plain PyTorch
   version on the card;
4. generate: greedy ``generate`` of ``llama3-1b`` at full width and depth
   (random bf16 weights from a seeded CUDA generator), batch 64, prompt
   128, 256 new tokens, with the kernels' launch counts read from that run;
   then profiled prefills and decode steps for the device breakdown;
5. card_vs_cpu: the same bf16 weights (``llama3-1b`` widths, 2 layers) on
   the card (kernels) and on the CPU (plain versions);
6. train: the ``llama3-1b`` train step at full width and depth, batch 6 x
   2048, ``xent_chunk`` 1024, ``remat_policy`` "full", AdamW(3e-4, wd 0.1):
   a warm-up step, then timed steps on one fixed batch, with every kernel's
   launches per step read and the loss required to fall; then one
   profiled step;
7. train_card_vs_cpu: one loss and gradient at ``llama3-1b`` widths with 2
   layers from the same bf16 weights on the card and on the CPU;
8. train_adam8: the ``llama3-1b+ffn+adam8`` rung at full width and depth,
   batch 4 x 2048, ``xent_chunk`` 512, ``remat_policy`` "ffn",
   ``adamw8bit(3e-4, 0.1)``: a warm-up step, then timed steps on one fixed
   batch with every kernel's launches per step read and the loss required
   to fall, the moments' bytes beside bf16 moments'; then one profiled
   step;
9. checkpoint: ``llama3-1b`` widths with 2 layers and adamw8bit, batches
   from a token file through ``device_batches``: 2 steps, a save, 1 more
   step; the save restored in place into a fresh ``init_all`` state must be
   the same bits, and the resumed step must give the same loss;
10. train_moe: ``MoEConfig.small`` (Mixtral-family, 8 experts, top-2,
    head_dim 128) at full width and depth, batch 4 x 2048, the reference's
    defaults ("dots" remat, full logits), AdamW(3e-4, wd 0.1): a warm-up
    step, timed steps with kernels 1 to 5's launches per step read and the
    loss required to fall, one profiled step with the GEMMs split into
    dispatch/combine einsums, expert GEMMs and router; then 2 steps of
    ``adamw8bit`` on the same model (kernel 6 over its 13 leaves);
11. train_moe_card_vs_cpu: one loss and gradient at ``MoEConfig.small``
    widths with 2 layers, batch 1 x 256, on the card and on the CPU, with
    the share of routing choices the two make alike;
12. import_llama: Llama-3.2-1B's published config at full width and depth
    (tied embeddings, llama3 rope scaling) as an HF checkpoint of seeded
    random bf16 weights in two safetensors shards, written by this script
    and imported onto the card with ``convert.load_hf_checkpoint``: every
    leaf the source's bits, the tied head a tensor of its own; greedy
    ``generate`` at batch 64, prompt 128, 256 new tokens gives the
    source's tokens; 2 adamw8bit steps at 4 x 2048 ("ffn", xent 512)
    lower the loss and untie the head;
13. convert_train_llama, convert_train_mixtral: the workload CLI's
    ``convert --optimizer adam8bit`` of a 2-layer full-width checkpoint
    (that config; ``MoEConfig.small``'s widths as a Mixtral config), then
    ``train --checkpoint-dir`` with no ``--model`` for 3 steps of 4 x 2048:
    it resumes at step 0 as the sidecar's family, its first loss is the
    imported weights' ``loss_fn`` on that batch, and the loss falls;
14. remat_ffn_offload: the ``llama3-1b+ffn+adam8`` rung under "ffn" and
    "ffn_offload": one step from the same state gives the same bits; then
    each policy's step time, peak memory, copies over the host link and a
    pinned-copy bandwidth probe;
15. mesh_world1: a bootstrap file of the agent's schema (one process, one
    chip, a free local port) under ``.chip_smoke_tmp/`` starts the NCCL
    process group through the workload's ``init_distributed`` (the job
    lock held) and ``build_mesh`` builds the all-ones mesh; the
    collectives on that group are identities; the train cell's step (3
    steps) and greedy serving at batch 64, prompt 128, 128 new tokens run
    through the mesh path against the single-device path from the same
    seed: the loss within 1e-5 relative, every leaf within 1e-3 in
    relative norm (whether they are the same bits is printed), the same
    tokens, the same launches, each side's step time and tokens/s;
16. ring_virtual: the ring's per-step body over 4 chunks of one 8192-token
    sequence held in one process, forward and backward, at
    ``llama3-1b``'s and ``moe-small``'s attention geometry (D 64 and 128),
    against the dense flash call: 10 chunk forwards and 10 + 10 chunk
    backwards asserted, out within the bf16 atol, dq / dk / dv within the
    backward's relative-norm tolerance, the ring's device time beside the
    dense call's;
17. mesh_world1_moe: ``MoEConfig.small`` at full width and depth, batch
    4 x 2048, AdamW, through a world-1 NCCL mesh (a bootstrap file, as
    phase 15) beside the single-device MoE step from the same seed, 3
    steps each: the same losses and leaf bits, the same launches per
    step, each side's step time and peak memory;
18. expert_virtual: one layer of ``MoEConfig.small``'s expert FFN at the
    cell's 4 x 2048 tokens split into 2 and into 4 virtual expert shards
    in one process (each shard its experts' slice of the leaves and of
    dispatch/combine, the partials summed, as ranks sum them over
    ``expert``), forward and backward against the unsplit FFN: out and
    every gradient within 1% in relative norm and 2% of its largest
    value (the partials are rounded to bf16 before their sum), each
    side's time;
19. init_shards: ``mixtral-8x7b``'s tree drawn for virtual ranks 0 and 1
    of an ``expert`` axis of 8 (one expert a rank; no process group), slab
    by slab: the seconds, the parameters and ``max_memory_allocated``
    (under 30 GB), and the two ranks' replicated leaves the same bits;
20. mesh_world1_adam8: the adam8 cell's ``llama3-1b`` and then
    ``moe-small`` trained with optimizer "adam8bit" through a world-1
    NCCL mesh (``adamw8bit(mesh=, param_specs=)``) beside the
    single-device adam8 step from the same seed, 5 steps each (a warm-up,
    3 timed, 1 profiled): the same losses and every leaf, code and scale
    the same bits, one adam8_fused launch a step, its device ms in the
    step;
21. adam8_virtual_shards: every virtual rank of ``llama3-1b``'s 12 leaves
    at fsdp 2 x tensor 4 and at tensor 2, and of ``moe-small``'s 13 at
    expert 8 and at expert 2 x tensor 4, stepped twice in one process
    (``optim8bit.update_virtual_ranks``: one kernel launch a rank a step
    over its per-shard leaves and the concatenated rows of its
    global-block leaves): each rank's parameters, codes and scales the
    same bits as its slice of the whole tree stepped by the kernel; each
    rank's kernel ms against its bytes bound, and each leaf's path;
22. checkpoint_mesh: phase 9 through a world-1 NCCL mesh, every leaf
    saved as a DTensor: the round trip the same bits, the resumed loss
    the uninterrupted one; the mesh's save restored on one device, and a
    one-device save restored through the mesh, the same bits; the save's
    return, write and restore seconds and the bytes;
23. collectives_world1: the collectives sweep (``parallel/collectives.py``
    ``sweep``) over ``fsdp`` of a world-1 NCCL mesh from a bootstrap
    file, all four ops at 1, 64 and 256 MB, best of 5, on the axis's own
    one-rank NCCL group: every op's output its input, bit for bit; each
    point's seconds, algbw and busbw, which at one rank are NCCL's
    per-call time and not a bandwidth; then ``workload collectives
    --device cuda --bootstrap`` at that world prints the "nothing to
    sweep" line;
24. exec_bench_world1: ``workload exec-bench --device cuda --bootstrap``
    over a world-1 bootstrap whose plan block puts fsdp first and hints
    ``hierarchical``, at 1 and 64 MB, best of 3: the line's sha256 is the
    file's, its axis order and hint the plan's, the planned strategy
    hierarchical, which at ici 1 runs as ring (no reduce-scatter or
    all-gather issued), every timing positive; a mangled plan block falls
    back to the default axis order and ``ring``;
25. pipeline_virtual: the pipeline's executor with 4 stages held in one
    process (the in-process wire in place of the pipe axis's hops; one
    GPU, so no multi-rank NCCL) at the train cell (``llama3-1b``, 6 x
    2048, full remat, xent 1024, AdamW, phase 6's seed), 6 microbatches,
    under gpipe, 1f1b and interleaved (2 chunks a stage): each schedule's
    ``grads_fn`` against autograd of the single-device ``loss_fn`` on the
    same weights (the loss within 1e-3 relative; every leaf within 1% in
    relative norm of that loss_fn's gradients taken a microbatch at a
    time, and within 5% of the whole batch's: other bf16 GEMM shapes
    round other outputs), a warm-up and
    3 timed steps with the flash and RMSNorm launches a step asserted (6
    times the single-device step's), each schedule's step time and peak
    memory beside the single-device step's; then ``MoEConfig.small`` cut
    to 4 layers over 2 stages at 4 x 2048, 1f1b with 4 microbatches, 3
    steps: the loss falls, and its first loss is gpipe's within 5e-2;
26. probe: the port's CUDA device probe (``topology.from_runtime``): the
    card's name as ``nvidia-smi`` gives it, every visible device, a flat
    mesh ``(count,)``;
27. entry: ``graft.entry()``'s flagship forward (vocab 32,000, hidden
    1024, 8 layers, head_dim 64) on 2 x 128 constant tokens: logits
    [2, 128, 32000], finite, the flash forward and RMSNorm forward
    launches of one call, its device ms;
28. dryrun_world1: ``graft.dryrun_multichip(1)``, every section of the
    dry run through a world-1 NCCL mesh (2b skipped at pipe 1), two steps
    each: each section's losses, seconds and launches; kernel 6 in
    sections 1 and 1b, kernels 1 to 5 in 1b, 1b's two losses on random
    tokens within 5e-2 of the plain steps on the CPU;
    ``dryrun_multichip(2)`` refused on a one-card machine;
29. perf_decomp: ``measure.decompose`` at ``tools/perf_decomp.py``'s
    defaults (``llama3-1b``, 4 x 2048, "full" remat, xent 512, AdamW, 10
    calls a stage): the forward, forward + backward and step seconds,
    MFU, the multipliers and the bf16 matmul probe; the step's loss
    finite and its seconds within 15% of ``measure.measure``'s at the
    same shape;
30. remat_search: ``measure.remat_search`` of ``llama3-1b`` over the five
    remat policies x adam8 / adamw at batch 4 x 2048, xent 512: every row
    that ran has a loss in (0, 20), at least one row per optimizer ran,
    rows out of device memory reported as failed;
31. the kernel table: each kernel's time at its path's shapes beside its
    bound, its plain version's time and one PyTorch library call's, the
    flash kernels also at the MoE cell's head_dim 128 and as the ring's
    chunk calls (2048 x 2048, the diagonal and a past chunk, f32
    backward outputs), kernel 6 per virtual rank, and its launches in
    every path above.

Phase 3 also holds the 8-bit AdamW kernel to its plain version over three
steps with carried state, bit for bit, each leaf shape alone, the 12
``llama3-1b`` leaves with three edge-case leaves in one launch, and the MoE
leaf shapes (an f32 router, a bf16 expert slice); the table gives its time
at the largest leaf, over the 12 leaves one launch each and in one launch,
and inside the profiled adam8 step.  Phase 8 also counts the matmuls that
the "ffn" policy reruns in the layers' backward (3 a layer).

    python3 chip_smoke.py --adam8-leaves

times only the 8-bit AdamW update at the ``llama3-1b`` leaves through
``AdamW8bit.apply`` (each leaf alone, all 12 at once, a separate
``p.add_`` pass) and profiles the adam8 step's update launches;

    python3 chip_smoke.py --remat-ffn

profiles only the adam8 step (3 steps) and counts its layers' backward
matmuls.  Both modes use only entry points an older tree has, so they
compare two trees in one call.

    python3 chip_smoke.py --collectives

runs only phases 23 and 24 (no kernel build) in a fresh process: NCCL's
per-call floor at one rank there, beside the same phases at the end of
the whole script.

    python3 chip_smoke.py --pipeline

builds the kernels and runs only phase 25.

    python3 chip_smoke.py --remat-search

builds the kernels and runs only phase 30 at ``tools/remat_search.py``'s
batches, 4 and 8.

The second-to-last line is ``nvidia-smi``'s ``name, power.limit``; the
last is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU and exits
non-zero without one, printing no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import itertools
import json
import math
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpu_network_operator_torch.models.generate import (  # noqa: E402
    forward_with_cache,
    generate,
    init_cache,
)
from tpu_network_operator_torch import data  # noqa: E402
from tpu_network_operator_torch.models import convert  # noqa: E402
from tpu_network_operator_torch.models import optim8bit  # noqa: E402
from tpu_network_operator_torch.models import training  # noqa: E402
from tpu_network_operator_torch.models.checkpoint import (  # noqa: E402
    TrainCheckpointer,
    flat_state,
)
from tpu_network_operator_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    forward_hidden,
    init_params,
    loss_fn,
    make_train_step,
    params_to,
    shard_params,
)
# measure.peaks: the published dense peaks per SKU (device memory B/s,
# bf16 tensor FLOP/s, f32 non-tensor FLOP/s), the measuring tools' table
from tpu_network_operator_torch import measure  # noqa: E402
from tpu_network_operator_torch.ops import _kernels  # noqa: E402
from tpu_network_operator_torch.ops import flash_attention as fa  # noqa: E402
from tpu_network_operator_torch.ops import norms  # noqa: E402
from tpu_network_operator_torch.parallel import ring  # noqa: E402

BATCH, PROMPT, NEW_TOKENS = 64, 128, 256
SEED = 0
# the training cell: the repo's headline train rung (bench.py llama3-1b)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK, TRAIN_STEPS = 6, 2048, 1024, 3
# the 8-bit AdamW cell: bench.py's llama3-1b+ffn+adam8 rung
A8_BATCH, A8_SEQ, A8_CHUNK, A8_LR, A8_WD = 4, 2048, 512, 3e-4, 0.1
# the checkpoint phase: llama3-1b widths, 2 layers, batches of 2 x 1024
CKPT_LAYERS, CKPT_BATCH, CKPT_SEQ = 2, 2, 1024
# the MoE cell: MoEConfig.small at full width and depth with the
# reference's defaults ("dots" remat, full logits), AdamW; then a short
# adamw8bit run of the same model
MOE_BATCH, MOE_SEQ, MOE_STEPS, MOE_A8_STEPS = 4, 2048, 4, 2
SCRATCH = Path(__file__).resolve().parent / ".chip_smoke_tmp"
# the mesh at a world of one: the train cell's step (3 steps) and serving
# (MESH_NEW_TOKENS) through the mesh path, against the single-device path
MESH_NEW_TOKENS = 128
# the ring's schedule over RING_CHUNKS chunks of one RING_SEQ sequence in
# one process, at llama3-1b's and moe-small's attention geometry
# [B, S, H, Hkv, D]
RING_CHUNKS, RING_SEQ = 4, 8192
RING_GEOMS = {"llama3-1b": (1, RING_SEQ, 32, 8, 64),
              "moe-small": (1, RING_SEQ, 16, 8, 128)}
# the import phases: Llama-3.2-1B's published config.json
# (meta-llama/Llama-3.2-1B: tied embeddings, llama3 rope scaling), and
# MoEConfig.small's widths as a Mixtral config.json (Mixtral-8x7B's
# rope_theta, router_aux_loss_coef and null sliding_window); the weights
# are seeded random bf16, written as HF checkpoints by this script
LLAMA32_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "hidden_act": "silu",
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "attention_bias": False, "mlp_bias": False, "torch_dtype": "bfloat16",
    "bos_token_id": 128000, "eos_token_id": 128001,
}
MIXTRAL_SMALL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 2048, "intermediate_size": 5632,
    "num_hidden_layers": 16, "num_attention_heads": 16,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "hidden_act": "silu",
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "sliding_window": None,
    "router_aux_loss_coef": 0.02, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
# convert -> train: 2 layers at full width (a full-depth step-0 save would
# write over 10 GB), 3 steps of A8_BATCH x A8_SEQ
CONVERT_LAYERS, CONVERT_STEPS = 2, 3

# the designs of the kernels redesigned for Hopper
DESIGN = {
    "flash_fwd": "persistent grid (a block per SM) over 128-row q tiles, "
                 "2 consumer warpgroups + TMA producer; 128-key K/V tiles "
                 "in a 3-stage TMA/mbarrier ring (128B swizzle); S and O "
                 "by wgmma, softmax in registers overlapped with the "
                 "warpgroup's own P V, P as register A operand",
    "flash_bwd_dq": "persistent grid (a block per SM) over 128-row q "
                    "tiles, 2 consumer warpgroups + TMA producer; Q and dO "
                    "by TMA into two slots, 64-key K/V tiles in a 96 KB "
                    "TMA/mbarrier ring; S, dP and dQ += dS K by wgmma (K "
                    "read K-major and MN-major from one stage), dS in "
                    "registers overlapped with the warpgroup's own dQ "
                    "product",
    "flash_bwd_dkv": "128-key tile of one kv-head resident in shared memory,"
                     " 2 consumer warpgroups + producer warpgroup; 64-row "
                     "Q/dO steps in a 4-stage TMA/mbarrier ring, Q scaled "
                     "by the producer; S^T, dP^T, dV, dK by wgmma, dK/dV in "
                     "registers over the GQA group, elementwise work "
                     "overlapped with dV/dK at D 64",
    "adam8_fused": "one launch for up to 32 leaves (a leaf table passed by "
                   "value), a persistent grid walking the leaves' "
                   "concatenated 256-value blocks a warp each, the next "
                   "block's loads in flight, p updated in place; per block "
                   "on a warp-uniform branch: the division and root fast "
                   "paths written out for moments in [2^-80, 2^40], no "
                   "division for an all-zero block, the intrinsics "
                   "otherwise; whole-row or unaligned leaves take a "
                   "two-pass row loop in the same kernel",
    "rms_norm_fwd": "one warp per row, warps walking rows grid-stride over "
                    "a grid the card holds at once with the next row's "
                    "loads in flight; the row in registers (16-byte loads, "
                    "all issued before the reduction), a shuffle-only sum "
                    "of squares, scale kept in registers across a warp's "
                    "rows; eight warps a row where all rows fit on the "
                    "card at once",
}

# kernel vs plain on the card.  RMSNorm: both take the f32 sum of squares
# in different orders and rsqrtf is approximate, which can flip one bf16
# rounding of y (2^-8 relative).  Flash: the plain versions run at the
# kernels' own tiles (fa.FWD_TILE, fa.DQ_TILE, fa.DKV_TILE); f32 sums in
# other orders and exp2 against exp can flip one bf16 rounding of p or O.
RMS_TOL = {"rtol": 1e-2, "atol": 1e-2}
FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-4
# card vs CPU, bf16 through 2 full-width layers: normalized max deviation
# (the JAX flash suite's discipline for bf16 op-ordering differences)
LOGITS_MAX_REL = 5e-2
# backward kernels vs plain, bf16 outputs: one rounding of an operand (p,
# dS) may flip between two f32 summation orders, so the max deviation is
# held to 2% of the largest gradient and the relative norm of the
# difference to 1%; the f32 chunk outputs (no output rounding) likewise
GRAD_MAX_FRAC = 2e-2
GRAD_REL = 1e-2
# RMSNorm backward: dx as the forward's y (one bf16 rounding); dscale sums
# 12288 rows in another order and rounds once, relative to its largest
RMS_DS_FRAC = 1e-2
# train card vs CPU: bf16 matmuls accumulate in other orders on the two
# devices through 2 layers forward and back (the CPU parity tests see
# ~1.3e-2 in relative norm between the port and JAX in bf16)
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL = 5e-2
# 8-bit AdamW kernel vs plain: both round every f32 operation on its own
# (no FMA contraction, true divisions, a correctly rounded sqrt), so the
# requirement is the same bits.  Were it missed, the run would say how
# many values differ and hold to the JAX suite's bound between its own two
# paths (tests/test_optim8bit.py:133-151): update rtol 1e-2 (atol 1e-6),
# int8 m codes equal, scales rtol 1e-6, v codes within one e4m3 step
A8_TOL = {"update_rtol": 1e-2, "update_atol": 1e-6, "scale_rtol": 1e-6,
          "v_code_rtol": 0.07}
# checkpoint resume: the restored state and the resumed loss are the same
# bits; the parameters after the resumed step may differ where the
# embedding gradient's scatter adds in another order: each weight within
# 2 * lr (a moment's code one step away) plus one bf16 ulp of itself
CKPT_PARAM_ATOL = 2 * A8_LR
# the mesh at a world of one against one device: the same operations on
# the same bits, so anything past the f32 loss's last digits or a leaf's
# rounding is a fault of the mesh path
MESH_LOSS_REL = 1e-5
MESH_LEAF_REL = 1e-3
# the MoE on the mesh: the MoE cell's step through a world-1 mesh
# (MESH_MOE_STEPS each way), its expert FFN over EXPERT_SHARDS virtual
# expert shards, and mixtral-8x7b drawn for one rank of INIT_EXPERTS
MESH_MOE_STEPS = 3
EXPERT_SHARDS = (2, 4)
INIT_EXPERTS = 8
# a rank's mixtral-8x7b tree at expert 8 (about 7.24 B parameters, 14.5
# GB in bf16) plus one f32 expert slab (7.5 GB) must stay under this
INIT_PEAK_LIMIT = 30e9
# the 8-bit AdamW on shards: the adam8 cell's model and moe-small with
# adamw8bit through a world-1 mesh (MESH_A8_STEPS each way: a warm-up,
# timed steps, a profiled one), and every virtual rank of these meshes
# stepped in one process (A8_VIRTUAL_STEPS) against the whole tree's update
MESH_A8_STEPS = 5
A8_VIRTUAL_MESHES = {
    "llama3-1b": (dict(fsdp=2, tensor=4), dict(tensor=2, fsdp=1)),
    "moe-small": (dict(expert=8, fsdp=1), dict(expert=2, tensor=4, fsdp=1)),
}
A8_VIRTUAL_STEPS = 2
# the collectives at a world of one: the sweep's sizes and best-of count,
# and exec-bench's over a plan block that puts fsdp first and hints
# hierarchical
COLL_SIZES_MB = (1, 64, 256)
COLL_ITERS = 5
EXEC_SIZES_MB = (1.0, 64.0)
EXEC_ITERS = 3
EXEC_PLAN = {"version": "chip-smoke-1", "ring": ["node-0"], "ringIndex": 0,
             "collective": "hierarchical",
             "meshAxisOrder": ["fsdp", "data", "pipe", "expert", "seq",
                               "tensor"]}
# the pipeline over virtual stages in one process: the train cell
# (llama3-1b, 6 x 2048, full remat, xent 1024, AdamW) over PIPE_STAGES
# stages and PIPE_MICRO microbatches, each schedule (interleaved with
# PIPE_V chunks a stage), held to the single-device loss and gradients;
# then moe-small cut to PIPE_MOE_LAYERS layers over PIPE_MOE_STAGES stages
PIPE_STAGES, PIPE_MICRO, PIPE_V, PIPE_STEPS = 4, 6, 2, 3
PIPE_SCHEDULES = ("gpipe", "1f1b", "interleaved")
PIPE_MOE_LAYERS, PIPE_MOE_STAGES, PIPE_MOE_MICRO = 4, 2, 4
# the loss to 1e-3 relative of one device's.  The gradients against one
# device's loss_fn taken a microbatch at a time (the same bf16 GEMM
# shapes as the units; the sums in another order): GRAD_REL.  Against one
# device's whole-batch gradients, TRAIN_GRAD_REL: a GEMM over a sixth of
# the rows rounds its bf16 outputs (the cotangents through 16 layers,
# each microbatch's weight gradients) where cuBLAS's kernel for the whole
# batch rounds others, 1.0% to 1.5% in relative norm on an H100 (700 W);
# the MoE's two schedules (the same estimator, other orders) within the
# reference's schedule budget
PIPE_LOSS_REL = 1e-3
PIPE_MOE_SCHEDULE_TOL = 5e-2
# the perf decomposition at tools/perf_decomp.py's defaults (llama3-1b, 4
# x 2048, "full" remat, xent chunks of 512, AdamW, 10 calls a stage); its
# step time against measure()'s at the same shape in the same run, a
# check that the two timers agree (not a speed gate)
DECOMP_BATCH, DECOMP_SEQ, DECOMP_ITERS, DECOMP_CHUNK = 4, 2048, 10, 512
DECOMP_STEP_REL = 0.15
# the remat sweep (five policies x adam8 / adamw) of llama3-1b at 2048
# positions, xent 512: batch 4 in the whole script, tools/remat_search.py's
# 4 and 8 under --remat-search
SWEEP_BATCHES, SWEEP_FULL_BATCHES = (4,), (4, 8)
SWEEP_OPTS = ("adam8", "adamw")


def emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


def fail(msg: str) -> None:
    emit({"error": msg})
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 11) -> float:
    """Device time of one call: ``iters`` back-to-back calls are captured
    in a CUDA graph (so the host's Python and launch overhead is not in
    the number), the graph is replayed ``reps`` times between CUDA events
    after a warm-up, and the median per-call time is returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(samples)


def time_ms_eager(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one call without a CUDA graph: ``iters`` calls
    between CUDA events, median of ``reps``.  For calls whose device time
    (milliseconds) far exceeds their host time, e.g. autograd backwards."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_norm(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return ((a.float() - ref).norm() / ref.norm().clamp_min(1e-12)).item()


def grad_ok(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The backward tolerance (GRAD_MAX_FRAC, GRAD_REL) with its numbers."""
    err = max_err(out, ref)
    big = ref.float().abs().max().item()
    rel = rel_norm(out, ref)
    return {"max_abs_err": err, "max_ref": big, "rel_norm": rel,
            "ok": err <= GRAD_MAX_FRAC * max(big, 1.0) and rel <= GRAD_REL}


# -- phases -------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        raise SystemExit(2)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    report = _kernels.ptxas_report()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": path.name,
          "ptxas": None if report is None else report["kernels"]})
    # a serialized wgmma costs the flash kernels their overlap, silently
    check(report is not None, "no ptxas report beside the library")
    check(not report["wgmma_serialized"],
          f"ptxas serialized wgmma: {report['wgmma_serialized']}")


def _rms_case(shape, gen):
    x = (torch.randn(shape, device="cuda", generator=gen) * 2).bfloat16()
    s = (torch.randn(shape[-1], device="cuda", generator=gen) + 1).bfloat16()
    return x, s


def _flash_case(b, h, hkv, s, d, gen):
    def rnd(heads):
        return torch.randn(b, s, heads, d, device="cuda",
                           generator=gen).bfloat16()
    return rnd(h), rnd(hkv), rnd(hkv)


def _flash_plain_bshd(q, k, v, causal):
    """The plain forward at the forward kernel's tiles."""
    o, lse = fa._flash_fwd_plain_at_tiles(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal)
    return o.transpose(1, 2), lse


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(SEED)
    # the decode (few rows: eight warps a row), prefill and train shapes,
    # a wide row, the widest (half of it streamed past the registers), and
    # rows that the warps walk in uneven turns
    for shape in [(64, 2048), (8192, 2048), (12288, 2048), (5, 4096),
                  (33, 8192), (4099, 2048)]:
        x, s = _rms_case(shape, gen)
        y, rstd = norms.fused_rms_norm(x, s, 1e-5)
        y2, rstd2 = norms.fused_rms_norm(x, s, 1e-5)
        torch.cuda.synchronize()
        ref = norms._rms_norm_plain(x, s, 1e-5)
        ref_rstd = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
        err = max_err(y, ref)
        same_bits = torch.equal(bits(y), bits(y2)) and \
            torch.equal(bits(rstd), bits(rstd2))
        ok = torch.allclose(y.float(), ref.float(), **RMS_TOL) and \
            torch.allclose(rstd, ref_rstd, rtol=1e-5, atol=0) and same_bits
        emit({"phase": "kernels", "kernel": "rms_norm_fwd",
              "shape": list(shape), "max_abs_err": err, "tol": RMS_TOL,
              "repeat_same_bits": same_bits, "ok": ok})
        check(ok, f"rms_norm_fwd disagrees with its plain version at {shape}")
    cases = [(2, 32, 8, s, 64, c) for s in (128, 1024) for c in (True, False)]
    cases.append((2, 16, 4, 512, 128, True))
    # ragged rows and keys, and D 128 with n_rep 4 and 1
    cases += [(2, 32, 8, 200, 64, True), (1, 32, 8, 777, 64, False),
              (2, 16, 4, 777, 128, True), (1, 16, 16, 1024, 128, False)]
    for b, h, hkv, s, d, causal in cases:
        q, k, v = _flash_case(b, h, hkv, s, d, gen)
        o, lse = fa._flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                      head_dim=2)
        torch.cuda.synchronize()
        ro, rlse = _flash_plain_bshd(q, k, v, causal)
        err_o, err_l = max_err(o, ro), max_err(lse, rlse)
        ok = err_o <= FLASH_O_ATOL and err_l <= FLASH_LSE_ATOL
        emit({"phase": "kernels", "kernel": "flash_fwd",
              "shape": [b, s, h, hkv, d], "causal": causal,
              "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
              "tol": {"o": FLASH_O_ATOL, "lse": FLASH_LSE_ATOL}, "ok": ok})
        check(ok, f"flash_fwd disagrees with its plain version at "
                  f"{(b, h, hkv, s, d, causal)}")


def _flash_bwd_inputs(b, h, hkv, s, d, causal, gen):
    """q, k, v, a cotangent dO, and the forward kernel's lse and delta."""
    q, k, v = _flash_case(b, h, hkv, s, d, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    o, lse = fa._flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                  head_dim=2)
    delta = fa.attention_delta(o.transpose(1, 2), do.transpose(1, 2))
    return q, k, v, do, lse, delta


def _flash_bwd_kernels(q, k, v, do, lse, delta, causal):
    kw = dict(causal=causal, seq_dim=1, head_dim=2, out_f32=False)
    dq = fa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    return (dq, *fa._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw))


def _flash_bwd_plain_bshd(q, k, v, do, lse, delta, causal):
    """The plain backward at the kernels' tiles, outputs cast as the dense
    path casts them."""
    dq, dk, dv = fa._flash_bwd_plain_at_tiles(
        *(t.transpose(1, 2) for t in (q, k, v, do)), lse, delta,
        causal=causal, dq_dtype=q.dtype)
    return (dq.transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def _grads_ok(outs, refs):
    res = {n: grad_ok(o, r) for n, o, r in zip(("dq", "dk", "dv"), outs,
                                                refs)}
    return res, all(r["ok"] for r in res.values())


def phase_kernels_bwd():
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    # the training shape, a ragged row count, wide rows, and a hidden that
    # is no multiple of the 16-byte vector (the scalar path)
    for shape in [(12288, 2048), (777, 2048), (5, 4096), (3, 100)]:
        x, s = _rms_case(shape, gen)
        dy = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        _, rstd = norms.fused_rms_norm(x, s, 1e-5)
        dx, ds = norms.rms_norm_bwd(x, s, rstd, dy)
        torch.cuda.synchronize()
        rdx, rds = norms._rms_norm_bwd_plain(x, s, rstd, dy)
        ds_err = max_err(ds, rds)
        ds_big = rds.float().abs().max().item()
        ok = torch.allclose(dx.float(), rdx.float(), **RMS_TOL) and \
            ds_err <= RMS_DS_FRAC * max(ds_big, 1.0)
        emit({"phase": "kernels", "kernel": "rms_norm_bwd",
              "shape": list(shape), "max_abs_err_dx": max_err(dx, rdx),
              "max_abs_err_dscale": ds_err, "max_dscale": ds_big,
              "tol": {"dx": RMS_TOL, "dscale_frac": RMS_DS_FRAC}, "ok": ok})
        check(ok, f"rms_norm_bwd disagrees with its plain version at {shape}")
    # n_rep 4 and 1, causal and not, S 128 to 2048, D 64 and 128
    cases = [(2, 32, 8, s, 64, c) for s in (128, 1024) for c in (True, False)]
    cases += [(1, 32, 8, 2048, 64, True), (2, 16, 16, 512, 128, True),
              (1, 16, 4, 1024, 128, False), (1, 8, 8, 256, 64, False)]
    for b, h, hkv, s, d, causal in cases:
        inputs = _flash_bwd_inputs(b, h, hkv, s, d, causal, gen)
        outs = _flash_bwd_kernels(*inputs, causal)
        # no atomics, and dK/dV sums each group in a fixed order: a second
        # launch of each must give the same bits
        again = _flash_bwd_kernels(*inputs, causal)
        torch.cuda.synchronize()
        same_bits = all(torch.equal(bits(a), bits(r))
                        for a, r in zip(outs, again))
        res, ok = _grads_ok(outs, _flash_bwd_plain_bshd(*inputs, causal))
        ok = ok and same_bits
        emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkv",
              "shape": [b, s, h, hkv, d], "causal": causal, **res,
              "repeat_same_bits": same_bits,
              "tol": {"max_frac": GRAD_MAX_FRAC, "rel_norm": GRAD_REL},
              "ok": ok})
        check(ok, f"flash backward disagrees with its plain version at "
                  f"{(b, h, hkv, s, d, causal)}")
    # chunk_bwd: the ring seam, [B, H, S, D] through strides, f32 outputs
    for causal in (True, False):
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in _flash_case(2, 32, 8, 1024, 64, gen))
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        o, lse = fa.chunk_fwd(q, k, v, causal=causal)
        delta = fa.attention_delta(o, do)
        outs = fa.chunk_bwd(q, k, v, do, lse, delta, causal=causal)
        torch.cuda.synchronize()
        refs = fa._flash_bwd_plain_at_tiles(q, k, v, do, lse, delta,
                                            causal=causal)
        res, ok = _grads_ok(outs, refs)
        ok = ok and all(t.dtype == torch.float32 for t in outs)
        emit({"phase": "kernels", "kernel": "chunk_bwd (f32)",
              "shape": [2, 1024, 32, 8, 64], "causal": causal, **res,
              "ok": ok})
        check(ok, f"chunk_bwd disagrees with its plain version "
                  f"(causal={causal})")
    # dQ at its edges: ragged rows and keys, Sq != Sk in [B, H, S, D]
    # (the ring seam's past chunk), D 128 with n_rep 4 and 1, bf16 and f32
    for case in DQ_EDGES:
        dq_edge_case(gen, *case)


# (b, sq, sk, h, hkv, d, causal, layout, out_f32)
DQ_EDGES = [
    (2, 200, 200, 8, 2, 64, True, "bshd", False),
    (1, 777, 777, 4, 1, 64, True, "bshd", True),
    (1, 777, 777, 8, 2, 128, False, "bshd", False),
    (2, 192, 320, 8, 2, 64, False, "bhsd", True),
    (1, 256, 512, 4, 1, 128, False, "bhsd", True),
    (2, 512, 512, 16, 4, 128, True, "bshd", False),
    (1, 384, 384, 8, 8, 128, True, "bhsd", True),
]


def dq_edge_case(gen, b, sq, sk, h, hkv, d, causal, layout, out_f32):
    """The dQ kernel against its plain version at DQ_TILE, and its
    repeat bits, in either layout."""
    seq = 1 if layout == "bshd" else 2
    dims = dict(seq_dim=seq, head_dim=3 - seq)

    def bhsd(t):
        return t.transpose(1, 2) if seq == 1 else t

    def rnd(heads, n):
        shape = (b, n, heads, d) if seq == 1 else (b, heads, n, d)
        return torch.randn(shape, device="cuda", generator=gen).bfloat16()

    q, k, v, do = rnd(h, sq), rnd(hkv, sk), rnd(hkv, sk), rnd(h, sq)
    o, lse = fa._flash_fwd_kernel(q, k, v, causal=causal, **dims)
    delta = fa.attention_delta(bhsd(o), bhsd(do))
    kw = dict(causal=causal, out_f32=out_f32, **dims)
    dq = fa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    again = fa._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    bp = fa._bwd_plain_at(*(bhsd(t) for t in (q, k, v, do)), lse, delta,
                          fa.DQ_TILE, causal)
    ref = bhsd(fa._flash_bwd_dq_plain(
        bp, torch.float32 if out_f32 else torch.bfloat16))
    res = grad_ok(dq, ref)
    same_bits = torch.equal(bits(dq), bits(again))
    ok = res["ok"] and same_bits and dq.dtype == ref.dtype \
        and dq.shape == q.shape
    emit({"phase": "kernels", "kernel": "flash_bwd_dq",
          "shape": [b, sq, sk, h, hkv, d], "causal": causal,
          "layout": layout, "out_f32": out_f32, **res,
          "repeat_same_bits": same_bits,
          "tol": {"max_frac": GRAD_MAX_FRAC, "rel_norm": GRAD_REL},
          "ok": ok})
    check(ok, f"flash_bwd_dq disagrees with its plain version at "
              f"{(b, sq, sk, h, hkv, d, causal, layout, out_f32)}")


def kernel_group(name: str) -> str:
    """A device kernel's group for the time breakdown."""
    for key, group in (("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_bwd"),
                       ("rms_norm", "rms_norm"), ("adam8", "adam8_fused"),
                       ("nvjet", "gemm"),
                       ("gemm", "gemm"), ("cutlass", "gemm"),
                       ("at::native", "aten elementwise/reduce")):
        if key in name:
            return group
    return "other"


def launch_events(prof, key: str) -> list:
    """Every device kernel of a profile whose name holds ``key``, in the
    order the card ran them: its device ms, and the name and device ms of
    the kernel the card ran next."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [{"ms": e.time_range.elapsed_us() / 1e3,
             "next": nxt.name[:80] if nxt else None,
             "next_ms": nxt.time_range.elapsed_us() / 1e3 if nxt else None}
            for e, nxt in zip(evs, [*evs[1:], None]) if key in e.name]


def _device_us(event) -> float:
    """The device time of the kernels a CPU event (an op or a
    ``record_function`` range) launched, its children's included."""
    us = getattr(event, "device_time_total", None)
    return event.cuda_time_total if us is None else us


def gemm_groups(prof, op_group, steps: int) -> dict:
    """Device ms per step of the GEMM calls (``aten::mm`` / ``aten::bmm``,
    forward and backward), summed per the name ``op_group(input_shapes)``
    gives each: the kernels each such call launched."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU \
                or e.name not in ("aten::mm", "aten::bmm"):
            continue
        group = op_group(e.input_shapes)
        out[group] = out.get(group, 0.0) + _device_us(e) / steps / 1e3
    return dict(sorted(out.items()))


def profile_steps(run, steps: int, follow: str = "",
                  op_group=None, ranges=()) -> dict:
    """torch.profiler over ``steps`` calls of ``run()``: wall time per
    step, the device's busy share (sum of kernel times over wall time; one
    stream, so kernels do not overlap) and the kernels that take the most
    device time; with ``follow``, every launch of the kernels whose name
    holds it (:func:`launch_events`); with ``op_group``, the GEMMs' device
    time split by their operand shapes (:func:`gemm_groups`); with
    ``ranges``, the device time inside each ``record_function`` range of
    those names.  The profiler's own host cost is inside the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=op_group is not None) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels a second time, and a record_function range
    # shows on the device timeline too, spanning its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    groups = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    out = {
        "steps": steps,
        "step_ms": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "device_ms_per_step": busy_us / steps / 1e3 if busy_us else None,
        "ms_per_step_by_group": {g: us / steps / 1e3
                                 for g, us in sorted(groups.items())},
        "top_kernels": [
            {"name": e.key[:80], "calls_per_step": e.count / steps,
             "ms_per_step": e.self_device_time_total / steps / 1e3}
            for e in top
        ],
    }
    if follow:
        out["launches_of_" + follow] = launch_events(prof, follow)
    if op_group:
        out["gemm_ms_per_step_by_operands"] = gemm_groups(prof, op_group,
                                                          steps)
    if ranges:
        out["ms_per_step_in_ranges"] = {
            name: sum(_device_us(e) for e in prof.events()
                      if e.name == name and e.device_type == DeviceType.CPU)
            / steps / 1e3 for name in ranges}
    return out


def profile_prefill(params, cfg, cache, prompt, calls: int = 3) -> dict:
    """The profile of ``calls`` prefills of the whole prompt batch (each
    writes the cache from position 0 again)."""
    def run():
        forward_with_cache(params, prompt, cache, 0, cfg, attn_len=PROMPT)

    with torch.inference_mode():
        return profile_steps(run, calls)


def profile_decode(params, cfg, cache, tok, steps: int = 32) -> dict:
    """The profile of ``steps`` greedy decode steps after a prefill."""
    state = {"tok": tok, "i": 0}

    def run():
        logits, _ = forward_with_cache(params, state["tok"][:, None].long(),
                                       cache, PROMPT + state["i"], cfg,
                                       attn_len=256)
        state["tok"] = logits[:, -1].argmax(-1)
        state["i"] += 1

    with torch.inference_mode():
        return profile_steps(run, steps)


def phase_generate():
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator("cuda").manual_seed(SEED)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                           generator=gen)
    forward_calls = NEW_TOKENS        # one prefill + NEW_TOKENS - 1 steps

    def drive():
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, prompt, cfg, NEW_TOKENS)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_kernels.LAUNCHES)

    out, first_s, _ = drive()
    out, dt, launches = drive()

    # prefill alone, then profiled prefills and a profiled window of
    # decode steps, for the breakdown (outside the counted run)
    cache = init_cache(cfg, BATCH, PROMPT + NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = forward_with_cache(params, prompt, cache, 0, cfg,
                                       attn_len=PROMPT)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_profile = profile_prefill(params, cfg, cache, prompt)
    profile = profile_decode(params, cfg, cache, logits[:, -1].argmax(-1))
    del cache, logits

    check(tuple(out.shape) == (BATCH, PROMPT + NEW_TOKENS),
          f"generate returned shape {tuple(out.shape)}")
    check(bool(torch.equal(out[:, :PROMPT].long(), prompt)),
          "generate did not keep the prompt")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          "generated ids outside the vocabulary")
    want = {"flash_fwd": cfg.layers,
            "rms_norm_fwd": (2 * cfg.layers + 1) * forward_calls,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "rms_norm_bwd": 0,
            "adam8_fused": 0}
    check(launches == want, f"kernel launches {launches}, expected {want}")
    emit({"phase": "generate", "preset": "llama3-1b", "layers": cfg.layers,
          "params": cfg.num_params(), "batch": BATCH, "prompt": PROMPT,
          "new_tokens": NEW_TOKENS,
          "tokens_per_s": BATCH * NEW_TOKENS / dt,
          "seconds": dt, "first_call_seconds": first_s,
          "prefill_ms": prefill_s * 1e3,
          "decode_step_ms": (dt - prefill_s) / (NEW_TOKENS - 1) * 1e3,
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "out_shape": list(out.shape)})
    emit({"phase": "profile_prefill", **prefill_profile})
    emit({"phase": "profile_decode", **profile})
    del params
    torch.cuda.empty_cache()
    return launches


def phase_card_vs_cpu():
    cfg = LlamaConfig(hidden=2048, layers=2, heads=32, kv_heads=8, ffn=8192)
    params_gpu = init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED + 1), "cuda")
    params_cpu = params_to(params_gpu, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, PROMPT),
                           generator=torch.Generator().manual_seed(SEED + 2))
    logits = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        cache = init_cache(cfg, 2, PROMPT + 8, device=dev)
        with torch.inference_mode():
            lg, _ = forward_with_cache(params, prompt.to(dev), cache, 0, cfg,
                                       attn_len=PROMPT)
        logits[dev] = lg[:, -1].float().cpu()
    out_cpu = generate(params_cpu, prompt, cfg, 8)
    out_gpu = generate(params_gpu, prompt.cuda(), cfg, 8).cpu()
    ref = logits["cpu"]
    rel = max_err(logits["cuda"], ref) / ref.abs().max().clamp_min(1e-3).item()
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    first_equal = bool(torch.equal(out_cpu[:, PROMPT], out_gpu[:, PROMPT]))
    agree = (out_cpu[:, PROMPT:] == out_gpu[:, PROMPT:]).float().mean().item()
    emit({"phase": "card_vs_cpu", "layers": cfg.layers, "batch": 2,
          "logits_max_rel": rel, "tol": LOGITS_MAX_REL,
          "top1_margin_cpu": margin, "first_token_equal": first_equal,
          "token_agreement": agree})
    check(rel < LOGITS_MAX_REL, f"card vs CPU step-0 logits: {rel}")
    check(first_equal, "card vs CPU: first greedy token differs")


def remat_launches(n: int) -> dict:
    """Flash and RMSNorm launches per train step of ``n`` layers under
    "full", "ffn" or (the MoE layer) "dots" remat: every layer's attention
    and both its norms run twice, the final norm once; one backward each.
    "full" and "dots" replay a layer up to its last needed tensor; "ffn"
    replays the attention half from the layer's input, and the FFN half's
    backward recomputes its norm from the saved residual."""
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "rms_norm_fwd": 4 * n + 1, "rms_norm_bwd": 2 * n + 1}


def run_steps(step, params, opt_state, tokens, steps: int):
    """A warm-up step, then ``steps`` timed steps on one fixed batch, each
    ending in ``loss.item()``, with every kernel's launches per step:
    (params, opt_state, losses, step seconds, launches per step, the
    warm-up's seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, tokens)
    losses = [loss.item()]
    first_s = time.perf_counter() - t0
    step_s, per_step = [], []
    for _ in range(steps):
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(loss.item())          # waits for the step
        step_s.append(time.perf_counter() - t0)
        per_step.append(dict(_kernels.LAUNCHES))
    return params, opt_state, losses, step_s, per_step, first_s


class _CountOps(TorchDispatchMode):
    """Counts the calls of the given aten ops under it."""

    def __init__(self, ops):
        super().__init__()
        self.counts = dict.fromkeys(ops, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.counts:
            self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def layer_backward_mms(cfg, params, tokens) -> dict:
    """``aten::mm`` calls in the backward of the layers (the gradient of
    ``forward_hidden``, no vocab projection): per layer, the 2 x 7
    projections' gradient GEMMs plus what the remat policy reruns."""
    leaves = list(training.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    x = forward_hidden(params, tokens[:, :-1], cfg)
    mm = torch.ops.aten.mm.default
    with _CountOps((mm,)) as counter:
        torch.autograd.grad(x, leaves, torch.ones_like(x), allow_unused=True)
    per_layer = counter.counts[mm] / cfg.layers
    return {"backward_mm": counter.counts[mm], "per_layer": per_layer,
            "rerun_per_layer": per_layer - 2 * 7}


def train_cfg(**kw) -> LlamaConfig:
    """The training cell: llama3-1b with full remat and chunked xent."""
    return dataclasses.replace(LlamaConfig.llama3_1b(), **{
        "remat": True, "remat_policy": "full", "xent_chunk": TRAIN_CHUNK,
        **kw})


def phase_train() -> dict:
    cfg = train_cfg()
    n = cfg.layers
    step, init_all, _ = make_train_step(cfg, device="cuda")
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_all(gen)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           device="cuda", generator=gen)
    params, opt_state, losses, step_s, per_step, first_s = run_steps(
        step, params, opt_state, tokens, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()

    want = {**remat_launches(n), "adam8_fused": 0}
    check(all(p == want for p in per_step),
          f"train-step launches {per_step}, expected {want} per step")
    check(all(math.isfinite(v) for v in losses), f"train losses {losses}")
    check(losses[-1] < losses[0],
          f"the loss did not fall on the fixed batch: {losses}")
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_s)
    emit({"phase": "train", "preset": "llama3-1b", "layers": n,
          "params": cfg.num_params(), "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "xent_chunk": cfg.xent_chunk,
          "remat_policy": cfg.remat_policy, "optimizer": "adamw(3e-4, 0.1)",
          "first_step_s": first_s, "step_s": step_s, "median_step_s": med,
          "tokens_per_s": tokens_per_step / med, "losses": losses,
          "launches_per_step": per_step[-1],
          "peak_mem_gib": peak / 2**30})

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    emit({"phase": "profile_train", **profile_steps(run, 1)})
    del params, opt_state, step, init_all
    torch.cuda.empty_cache()
    return per_step[-1]


def phase_train_card_vs_cpu():
    # llama3-1b widths, 2 layers, batch 1 x 256, xent in chunks of 128
    cfg = train_cfg(layers=2, xent_chunk=128)
    params_gpu = init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED + 6), "cuda")
    params_cpu = params_to(params_gpu, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 257),
                           generator=torch.Generator().manual_seed(SEED + 7))
    out = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        leaves = [t.requires_grad_() for t in training.tree_leaves(params)]
        loss = loss_fn(params, tokens.to(dev), cfg)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (loss.item(), [g.float().cpu() for g in grads])
    names = list(_leaf_names(params_cpu))
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {name: rel_norm(g, r) for name, g, r in
                zip(names, out["cuda"][1], out["cpu"][1])}
    emit({"phase": "train_card_vs_cpu", "layers": cfg.layers, "batch": 1,
          "seq": 256, "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
          "loss_rel": loss_rel, "grad_rel_norm": grad_rel,
          "tol": {"loss_rel": TRAIN_LOSS_REL,
                  "grad_rel_norm": TRAIN_GRAD_REL}})
    check(loss_rel < TRAIN_LOSS_REL, f"train card vs CPU loss: {loss_rel}")
    worst = max(grad_rel, key=grad_rel.get)
    check(grad_rel[worst] < TRAIN_GRAD_REL,
          f"train card vs CPU gradient of {worst}: {grad_rel[worst]}")


# -- 8-bit AdamW ---------------------------------------------------------------


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's raw bits as an integer tensor, for equality that sees every bit."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def e4m3_limit_grad() -> float:
    """A bf16 gradient whose first-step v = (1 - b2) g^2, divided by its own
    block scale v / 448, lands above 448 in f32: the e4m3 conversion must
    saturate it to the format's limit, not overflow."""
    g = torch.arange(0x3F00, 0x4000, dtype=torch.int32).to(torch.int16)
    g = g.view(torch.bfloat16).float()
    v = g * optim8bit.adamw8bit().consts(1).omb2 * g
    return g[(v / (v / torch.tensor(448.0))) > 448][0].item()


def adam8_dtype(case: str) -> torch.dtype:
    """A case's leaf dtype: "f32" leaves (the MoE router) are float32,
    every other case bfloat16."""
    return torch.float32 if case == "f32" else torch.bfloat16


def adam8_grad(shape, case: str, gen) -> torch.Tensor:
    g = torch.randn(shape, device="cuda", generator=gen) * 1e-2
    if case == "zero_block":
        g.view(-1, g.shape[-1])[0, :256] = 0.0
    elif case == "e4m3_limit":
        g.view(-1, 256).mul_(0.1)[:, 0] = e4m3_limit_grad()
    return g.to(adam8_dtype(case))


def adam8_bytes(p: torch.Tensor) -> int:
    """Bytes the 8-bit AdamW update must move for leaf p: p, g and both
    codes read, p (written in place) and both codes written, both f32 block
    scales read and written."""
    last = p.shape[-1] if p.dim() else 1
    nb = p.numel() // optim8bit._leaf_block(last, optim8bit.BLOCK)
    return p.numel() * (3 * p.element_size() + 4) + nb * 16


ADAM8_OPS = 30   # f32 operations per value (dequantize, step, update, requantize)
A8_NAMES = ("param", "m_codes", "m_scales", "v_codes", "v_scales")
# the llama3-1b leaves' shapes, in tree order
A8_LLAMA_SHAPES = [(128256, 2048), (16, 2048, 2048), (16, 2048, 512),
                   (16, 2048, 512), (16, 2048, 2048), (16, 2048, 8192),
                   (16, 2048, 8192), (16, 8192, 2048), (16, 2048),
                   (16, 2048), (2048,), (2048, 128256)]


def _a8_leaf(p: torch.Tensor):
    st = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD).init({"p": p})
    return p, st["m"]["p"], st["v"]["p"]


def _a8_out(leaf) -> tuple:
    p, m, v = leaf
    return (p, m.q, m.scale, v.q, v.scale)


def _a8_mismatches(out, ref) -> dict:
    return {n: int((bits(a) != bits(b)).sum()) for n, a, b in
            zip(A8_NAMES, out, ref)}


def _a8_within_tol(out, ref, before) -> bool:
    """A8_TOL for one bf16 leaf: p's step within the update tolerance of
    the plain version's step (plus one bf16 rounding of p), the int8 codes
    equal, the scales and the v codes within their tolerances."""
    p, mq, ms, vq, vs = out
    rp, rmq, rms, rvq, rvs = ref
    step, rstep = p.float() - before.float(), rp.float() - before.float()
    room = (A8_TOL["update_atol"] + A8_TOL["update_rtol"] * rstep.abs()
            + 2.0 ** -8 * before.float().abs())
    return (bool(torch.all((step - rstep).abs() <= room))
            and torch.equal(mq, rmq)
            and torch.allclose(ms, rms, rtol=A8_TOL["scale_rtol"], atol=0)
            and torch.allclose(vs, rvs, rtol=A8_TOL["scale_rtol"], atol=0)
            and torch.allclose(vq.float(), rvq.float(),
                               rtol=A8_TOL["v_code_rtol"], atol=0))


def adam8_tree_case(spec, gen) -> dict:
    """One tree of bf16 leaves (``spec``: (shape, gradient case) each)
    stepped three times with carried state by adam8_fused (twice: the run
    and its repeat) and by adam8_plain; after every step each leaf's p,
    codes and scales are compared, bit for bit."""
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    p0 = [(torch.randn(shape, device="cuda", generator=gen) * 0.1).to(
        adam8_dtype(case)) for shape, case in spec]
    runs = {name: [_a8_leaf(p.clone()) for p in p0]
            for name in ("kernel", "repeat", "plain")}
    del p0
    steps, ok, launches = [], True, []
    for i in (1, 2, 3):
        grads = [adam8_grad(shape, case, gen) for shape, case in spec]
        before = [p.clone() for p, _, _ in runs["plain"]]
        for name, leaves in runs.items():
            call = [(p, g, m, v) for (p, m, v), g in zip(leaves, grads)]
            if name == "plain":
                optim8bit.adam8_plain(call, opt.consts(i))
            else:
                start = _kernels.LAUNCHES["adam8_fused"]
                optim8bit.adam8_fused(call, opt.consts(i))
                launches.append(_kernels.LAUNCHES["adam8_fused"] - start)
        torch.cuda.synchronize()
        mism = dict.fromkeys(A8_NAMES, 0)
        repeat = dict.fromkeys(A8_NAMES, 0)
        for j, (_, case) in enumerate(spec):
            out, ref = (_a8_out(runs[n][j]) for n in ("kernel", "plain"))
            this = _a8_mismatches(out, ref)
            again = _a8_mismatches(out, _a8_out(runs["repeat"][j]))
            for n in A8_NAMES:
                mism[n] += this[n]
                repeat[n] += again[n]
            ok = ok and not any(again.values()) and (
                not any(this.values())
                or _a8_within_tol(out, ref, before[j]))
            if case == "e4m3_limit" and i == 1:
                top = out[3].view(-1, 256)[:, 0].float()
                ok = ok and bool(torch.all(top == 448.0))
        steps.append({"step": i, "bit_identical": not any(mism.values()),
                      "mismatches": mism, "repeat_mismatches": repeat,
                      "max_abs_err_param": max(
                          max_err(a[0], b[0]) for a, b in
                          zip(runs["kernel"], runs["plain"]))})
        del grads, before
    for j, (_, case) in enumerate(spec):
        if case == "zero_block":
            _, m, v = runs["kernel"][j]
            ok = ok and m.scale.view(-1)[0].item() == 1.0 \
                and v.scale.view(-1)[0].item() == 1.0
    want = -(-sum(1 for shape, _ in spec if math.prod(shape))
             // optim8bit.TABLE_LEAVES)
    ok = ok and all(n == want for n in launches)
    return {"steps": steps, "launches_per_call": launches, "ok": ok}


def phase_kernels_adam8():
    """adam8_fused against its plain version on the card, three steps with
    carried state, and a second kernel run that must repeat its bits: each
    leaf shape alone, then one tree of the 12 llama3-1b leaves with the
    whole-row, zero-block and e4m3-limit leaves, in one launch; then the
    MoE leaf shapes (an f32 router of whole 8-value rows and a slice of
    the bf16 expert leaves), which must be the same bits."""
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    cases = [[((128256, 2048), "random")], [((16, 2048, 512), "random")],
             [((2048,), "random")], [((3, 77), "random")],
             [((8, 512), "zero_block")], [((16, 256), "e4m3_limit")],
             [*((s, "random") for s in A8_LLAMA_SHAPES),
              ((3, 77), "random"), ((8, 512), "zero_block"),
              ((16, 256), "e4m3_limit")]]
    moe_case = [((16, 2048, 8), "f32"), ((2, 8, 2048, 5632), "random")]
    for spec in [*cases, moe_case]:
        res = adam8_tree_case(spec, gen)
        emit({"phase": "kernels", "kernel": "adam8_fused",
              "leaves": [[list(shape), case] for shape, case in spec],
              **res, "tol_if_not_bit_identical": A8_TOL})
        check(res["ok"], f"adam8_fused disagrees with its plain version on "
                         f"{[shape for shape, _ in spec]}")
        check(spec is not moe_case
              or all(st["bit_identical"] for st in res["steps"]),
              "adam8_fused is not its plain version's bits on the MoE leaves")
        torch.cuda.empty_cache()


def adam8_cell():
    """The llama3-1b+ffn+adam8 cell's config, train step, initial
    parameters and optimizer state, and its fixed batch."""
    cfg = train_cfg(remat_policy="ffn", xent_chunk=A8_CHUNK)
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    step, init_all, _ = make_train_step(cfg, optimizer=opt, device="cuda")
    gen = torch.Generator("cuda").manual_seed(SEED + 9)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_all(gen)
    tokens = torch.randint(0, cfg.vocab_size, (A8_BATCH, A8_SEQ + 1),
                           device="cuda", generator=gen)
    return cfg, step, params, opt_state, tokens


def phase_train_adam8(name: str) -> dict:
    bw, _, _ = measure.peaks(name)
    cfg, step, params, opt_state, tokens = adam8_cell()
    n = cfg.layers
    leaves = list(training.tree_leaves(params))
    params, opt_state, losses, step_s, per_step, first_s = run_steps(
        step, params, opt_state, tokens, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()

    # the kernels run as under "full" remat; one update launch for every
    # TABLE_LEAVES leaves (1 at llama3-1b's 12)
    updates = -(-len(leaves) // optim8bit.TABLE_LEAVES)
    want = {**remat_launches(n), "adam8_fused": updates}
    check(all(p == want for p in per_step),
          f"adam8 train-step launches {per_step}, expected {want} per step")
    check(all(math.isfinite(v) for v in losses), f"adam8 losses {losses}")
    check(losses[-1] < losses[0],
          f"the adam8 loss did not fall on the fixed batch: {losses}")
    moments = optim8bit.moment_bytes(opt_state)
    bf16_moments = 2 * 2 * cfg.num_params()      # AdamW's m and v in bf16
    med = statistics.median(step_s)
    emit({"phase": "train_adam8", "preset": "llama3-1b", "layers": n,
          "params": cfg.num_params(), "batch": A8_BATCH, "seq": A8_SEQ,
          "xent_chunk": cfg.xent_chunk, "remat_policy": cfg.remat_policy,
          "optimizer": f"adamw8bit({A8_LR}, {A8_WD})",
          "first_step_s": first_s, "step_s": step_s, "median_step_s": med,
          "tokens_per_s": A8_BATCH * A8_SEQ / med, "losses": losses,
          "launches_per_step": per_step[-1],
          "peak_mem_gib": peak / 2**30, "moment_bytes": moments,
          "adamw_bf16_moment_bytes": bf16_moments,
          "moment_bytes_ratio": moments / bf16_moments})

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    prof = profile_steps(run, 1, follow="adam8")
    # the "ffn" save set: the layers' backward reruns 3 projections a layer
    # (wq, wk, wv), as XLA's save_only_these_names does
    mms = layer_backward_mms(cfg, params, tokens)
    check(mms["rerun_per_layer"] == 3,
          f"the ffn policy's layer backward reruns {mms} matmuls")
    adam = {"launches": updates,
            "device_ms": prof["ms_per_step_by_group"].get("adam8_fused"),
            "bound_ms": sum(adam8_bytes(p) for p in leaves) / bw * 1e3,
            "bound_by": "bytes"}
    busy, dev_ms = prof["device_busy_share"], prof["device_ms_per_step"]
    emit({"phase": "profile_train_adam8", **prof,
          "device_idle_share": None if busy is None else 1 - busy,
          # the profiler's own host cost is in its wall time: the same
          # device time over the unprofiled median step
          "device_idle_share_unprofiled": None if dev_ms is None
          else 1 - dev_ms / (med * 1e3),
          "adam8_fused_per_step": adam, "layer_backward_mm": mms})
    del params, opt_state, step, leaves
    torch.cuda.empty_cache()
    return {"launches_per_step": per_step[-1], "adam8_per_step": adam}


def adam8_leaf_times(name: str) -> dict:
    """The 8-bit AdamW update at the llama3-1b leaves through its entry
    point, ``AdamW8bit.apply``: each leaf as a one-leaf tree and all 12 as
    one tree, and ``p.add_`` of a same-shaped bf16 tensor on its own (the
    pass that applies an update not written into p); device ms by
    CUDA-graph replay beside each leaf's bound; and the embedding leaf
    with a gradient on one batch's rows only, as in the train step.  Uses
    only ``adamw8bit``, ``init`` and ``apply``, so it times any tree of the
    port."""
    bw, _, f32_peak = measure.peaks(name)
    cfg = LlamaConfig.llama3_1b()
    gen = torch.Generator("cuda").manual_seed(SEED + 13)
    params = init_params(cfg, gen, "cuda")
    leaves = list(training.tree_leaves(params))
    grads = [adam8_grad(p.shape, "random", gen) for p in leaves]
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    state = opt.init(params)
    opt.apply(params, grads, state)             # moments non-zero
    rows = []
    for leaf, p, g, m, v in zip(_leaf_names(params), leaves, grads,
                                training.tree_leaves(state["m"]),
                                training.tree_leaves(state["v"])):
        one = {"count": state["count"], "m": {"p": m}, "v": {"p": v}}
        spare = p.clone()
        rows.append({
            "leaf": leaf, "shape": list(p.shape),
            **_bound(adam8_bytes(p), ADAM8_OPS * p.numel(), bw, f32_peak),
            "apply_ms": time_ms(lambda: opt.apply({"p": p}, [g], one)),
            "add_ms": time_ms(lambda: spare.add_(g)),
        })
        del spare
    _kernels.reset_launches()
    opt.apply(params, grads, state)
    launches = _kernels.LAUNCHES["adam8_fused"]
    whole = time_ms(lambda: opt.apply(params, grads, state))
    # the embedding as the train step sees it: a gradient only on the rows
    # of one batch's tokens, so the other rows' moments stay exactly zero
    p = leaves[0]
    g = torch.zeros_like(p)
    ids = torch.randint(0, p.shape[0], (A8_BATCH * A8_SEQ,), device="cuda",
                        generator=gen)
    g[ids] = grads[0][ids]
    one = opt.init({"p": p})
    opt.apply({"p": p}, [g], one)
    batch_rows = {"rows_with_gradient": int(ids.unique().numel()),
                  "apply_ms": time_ms(lambda: opt.apply({"p": p}, [g], one))}
    del params, leaves, grads, state, p, g, one
    torch.cuda.empty_cache()
    return {"leaves": rows,
            "sum_apply_ms": sum(r["apply_ms"] for r in rows),
            "sum_add_ms": sum(r["add_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "whole_tree_apply_ms": whole, "whole_tree_launches": launches,
            "embed_batch_rows": batch_rows}


def phase_adam8_leaves(name: str) -> None:
    """:func:`adam8_leaf_times`, then the adam8 cell's train step,
    profiled: every update launch in it and the kernel that ran after it."""
    emit({"phase": "adam8_leaves", **adam8_leaf_times(name)})
    _, step, params, opt_state, tokens = adam8_cell()
    params, opt_state, _ = step(params, opt_state, tokens)    # warm-up

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    prof = profile_steps(run, 1, follow="adam8")
    events = prof["launches_of_adam8"]
    emit({"phase": "adam8_in_step", "launches": events,
          "sum_ms": sum(e["ms"] for e in events),
          "sum_next_add_ms": sum(e["next_ms"] for e in events
                                 if e["next"] and "add" in e["next"]),
          "ms_per_step_by_group": prof["ms_per_step_by_group"],
          "device_ms_per_step": prof["device_ms_per_step"]})
    del params, opt_state, step
    torch.cuda.empty_cache()


def phase_remat_ffn() -> None:
    """The llama3-1b+ffn+adam8 cell's step, profiled over 3 steps after a
    warm-up (device ms per step by group), and the aten::mm calls of its
    layers' backward per layer.  Uses only ``make_train_step``,
    ``loss_fn`` and ``forward_hidden``, so it measures an older tree too
    (unpack it with ``git archive`` into ``.chip_smoke_tmp/`` and copy
    this script in)."""
    cfg, step, params, opt_state, tokens = adam8_cell()
    params, opt_state, _ = step(params, opt_state, tokens)    # warm-up

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    prof = profile_steps(run, 3)
    emit({"phase": "remat_ffn", "remat_policy": cfg.remat_policy,
          "layer_backward_mm": layer_backward_mms(cfg, params, tokens),
          "device_ms_per_step": prof["device_ms_per_step"],
          "step_ms": prof["step_ms"],
          "ms_per_step_by_group": prof["ms_per_step_by_group"]})
    del params, opt_state, step
    torch.cuda.empty_cache()


# -- the MoE train path -------------------------------------------------------


def moe_gemm_group(cfg, seq: int):
    """The MoE step's GEMM groups by operand shapes (:func:`gemm_groups`):
    a product with the expert FFN width is an expert GEMM, one with the
    experts x capacity width a dispatch or combine einsum, an ``aten::mm``
    with the expert count the router; the rest are attention and vocab
    products.  At ``MoEConfig.small`` the widths 5632, 5120 and 8 occur in
    no other product."""
    f, ec, e = cfg.ffn, cfg.experts * cfg.capacity(seq), cfg.experts

    def group(shapes):
        dims = {d for shape in shapes for d in shape}
        if f in dims:
            return "moe expert GEMMs"
        if ec in dims:
            return "moe dispatch/combine einsums"
        if e in dims:
            return "moe router"
        return "attention/vocab GEMMs"

    return group


def moe_cell(optimizer=None):
    """The MoE cell's config, train step, initial parameters and optimizer
    state, and its fixed batch."""
    from tpu_network_operator_torch.models import moe

    cfg = moe.MoEConfig.small()
    step, init_all, opt = moe.make_train_step(cfg, optimizer=optimizer,
                                              device="cuda")
    gen = torch.Generator("cuda").manual_seed(SEED + 14)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_all(gen)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1),
                           device="cuda", generator=gen)
    return cfg, step, opt, params, opt_state, tokens


def phase_train_moe(name: str) -> dict:
    """MoEConfig.small at full width and depth, batch 4 x 2048, AdamW:
    timed steps with kernels 1 to 5's launches read per step and the loss
    required to fall, then one profiled step; then a short adamw8bit run
    of the same model, kernel 6 updating the MoE tree in each step."""
    bw, _, _ = measure.peaks(name)
    cfg, step, opt, params, opt_state, tokens = moe_cell()
    n = cfg.layers
    params, opt_state, losses, step_s, per_step, first_s = run_steps(
        step, params, opt_state, tokens, MOE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    want = {**remat_launches(n), "adam8_fused": 0}
    check(all(p == want for p in per_step),
          f"MoE train-step launches {per_step}, expected {want} per step")
    check(all(math.isfinite(v) for v in losses), f"MoE losses {losses}")
    check(losses[-1] < losses[0],
          f"the MoE loss did not fall on the fixed batch: {losses}")
    med = statistics.median(step_s)
    emit({"phase": "train_moe", "preset": "moe:small", "layers": n,
          "params": cfg.num_params(), "batch": MOE_BATCH, "seq": MOE_SEQ,
          "head_dim": cfg.head_dim, "experts": cfg.experts,
          "capacity": cfg.capacity(MOE_SEQ), "xent_chunk": cfg.xent_chunk,
          "remat_policy": cfg.remat_policy, "optimizer": "adamw(3e-4, 0.1)",
          "first_step_s": first_s, "step_s": step_s, "median_step_s": med,
          "tokens_per_s": MOE_BATCH * MOE_SEQ / med, "losses": losses,
          "launches_per_step": per_step[-1],
          "max_memory_allocated_gib": peak / 2**30})

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    # AdamW's device time: its aten ops' kernels inside a range (a range
    # does not see a kernel launched through ctypes, as adam8_fused is)
    apply = opt.apply

    def apply_in_range(*args):
        with torch.profiler.record_function("optimizer"):
            return apply(*args)

    opt.apply = apply_in_range
    prof = profile_steps(run, 1, op_group=moe_gemm_group(cfg, MOE_SEQ),
                         ranges=("optimizer",))
    busy, dev_ms = prof["device_busy_share"], prof["device_ms_per_step"]
    emit({"phase": "profile_train_moe", **prof,
          "device_idle_share": None if busy is None else 1 - busy,
          "device_idle_share_unprofiled": None if dev_ms is None
          else 1 - dev_ms / (med * 1e3)})
    del params, opt_state, step
    torch.cuda.empty_cache()

    cfg, step, _, params, opt_state, tokens = moe_cell(
        optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD))
    leaves = list(training.tree_leaves(params))
    params, opt_state, a8_losses, a8_s, a8_steps, a8_first = run_steps(
        step, params, opt_state, tokens, MOE_A8_STEPS)
    a8_peak = torch.cuda.max_memory_allocated()
    updates = -(-len(leaves) // optim8bit.TABLE_LEAVES)
    want8 = {**remat_launches(n), "adam8_fused": updates}
    check(all(p == want8 for p in a8_steps),
          f"MoE adam8 launches {a8_steps}, expected {want8} per step")
    check(all(math.isfinite(v) for v in a8_losses),
          f"MoE adam8 losses {a8_losses}")
    check(a8_losses[-1] < a8_losses[0],
          f"the MoE adam8 loss did not fall: {a8_losses}")

    def run8():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, tokens)

    prof8 = profile_steps(run8, 1, follow="adam8")
    update_bound_ms = sum(adam8_bytes(p) for p in leaves) / bw * 1e3
    emit({"phase": "train_moe_adam8", "preset": "moe:small", "layers": n,
          "leaves": [[list(p.shape), str(p.dtype)] for p in leaves],
          "optimizer": f"adamw8bit({A8_LR}, {A8_WD})",
          "first_step_s": a8_first, "step_s": a8_s,
          "median_step_s": statistics.median(a8_s), "losses": a8_losses,
          "launches_per_step": a8_steps[-1],
          "max_memory_allocated_gib": a8_peak / 2**30,
          "moment_bytes": optim8bit.moment_bytes(opt_state),
          "update_in_step_ms": prof8["ms_per_step_by_group"].get(
              "adam8_fused"),
          "update_bound_ms": update_bound_ms,
          "device_ms_per_step": prof8["device_ms_per_step"],
          "ms_per_step_by_group": prof8["ms_per_step_by_group"]})
    del params, opt_state, step, leaves
    torch.cuda.empty_cache()
    return {"launches_per_step": per_step[-1],
            "adam8_launches_per_step": a8_steps[-1],
            "adam8_in_step_ms": prof8["ms_per_step_by_group"].get(
                "adam8_fused"),
            "adam8_bound_ms": update_bound_ms,
            "attention": (MOE_BATCH, MOE_SEQ, cfg.heads, cfg.kv_heads,
                          cfg.head_dim)}


def phase_train_moe_card_vs_cpu():
    """One loss and gradient at MoEConfig.small widths with 2 layers,
    batch 1 x 256, from the same weights on the card and on the CPU, and
    the share of (token, slot) routing choices the two make alike.  A
    routing choice flips between the devices where a token's k-th and
    (k+1)-th experts are nearly tied, and a flipped token's gradient is a
    different expert's, about 1/16 of the norm at 256 tokens: so every
    flip must sit at such a tie, the loss is held to TRAIN_LOSS_REL, and
    the gradients to TRAIN_GRAD_REL in a second card run that takes the
    CPU's expert choices (the same numerics, the same routing)."""
    from tpu_network_operator_torch.models import moe

    cfg = dataclasses.replace(moe.MoEConfig.small(), layers=2, remat=False)
    params_gpu = moe.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED + 15), "cuda")
    params_cpu = params_to(params_gpu, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 257),
                           generator=torch.Generator().manual_seed(SEED + 16))
    real_top_k = moe.top_k_experts

    def run(params, pinned=None):
        """(loss, gradients, [(probs, expert choices)] per layer), the
        choices taken from ``pinned`` when given."""
        seen = []

        def top_k(probs, k):
            idx = real_top_k(probs, k) if pinned is None \
                else pinned[len(seen)].to(probs.device)
            seen.append((probs.float().cpu(), idx.cpu()))
            return idx

        moe.top_k_experts = top_k
        try:
            leaves = [t.requires_grad_() for t in
                      training.tree_leaves(params)]
            dev = leaves[0].device
            loss = moe.loss_fn(params, tokens.to(dev), cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            moe.top_k_experts = real_top_k
        return loss.item(), [g.float().cpu() for g in grads], seen

    cpu = run(params_cpu)
    card = run(params_gpu)
    pinned = run(params_gpu, [idx for _, idx in cpu[2]])
    k = cfg.experts_per_token
    agree, total, near_ties = 0, 0, True
    for (p_cpu, i_cpu), (p_card, i_card) in zip(cpu[2], card[2]):
        same = i_cpu == i_card
        agree += int(same.sum())
        total += same.numel()
        # a flip is explained when the CPU's probabilities of two adjacent
        # ranks among the first k + 1 lie closer than twice the largest
        # card-vs-CPU probability difference of the layer
        desc = p_cpu.sort(-1, descending=True).values[..., :k + 1]
        gap = (desc[..., :-1] - desc[..., 1:]).min(-1).values
        dev = (p_card - p_cpu).abs().max()
        near_ties &= bool(torch.all(gap[~same.all(-1)] < 2 * dev))
    names = list(_leaf_names(params_cpu))

    def compare(res):
        loss_rel = abs(res[0] - cpu[0]) / abs(cpu[0])
        return loss_rel, {name: rel_norm(g, r) for name, g, r in
                          zip(names, res[1], cpu[1])}

    loss_rel, grad_rel = compare(card)
    pinned_loss_rel, pinned_grad_rel = compare(pinned)
    emit({"phase": "train_moe_card_vs_cpu", "layers": cfg.layers,
          "batch": 1, "seq": 256, "remat": cfg.remat,
          "loss_cuda": card[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
          "routing_agreement": agree / total, "routing_choices": total,
          "flips_at_near_ties": near_ties,
          "grad_rel_norm_own_routing": grad_rel,
          "pinned_routing": {"loss_cuda": pinned[0],
                             "loss_rel": pinned_loss_rel,
                             "grad_rel_norm": pinned_grad_rel},
          "tol": {"loss_rel": TRAIN_LOSS_REL,
                  "grad_rel_norm": TRAIN_GRAD_REL}})
    check(loss_rel < TRAIN_LOSS_REL, f"MoE card vs CPU loss: {loss_rel}")
    check(near_ties, "MoE card vs CPU: a routing choice flipped away from "
                     "a near-tie")
    check(pinned_loss_rel < TRAIN_LOSS_REL,
          f"MoE card vs CPU loss, pinned routing: {pinned_loss_rel}")
    worst = max(pinned_grad_rel, key=pinned_grad_rel.get)
    check(pinned_grad_rel[worst] < TRAIN_GRAD_REL,
          f"MoE card vs CPU gradient of {worst}, pinned routing: "
          f"{pinned_grad_rel[worst]}")
    del params_gpu
    torch.cuda.empty_cache()


def phase_checkpoint():
    """Save at step 2, restore into a fresh init, resume step 3."""
    cfg = train_cfg(layers=CKPT_LAYERS, remat_policy="ffn",
                    xent_chunk=A8_CHUNK)
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    step, init_all, _ = make_train_step(cfg, optimizer=opt, device="cuda")
    SCRATCH.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        path = tmp / "tokens.bin"
        np.random.default_rng(SEED + 10).integers(
            0, cfg.vocab_size, 1 << 22, dtype=np.uint32).tofile(path)
        source = data.MemmapTokens(str(path), vocab_size=cfg.vocab_size)
        dcfg = data.DataConfig(batch=CKPT_BATCH, seq_len=CKPT_SEQ, seed=SEED)
        batches = data.device_batches(source, dcfg, "cuda")
        params, opt_state = init_all(
            torch.Generator("cuda").manual_seed(SEED + 11))
        losses = []
        with TrainCheckpointer(tmp / "ckpt") as ckpt:
            for _ in range(2):
                params, opt_state, loss = step(params, opt_state,
                                               next(batches))
                losses.append(loss.item())
            t0 = time.perf_counter()
            ckpt.save(2, params, opt_state)
            save_s = time.perf_counter() - t0
            saved = {k: t.to("cpu", copy=True)
                     for k, t in flat_state(params, opt_state).items()}
            params, opt_state, loss = step(params, opt_state, next(batches))
            loss_3 = loss.item()
            after = {k: t.to("cpu", copy=True) for k, t in
                     flat_state(params, {}).items()}
            del params, opt_state
            t0 = time.perf_counter()
            ckpt.wait()
            write_s = time.perf_counter() - t0
            fresh = init_all(torch.Generator("cuda").manual_seed(SEED + 12))
            t0 = time.perf_counter()
            at, params, opt_state = ckpt.restore(fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        restored = flat_state(params, opt_state)
        differ = {k: int((bits(restored[k].cpu()) != bits(t)).sum())
                  for k, t in saved.items()}
        resumed = data.device_batches(source, dcfg, "cuda", start_step=at)
        params, opt_state, loss = step(params, opt_state, next(resumed))
        loss_resumed = loss.item()
        worst, same = {}, 0
        for k, t in flat_state(params, {}).items():
            ref = after[k].float()
            err = (t.float().cpu() - ref).abs()
            worst[k] = err.max().item()
            same += int(torch.equal(bits(t.cpu()), bits(after[k])))
            check(bool(torch.all(err <= CKPT_PARAM_ATOL
                                 + 2.0 ** -8 * ref.abs())),
                  f"resumed step's {k} off by {worst[k]}")
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "ckpt").rglob("*")
                         if f.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "checkpoint", "layers": cfg.layers,
          "batch": CKPT_BATCH, "seq": CKPT_SEQ, "losses": losses + [loss_3],
          "resumed_from": at, "count": opt_state["count"],
          "round_trip_mismatched_values": sum(differ.values()),
          "loss_uninterrupted": loss_3, "loss_resumed": loss_resumed,
          "params_bit_identical_after_resume": f"{same} of {len(after)}",
          "params_max_abs_diff_after_resume": worst,
          "tol": {"atol": CKPT_PARAM_ATOL, "rtol_bf16_ulp": 2.0 ** -8},
          "checkpoint_bytes": ckpt_bytes, "save_returns_s": save_s,
          "write_wait_s": write_s, "restore_s": restore_s})
    check(at == 2 and opt_state["count"] == 3, "resumed at the wrong step")
    check(not any(differ.values()),
          f"checkpoint round trip changed {differ}")
    check(loss_resumed == loss_3,
          f"resumed loss {loss_resumed} != uninterrupted {loss_3}")
    del params, opt_state, fresh, step, init_all
    torch.cuda.empty_cache()


# -- HF import, convert -> train, and the ffn_offload policy -----------------


def kernel_launches_of(run) -> tuple:
    """``run()``'s result and the kernel launches it made (the counts set
    to 0 just before it and read just after it)."""
    _kernels.reset_launches()
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    return out, dict(_kernels.LAUNCHES)


def hf_tensors(params, family: str, tied: bool) -> dict:
    """HF state-dict names -> tensors ([out, in] views of the port's
    [in, out] leaves) of a port parameter tree, in the order a checkpoint
    lists them: the inverse of ``convert.from_hf_llama`` /
    ``from_hf_mixtral``."""
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"]}
    proj = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk",
            "self_attn.v_proj": "wv", "self_attn.o_proj": "wo"}
    if family == "llama":
        proj.update({"mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
                     "mlp.down_proj": "w_down"})
    for i in range(lay["wq"].shape[0]):
        pre = f"model.layers.{i}."
        for hf_name, leaf in proj.items():
            out[f"{pre}{hf_name}.weight"] = lay[leaf][i].t()
        if family == "mixtral":
            out[f"{pre}block_sparse_moe.gate.weight"] = \
                lay["router"][i].t().bfloat16()
            for e in range(lay["w_gate"].shape[1]):
                for w, leaf in (("w1", "w_gate"), ("w3", "w_up"),
                                ("w2", "w_down")):
                    out[f"{pre}block_sparse_moe.experts.{e}.{w}.weight"] = \
                        lay[leaf][i, e].t()
        out[f"{pre}input_layernorm.weight"] = lay["ln_attn"][i]
        out[f"{pre}post_attention_layernorm.weight"] = lay["ln_mlp"][i]
    out["model.norm.weight"] = params["ln_final"]
    if not tied:
        out["lm_head.weight"] = params["lm_head"].t()
    return out


def write_safetensors(path: Path, tensors: dict) -> int:
    """One ``.safetensors`` file, written by hand from the format: an
    8-byte little-endian header length, the JSON header (dtype, shape and
    byte range of each tensor), then the tensors' bytes.  Returns the
    bytes written."""
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(h) + off


def write_hf_checkpoint(directory: Path, config: dict, tensors: dict,
                        shards: int) -> int:
    """An HF checkpoint directory: ``config.json``, the tensors in
    ``shards`` safetensors files (split in order) and the index that maps
    each name to its file.  Returns the bytes of the shards."""
    directory.mkdir(parents=True)
    (directory / "config.json").write_text(json.dumps(config, indent=2))
    names = list(tensors)
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = names[s * per:(s + 1) * per]
        total += write_safetensors(directory / fname,
                                   {n: tensors[n] for n in part})
        weight_map.update(dict.fromkeys(part, fname))
    (directory / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def random_norm_scales(params, gen) -> None:
    """Norm scales 1 + 0.1 N(0, 1) in place of init's ones, so the import
    check sees distinct values in every leaf."""
    def draw(t):
        return (1 + 0.1 * torch.randn(t.shape, device="cuda",
                                      generator=gen)).to(t.dtype)

    for k in ("ln_attn", "ln_mlp"):
        params["layers"][k] = draw(params["layers"][k])
    params["ln_final"] = draw(params["ln_final"])


def source_params(cfg_json: dict, seed: int):
    """(config, parameters) of an HF config.json with seeded random bf16
    weights on the card, in the port's layout: the tensors an HF
    checkpoint is then written from.  A tied config's head is the
    embedding's transpose; the Mixtral router holds bf16 values, as
    Mixtral checkpoints store it."""
    from tpu_network_operator_torch.models import moe

    hf = convert.hf_config(cfg_json)
    gen = torch.Generator("cuda").manual_seed(seed)
    if hf.model_type == "llama":
        cfg = convert.cfg_from_hf(hf)
        params = init_params(cfg, gen, "cuda")
    else:
        cfg = convert.moe_cfg_from_hf(hf)
        params = moe.init_params(cfg, gen, "cuda")
        params["layers"]["router"] = \
            params["layers"]["router"].bfloat16().float()
    random_norm_scales(params, gen)
    if hf.tie_word_embeddings:
        params["lm_head"] = params["embed"].t().contiguous()
    return cfg, params


def leaves_equal(params, ref) -> dict:
    """Per leaf name, whether ``params`` holds ``ref``'s shape, dtype and
    bits."""
    return {name: a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(bits(a), bits(b)))
            for name, a, b in zip(_leaf_names(ref),
                                  training.tree_leaves(params),
                                  training.tree_leaves(ref))}


def phase_import_llama() -> dict:
    """Llama-3.2-1B's published config at full width and depth, seeded
    random bf16 weights written as a 2-shard HF checkpoint, imported onto
    the card: every leaf the source's bits, the tied head a tensor of its
    own; greedy generate from the import and from the source gives the
    same tokens; 2 adamw8bit steps train the import."""
    t_phase = time.perf_counter()
    cfg, src = source_params(LLAMA32_1B_CONFIG, SEED + 20)
    n = cfg.layers
    SCRATCH.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(
            tmp / "hf", LLAMA32_1B_CONFIG, hf_tensors(src, "llama", True), 2)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, icfg = convert.load_hf_checkpoint(str(tmp / "hf"),
                                                   device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = leaves_equal(params, src)
    check(icfg == cfg and icfg.rope_scaling_dict["factor"] == 32.0,
          f"imported config {icfg}")
    check(all(same.values()), f"imported leaves differ from the source: "
          f"{[k for k, v in same.items() if not v]}")
    shared = params["lm_head"].untyped_storage().data_ptr() == \
        params["embed"].untyped_storage().data_ptr()
    check(not shared, "the tied lm_head shares storage with embed")

    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               SEED + 21))
    ref = generate(src, prompt, cfg, NEW_TOKENS)
    del src
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, launches = kernel_launches_of(
        lambda: generate(params, prompt, icfg, NEW_TOKENS))
    gen_s = time.perf_counter() - t0
    want = {"flash_fwd": n, "rms_norm_fwd": (2 * n + 1) * NEW_TOKENS,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "rms_norm_bwd": 0,
            "adam8_fused": 0}
    check(launches == want, f"import generate launches {launches}, "
          f"expected {want}")
    check(bool(torch.equal(out, ref)),
          "generate from the import differs from generate from the source")

    tcfg = dataclasses.replace(icfg, remat=True, remat_policy="ffn",
                               xent_chunk=A8_CHUNK)
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    step, _, _ = make_train_step(tcfg, optimizer=opt, device="cuda")
    opt_state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (A8_BATCH, A8_SEQ + 1),
                           device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               SEED + 22))

    def train2():
        nonlocal params, opt_state
        losses = []
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, tokens)
            losses.append(loss.item())
        return losses

    losses, train_launches = kernel_launches_of(train2)
    want = {k: 2 * v for k, v in remat_launches(n).items()}
    want["adam8_fused"] = 2
    check(train_launches == want, f"import train launches {train_launches}, "
          f"expected {want}")
    check(all(math.isfinite(v) for v in losses) and losses[1] < losses[0],
          f"the imported model's loss did not fall: {losses}")
    untied = not torch.equal(params["lm_head"], params["embed"].t())
    check(untied, "lm_head still equals embed.T after 2 steps")
    emit({"phase": "import_llama",
          "seconds": time.perf_counter() - t_phase,
          "config": "meta-llama/Llama-3.2-1B "
          "config.json (tied embeddings, llama3 rope scaling, factor 32)",
          "layers": n, "params": cfg.num_params() - cfg.vocab_size
          * cfg.hidden, "checkpoint_bytes": nbytes, "shards": 2,
          "write_s": write_s, "load_s": load_s,
          "load_gb_per_s": nbytes / load_s / 1e9,
          "leaves_bit_identical": f"{sum(same.values())} of {len(same)}",
          "lm_head_shares_embed_storage": shared,
          "generate": {"batch": BATCH, "prompt": PROMPT,
                       "new_tokens": NEW_TOKENS, "seconds": gen_s,
                       "tokens_per_s": BATCH * NEW_TOKENS / gen_s,
                       "same_tokens_as_source": True, "launches": launches},
          "train": {"batch": A8_BATCH, "seq": A8_SEQ,
                    "xent_chunk": A8_CHUNK, "remat_policy": "ffn",
                    "optimizer": f"adamw8bit({A8_LR}, {A8_WD})",
                    "losses": losses, "launches": train_launches,
                    "lm_head_differs_from_embed_t": untied}})
    del params, opt_state, step, out, ref
    torch.cuda.empty_cache()
    return {"generate": launches, "train": train_launches}


def run_cli(argv) -> dict:
    """The workload CLI's ``main`` in this process; its JSON line."""
    from tpu_network_operator_torch.workload import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"workload {argv[0]} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_convert_train(family: str) -> dict:
    """``workload convert --optimizer adam8bit`` of a 2-layer HF checkpoint
    at full width (Llama-3.2-1B's config, or MoEConfig.small's widths as
    a Mixtral config), then ``workload train --checkpoint-dir`` with no
    ``--model``: it resumes at step 0 as the sidecar's family, its first
    loss is ``loss_fn`` of the imported weights on its first batch, and
    the loss falls."""
    from tpu_network_operator_torch.models import moe

    base = LLAMA32_1B_CONFIG if family == "llama" else MIXTRAL_SMALL_CONFIG
    t_phase = time.perf_counter()
    cfg_json = {**base, "num_hidden_layers": CONVERT_LAYERS}
    cfg, src = source_params(cfg_json, SEED + 23)
    want_family = "llama" if family == "llama" else "moe"
    SCRATCH.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        write_hf_checkpoint(tmp / "hf", cfg_json,
                            hf_tensors(src, family,
                                       cfg_json["tie_word_embeddings"]), 2)
        del src
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        conv = run_cli(["convert", "--hf-path", str(tmp / "hf"),
                        "--checkpoint-dir", str(tmp / "ckpt"),
                        "--optimizer", "adam8bit", "--device", "cuda"])
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, launches = kernel_launches_of(lambda: run_cli(
            ["train", "--checkpoint-dir", str(tmp / "ckpt"),
             "--steps", str(CONVERT_STEPS), "--batch", str(A8_BATCH),
             "--seq-len", str(A8_SEQ), "--optimizer", "adam8bit",
             "--device", "cuda"]))
        train_s = time.perf_counter() - t0
        # the imported weights' loss on train's first batch (its fixed
        # synthetic batch, drawn as train draws it), computed as the train
        # step computes it: grad mode, the sidecar's remat policy
        params, icfg = convert.load_hf_checkpoint(str(tmp / "hf"),
                                                   device="cuda")
        tokens = torch.randint(0, icfg.vocab_size, (A8_BATCH, A8_SEQ + 1),
                               device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   1))
        for p in training.tree_leaves(params):
            p.requires_grad_(True)
        lossf = loss_fn if family == "llama" else moe.loss_fn
        ref_loss = lossf(params, tokens, icfg).item()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(conv["family"] == want_family,
          f"convert says family {conv['family']}")
    check(out["resumed_from"] == 0, f"train resumed from {out}")
    check(out["metric"].startswith(want_family + ":"),
          f"train ran {out['metric']}, not the sidecar's {want_family}")
    check(out["first_loss"] == ref_loss,
          f"train's first loss {out['first_loss']} != the imported "
          f"weights' loss {ref_loss}")
    check(math.isfinite(out["final_loss"])
          and out["final_loss"] < out["first_loss"],
          f"the loss did not fall: {out}")
    check(all(launches[k] > 0 for k in launches),
          f"convert -> train launched no {launches}")
    emit({"phase": f"convert_train_{family}",
          "seconds": time.perf_counter() - t_phase, "layers": icfg.layers,
          "params": icfg.num_params(), "convert": conv,
          "convert_s": convert_s, "train": out, "train_s": train_s,
          "imported_loss": ref_loss, "launches": launches})
    del params
    torch.cuda.empty_cache()
    return launches


def pinned_copy_gb_per_s(nbytes: int = 1 << 30) -> dict:
    """Device-to-pinned-host and back over the host link: GB/s of one
    ``nbytes`` copy, median of 5, by CUDA events."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("device_to_host", host, dev),
                           ("host_to_device", dev, host)):
        samples = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            samples.append(nbytes / (start.elapsed_time(end) / 1e3) / 1e9)
        out[name] = statistics.median(samples)
    del host, dev
    return out


def host_link_profile(run) -> dict:
    """One profiled ``run()``: its kernels' device ms (copies apart) and
    its copies over the host link, count and device ms by direction."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {
        "kernel_ms": sum(e.self_device_time_total for e in events
                         if not e.key.startswith("Memcpy")) / 1e3,
        "host_link_copies": {
            e.key: {"calls": e.count, "ms": e.self_device_time_total / 1e3}
            for e in events if e.key.startswith("Memcpy")
            and "Pinned" in e.key},
    }


def phase_remat_ffn_offload() -> dict:
    """The llama3-1b+ffn+adam8 rung under "ffn" and "ffn_offload": one step
    from the same parameters, state and batch must give the same loss and
    the same bits in every updated leaf and moment; then each policy's
    step timed (warm-up + 3, in the order ffn, offload, offload, ffn), its
    peak memory, one profiled step's copies over the host link, and a
    pinned-copy bandwidth probe."""
    t_phase = time.perf_counter()
    cfg, step_ffn, params, opt_state, tokens = adam8_cell()
    ocfg = dataclasses.replace(cfg, remat_policy="ffn_offload")
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    step_off, _, _ = make_train_step(ocfg, optimizer=opt, device="cuda")
    params2 = training.tree_map(lambda t: t.detach().clone(), params)
    state2 = copy.deepcopy(opt_state)
    params, opt_state, loss = step_ffn(params, opt_state, tokens)
    (params2, state2, loss2), launches = kernel_launches_of(
        lambda: step_off(params2, state2, tokens))
    same = leaves_equal(params2, params)
    same_state = all(torch.equal(bits(a), bits(b)) for a, b in zip(
        flat_state({}, state2).values(), flat_state({}, opt_state).values()))
    check(bool(torch.equal(bits(loss), bits(loss2))),
          f"ffn_offload loss {loss2.item()} != ffn's {loss.item()}")
    check(all(same.values()) and same_state,
          f"ffn_offload's step differs from ffn's: "
          f"{[k for k, v in same.items() if not v]}, state {same_state}")
    want = {**remat_launches(cfg.layers), "adam8_fused": 1}
    check(launches == want, f"ffn_offload launches {launches}, "
          f"expected {want}")
    del params2, state2
    torch.cuda.empty_cache()

    runs = {}
    for policy, step in (("ffn", step_ffn), ("ffn_offload", step_off),
                         ("ffn_offload", step_off), ("ffn", step_ffn)):
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, losses, step_s, _, _ = run_steps(
            step, params, opt_state, tokens, TRAIN_STEPS)
        runs.setdefault(policy, []).append(
            {"step_s": step_s, "losses": losses,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    profiles = {}
    for policy, step in (("ffn", step_ffn), ("ffn_offload", step_off)):
        def run():
            nonlocal params, opt_state
            params, opt_state, _ = step(params, opt_state, tokens)

        profiles[policy] = host_link_profile(run)
    probe = pinned_copy_gb_per_s()
    # each way a step: resid_mid [B, S, h], ffn_gate and ffn_up [B, S, ffn]
    # in bf16, every layer
    per_layer = A8_BATCH * A8_SEQ * (cfg.hidden + 2 * cfg.ffn) * 2
    med = {p: statistics.median(s for r in rs for s in r["step_s"])
           for p, rs in runs.items()}
    emit({"phase": "remat_ffn_offload",
          "seconds": time.perf_counter() - t_phase, "preset": "llama3-1b",
          "batch": A8_BATCH, "seq": A8_SEQ, "xent_chunk": A8_CHUNK,
          "optimizer": f"adamw8bit({A8_LR}, {A8_WD})",
          "same_bits": {"loss": True, "leaves": f"{sum(same.values())} of "
                        f"{len(same)}", "optimizer_state": same_state},
          "launches": launches, "runs": runs, "median_step_s": med,
          "offload_minus_ffn_s": med["ffn_offload"] - med["ffn"],
          "profiles": profiles,
          "host_link_bytes_each_way": cfg.layers * per_layer,
          "host_link_bytes_per_layer": per_layer,
          "pinned_copy_gb_per_s": probe,
          "min_ms_each_way_at_probe_rate": {
              d: cfg.layers * per_layer / (gbs * 1e9) * 1e3
              for d, gbs in probe.items()}})
    del params, opt_state, step_ffn, step_off
    torch.cuda.empty_cache()
    return launches


# -- the mesh ------------------------------------------------------------------


def _write_bootstrap(path: Path, plan=None) -> None:
    """A bootstrap file of the agent's schema for one process with one
    chip, its coordinator on a free local port, with ``plan`` as its plan
    block where one is given."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = {
        "version": 1, "coordinator_address": f"127.0.0.1:{port}",
        "num_processes": 1, "process_id": 0,
        "topology": {"num_chips": 1, "chips_per_host": 1, "num_slices": 1},
    }
    if plan is not None:
        cfg["plan"] = plan
    path.write_text(json.dumps(cfg))


def _mesh_train(cfg, mesh, steps: int) -> dict:
    step, init_all, _ = make_train_step(cfg, device="cuda", mesh=mesh)
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    params, opt_state = init_all(gen)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           device="cuda", generator=gen)
    params, opt_state, losses, step_s, per_step, first_s = run_steps(
        step, params, opt_state, tokens, steps)
    del opt_state
    med = statistics.median(step_s)
    return {"params": params, "losses": losses, "per_step": per_step,
            "first_step_s": first_s, "median_step_s": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med}


def phase_mesh_world1() -> dict:
    """The mesh path at a world of one: NCCL from a bootstrap file, the
    all-ones mesh, the train step and serving through it against the
    single-device path from the same seed."""
    import torch.distributed as dist

    from tpu_network_operator_torch.parallel import comm
    from tpu_network_operator_torch.parallel.mesh import AXES
    from tpu_network_operator_torch.workload.common import (batch_rows,
                                                            build_mesh,
                                                            init_distributed)

    t_phase = time.perf_counter()
    directory = SCRATCH / "mesh_world1"
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "jax-coordinator.json"
    _write_bootstrap(path)
    boot, dev = init_distributed(str(path), "cuda")
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"the mesh's backend is {backend}, not nccl")
        check(Path(str(path) + ".lock").exists(), "no job lock held")
        mesh = build_mesh(argparse.Namespace(tensor=1, seq=1, expert=1,
                                             pipe=1), boot, dev)
        check(mesh.shape == dict.fromkeys(AXES, 1),
              f"the world-1 mesh is {mesh.shape}")
        # the collectives on the world's NCCL group: identities at one rank
        world = dist.group.WORLD
        x = torch.randn(8, 256, device="cuda")
        ids = [comm.all_reduce(x, world), comm.all_gather(x, world, 1),
               comm.reduce_scatter(x, world, 1),
               comm.all_to_all(x, world, 1, 0)]
        torch.cuda.synchronize()
        check(all(torch.equal(t, x) for t in ids),
              "a world-1 NCCL collective changed its input")

        # the train cell's step, 3 steps each way (a warm-up and 2 timed)
        cfg = train_cfg()
        single = _mesh_train(cfg, None, TRAIN_STEPS - 1)
        meshed = _mesh_train(cfg, mesh, TRAIN_STEPS - 1)
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(meshed["losses"], single["losses"]))
        leaf_rel = {n: rel_norm(a, b) for n, a, b in zip(
            _leaf_names(single["params"]),
            training.tree_leaves(meshed["params"]),
            training.tree_leaves(single["params"]))}
        same_bits = meshed["losses"] == single["losses"] and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(
                training.tree_leaves(meshed["params"]),
                training.tree_leaves(single["params"])))
        del single["params"], meshed["params"]
        torch.cuda.empty_cache()
        want = {**remat_launches(cfg.layers), "adam8_fused": 0}
        check(all(p == want for p in meshed["per_step"]),
              f"mesh train-step launches {meshed['per_step']}, expected "
              f"{want} per step")
        check(loss_rel <= MESH_LOSS_REL,
              f"mesh vs single-device loss: {loss_rel}")
        check(max(leaf_rel.values()) <= MESH_LEAF_REL,
              f"mesh vs single-device leaves: {leaf_rel}")

        # serving: greedy generate through the mesh path
        gcfg = LlamaConfig.llama3_1b()
        gen = torch.Generator("cuda").manual_seed(SEED)
        params = init_params(gcfg, gen, "cuda")
        prompt = torch.randint(0, gcfg.vocab_size, (BATCH, PROMPT),
                               device="cuda", generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_single = generate(params, prompt, gcfg, MESH_NEW_TOKENS)
        torch.cuda.synchronize()
        single_gen_s = time.perf_counter() - t0
        mesh_params = shard_params(params, gcfg, mesh)
        rows = batch_rows(prompt, mesh)
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_mesh = generate(mesh_params, rows, gcfg, MESH_NEW_TOKENS,
                            mesh=mesh)
        torch.cuda.synchronize()
        mesh_gen_s = time.perf_counter() - t0
        gen_launches = dict(_kernels.LAUNCHES)
        del params, mesh_params
        torch.cuda.empty_cache()
        check(torch.equal(out_mesh, out_single),
              "mesh generate's greedy tokens differ from the single-device "
              "path's")
        want_gen = {"flash_fwd": gcfg.layers,
                    "rms_norm_fwd": (2 * gcfg.layers + 1) * MESH_NEW_TOKENS,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "rms_norm_bwd": 0, "adam8_fused": 0}
        check(gen_launches == want_gen,
              f"mesh generate launches {gen_launches}, expected {want_gen}")
    finally:
        dist.destroy_process_group()
    emit({"phase": "mesh_world1", "backend": backend, "mesh": mesh.shape,
          "bootstrap": str(path.relative_to(SCRATCH.parent)),
          "train": {
              "preset": "llama3-1b", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "remat_policy": cfg.remat_policy, "xent_chunk": cfg.xent_chunk,
              "steps": len(meshed["losses"]),
              "losses": meshed["losses"],
              "single_device_losses": single["losses"],
              "loss_max_rel": loss_rel, "loss_tol": MESH_LOSS_REL,
              "leaf_max_rel_norm": max(leaf_rel.values()),
              "leaf_tol": MESH_LEAF_REL, "same_bits": same_bits,
              "median_step_s": meshed["median_step_s"],
              "single_device_median_step_s": single["median_step_s"],
              "tokens_per_s": meshed["tokens_per_s"],
              "single_device_tokens_per_s": single["tokens_per_s"],
              "launches_per_step": meshed["per_step"][-1]},
          "generate": {
              "batch": BATCH, "prompt": PROMPT,
              "new_tokens": MESH_NEW_TOKENS, "same_tokens": True,
              "seconds": mesh_gen_s, "single_device_seconds": single_gen_s,
              "tokens_per_s": BATCH * MESH_NEW_TOKENS / mesh_gen_s,
              "single_device_tokens_per_s":
                  BATCH * MESH_NEW_TOKENS / single_gen_s,
              "launches": gen_launches},
          "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(directory, ignore_errors=True)
    return {"train": meshed["per_step"][-1], "generate": gen_launches}


def phase_ring_virtual() -> dict:
    """The ring's per-step body over RING_CHUNKS chunks of one sequence
    held in one process, forward and backward, against the dense flash
    call over the whole sequence, at each geometry of RING_GEOMS."""
    gen = torch.Generator("cuda").manual_seed(SEED + 12)
    n = RING_CHUNKS
    pairs = n * (n + 1) // 2
    runs = {}
    for geom, (b, s, h, hkv, d) in RING_GEOMS.items():
        q, k, v = _flash_case(b, h, hkv, s, d, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        qs, ks, vs, dos = (list(t.chunk(n, dim=1)) for t in (q, k, v, do))
        _kernels.reset_launches()
        outs, lses = ring.ring_forward_chunks(qs, ks, vs, "flash")
        fwd = dict(_kernels.LAUNCHES)
        _kernels.reset_launches()
        dq, dk, dv = ring.ring_backward_chunks(qs, ks, vs, outs, lses, dos,
                                               "flash")
        bwd = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        zero = dict.fromkeys(_kernels.LAUNCHES, 0)
        check(fwd == {**zero, "flash_fwd": pairs},
              f"ring forward launches {fwd}, expected {pairs} flash_fwd")
        check(bwd == {**zero, "flash_bwd_dq": pairs, "flash_bwd_dkv": pairs},
              f"ring backward launches {bwd}, expected {pairs} each of "
              "dq and dkv")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ro = fa.flash_attention(*leaves)
        refs = torch.autograd.grad(ro, leaves, do)
        o_err = max_err(torch.cat(outs, dim=1), ro)
        grads = {name: grad_ok(torch.cat(t, dim=1), r) for name, t, r in
                 zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        ok = o_err <= FLASH_O_ATOL and all(g["ok"] for g in grads.values())

        def ring_run():
            o, lse = ring.ring_forward_chunks(qs, ks, vs, "flash")
            ring.ring_backward_chunks(qs, ks, vs, o, lse, dos, "flash")

        def dense_run():
            torch.autograd.grad(fa.flash_attention(*leaves), leaves, do)

        ring_ms = time_ms_eager(ring_run, iters=3, reps=3)
        dense_ms = time_ms_eager(dense_run, iters=3, reps=3)
        emit({"phase": "ring_virtual", "geometry": geom,
              "shape": [b, s, h, hkv, d], "chunks": n,
              "launches_fwd": fwd, "launches_bwd": bwd,
              "max_abs_err_out": o_err,
              "tol": {"out_atol_bf16": FLASH_O_ATOL,
                      "grad_rel_norm": GRAD_REL,
                      "grad_max_frac": GRAD_MAX_FRAC},
              "grads": grads, "ok": ok,
              "ring_fwd_bwd_ms": ring_ms, "dense_fwd_bwd_ms": dense_ms})
        check(ok, f"the ring over {n} chunks disagrees with dense flash at "
                  f"{geom}: out {o_err}, {grads}")
        runs[geom] = {k2: fwd[k2] + bwd[k2] for k2 in fwd}
        del q, k, v, do, qs, ks, vs, dos, outs, lses, dq, dk, dv, leaves
        del ro, refs
        torch.cuda.empty_cache()
    return runs


MOE_RUN_KEYS = ("first_step_s", "step_s", "median_step_s", "tokens_per_s",
                "max_memory_allocated_gib")


def phase_mesh_world1_moe() -> dict:
    """The MoE cell's step through a world-1 NCCL mesh from a bootstrap
    file beside the single-device MoE step from the same seed: the same
    losses, leaf bits and launches per step."""
    import torch.distributed as dist

    from tpu_network_operator_torch.models import moe
    from tpu_network_operator_torch.workload.common import (batch_rows,
                                                            build_mesh,
                                                            init_distributed)

    t_phase = time.perf_counter()
    directory = SCRATCH / "mesh_world1_moe"
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "jax-coordinator.json"
    _write_bootstrap(path)
    boot, dev = init_distributed(str(path), "cuda")
    cfg = moe.MoEConfig.small()
    runs = {}
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"the mesh's backend is {backend}, not nccl")
        mesh = build_mesh(argparse.Namespace(tensor=1, seq=1, expert=1,
                                             pipe=1), boot, dev)
        for side, m in (("single", None), ("mesh", mesh)):
            step, init_all, _ = moe.make_train_step(cfg, device="cuda",
                                                    mesh=m)
            gen = torch.Generator("cuda").manual_seed(SEED + 14)
            torch.cuda.reset_peak_memory_stats()
            params, opt_state = init_all(gen)
            tokens = torch.randint(0, cfg.vocab_size,
                                   (MOE_BATCH, MOE_SEQ + 1), device="cuda",
                                   generator=gen)
            params, opt_state, losses, step_s, per_step, first_s = \
                run_steps(step, params, opt_state, batch_rows(tokens, m),
                          MESH_MOE_STEPS - 1)
            peak = torch.cuda.max_memory_allocated()
            del opt_state, step
            # the single side's leaves wait on the host for the comparison
            kept = params if m is not None else params_to(params, "cpu")
            del params
            torch.cuda.empty_cache()
            med = statistics.median(step_s)
            runs[side] = {"params": kept, "losses": losses,
                          "per_step": per_step, "first_step_s": first_s,
                          "step_s": step_s, "median_step_s": med,
                          "tokens_per_s": MOE_BATCH * MOE_SEQ / med,
                          "max_memory_allocated_gib": peak / 2**30}
    finally:
        dist.destroy_process_group()
    single, meshed = runs["single"], runs["mesh"]
    same_leaves = {n: torch.equal(bits(a), bits(b.to("cuda"))) for n, a, b in
                   zip(_leaf_names(meshed["params"]),
                       training.tree_leaves(meshed["params"]),
                       training.tree_leaves(single["params"]))}
    del single["params"], meshed["params"]
    torch.cuda.empty_cache()
    want = {**remat_launches(cfg.layers), "adam8_fused": 0}
    emit({"phase": "mesh_world1_moe", "backend": backend, "mesh": mesh.shape,
          "preset": "moe:small", "layers": cfg.layers,
          "params": cfg.num_params(), "batch": MOE_BATCH, "seq": MOE_SEQ,
          "remat_policy": cfg.remat_policy, "optimizer": "adamw(3e-4, 0.1)",
          "losses": meshed["losses"],
          "single_device_losses": single["losses"],
          "same_losses": meshed["losses"] == single["losses"],
          "same_bits_leaves": sum(same_leaves.values()),
          "leaves": len(same_leaves),
          **{k: meshed[k] for k in MOE_RUN_KEYS},
          **{f"single_device_{k}": single[k] for k in MOE_RUN_KEYS},
          "launches_per_step": meshed["per_step"][-1],
          "single_device_launches_per_step": single["per_step"][-1],
          "seconds": time.perf_counter() - t_phase})
    check(meshed["losses"] == single["losses"],
          f"world-1 mesh MoE losses {meshed['losses']} are not the single "
          f"device's {single['losses']}")
    check(all(same_leaves.values()),
          "world-1 mesh MoE leaves differ from the single device's: "
          f"{[n for n, ok in same_leaves.items() if not ok]}")
    check(all(p == want for p in meshed["per_step"] + single["per_step"]),
          f"MoE launches per step: mesh {meshed['per_step']}, single "
          f"{single['per_step']}, expected {want}")
    check(meshed["losses"][-1] < meshed["losses"][0],
          f"the mesh MoE loss did not fall: {meshed['losses']}")
    shutil.rmtree(directory, ignore_errors=True)
    return meshed["per_step"][-1]


def phase_expert_virtual() -> dict:
    """One layer's expert FFN at the MoE cell's widths and tokens over
    virtual expert shards in one process, against the unsplit FFN."""
    from tpu_network_operator_torch.models import moe

    cfg = dataclasses.replace(moe.MoEConfig.small(), layers=1)
    gen = torch.Generator("cuda").manual_seed(SEED + 15)
    params = moe.init_params(cfg, gen, "cuda")
    lp = {k: params["layers"][k][0].detach().clone()
          for k in ("router", "w_gate", "w_up", "w_down")}
    del params
    leaves = [t.requires_grad_() for t in lp.values()]
    y = torch.randn(MOE_BATCH, MOE_SEQ, cfg.hidden, device="cuda",
                    generator=gen).bfloat16().requires_grad_()
    dy = torch.randn(y.shape, device="cuda", generator=gen).bfloat16()

    def fwd_bwd(shards):
        if shards == 1:
            out, aux = moe._moe_ffn(cfg, lp, y)
        else:
            out, aux = moe.ffn_over_expert_shards(cfg, lp, y, shards)
        grads = torch.autograd.grad((out.float() * dy.float()).sum() + aux,
                                    [y, *leaves])
        return out, aux, grads

    ref, aux_ref, grads_ref = fwd_bwd(1)
    unsplit_ms = time_ms_eager(lambda: fwd_bwd(1), iters=3, reps=3)
    counts = {}
    for n in EXPERT_SHARDS:
        _kernels.reset_launches()
        out, aux, grads = fwd_bwd(n)
        torch.cuda.synchronize()
        counts[n] = dict(_kernels.LAUNCHES)
        # the shards' partial outputs are rounded to bf16 before their
        # sum, so out is held as the gradients are
        o_ok = grad_ok(out, ref)
        g_ok = {name: grad_ok(g, r) for name, g, r in
                zip(("y", *lp), grads, grads_ref)}
        ok = (o_ok["ok"] and torch.equal(aux, aux_ref)
              and all(g["ok"] for g in g_ok.values()))
        emit({"phase": "expert_virtual", "preset": "moe:small",
              "tokens": [MOE_BATCH, MOE_SEQ], "experts": cfg.experts,
              "shards": n, "experts_per_shard": cfg.experts // n,
              "capacity": cfg.capacity(MOE_SEQ),
              "out": o_ok, "aux_equal": bool(aux == aux_ref),
              "grads": g_ok, "ok": ok,
              "tol": {"rel_norm": GRAD_REL,
                      "grad_max_frac": GRAD_MAX_FRAC},
              "sharded_fwd_bwd_ms": time_ms_eager(lambda: fwd_bwd(n),
                                                  iters=3, reps=3),
              "unsplit_fwd_bwd_ms": unsplit_ms, "launches": counts[n]})
        check(ok, f"the expert FFN over {n} virtual shards disagrees with "
                  f"the unsplit FFN: out {o_ok}, {g_ok}")
    del lp, leaves, y, dy, ref, grads_ref
    torch.cuda.empty_cache()
    return counts


def phase_init_shards() -> dict:
    """mixtral-8x7b drawn for two virtual ranks of an expert axis of
    INIT_EXPERTS (no process group), slab by slab: the seconds and the
    peak memory, and the replicated leaves the same bits on both."""
    from tpu_network_operator_torch.models import moe
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    cfg = moe.MoEConfig.mixtral_8x7b()
    plan = plan_axes(INIT_EXPERTS, expert=INIT_EXPERTS)
    specs = moe.param_specs(cfg)
    replicated = {n: "expert" not in spec for n, spec in zip(
        _leaf_names(specs), training.tree_leaves(specs))}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    ranks, first, same = {}, None, None
    _kernels.reset_launches()
    for r in (0, 1):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = moe.init_params(cfg, torch.Generator("cuda").manual_seed(
            SEED + 16), "cuda", MeshCoord(plan, {"expert": r}))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        leaves = dict(zip(_leaf_names(params),
                          training.tree_leaves(params)))
        ranks[r] = {"seconds": seconds, "peak_bytes": peak,
                    "params": sum(t.numel() for t in leaves.values()),
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in leaves.values()),
                    "w_gate": list(leaves["layers/w_gate"].shape)}
        if first is None:
            # rank 0's replicated leaves wait on the host
            first = {n: t.cpu() for n, t in leaves.items() if replicated[n]}
        else:
            same = all(torch.equal(bits(leaves[n]), bits(t.to("cuda")))
                       for n, t in first.items())
        del params, leaves
        torch.cuda.empty_cache()
    launches = dict(_kernels.LAUNCHES)
    emit({"phase": "init_shards", "preset": "moe:mixtral-8x7b",
          "mesh": plan.axis_sizes, "total_params": cfg.num_params(),
          "ranks": ranks, "same_replicated_bits": same,
          "peak_limit_bytes": INIT_PEAK_LIMIT, "launches": launches})
    check(same,
          "two virtual expert ranks drew different replicated leaves")
    for r in (0, 1):
        check(ranks[r]["peak_bytes"] < INIT_PEAK_LIMIT,
              f"rank {r}'s shard-wise init peaked at "
              f"{ranks[r]['peak_bytes']} bytes")
        check(ranks[r]["w_gate"] == [cfg.layers, 1, cfg.hidden, cfg.ffn],
              f"rank {r}'s w_gate is {ranks[r]['w_gate']}")
    return launches


@contextlib.contextmanager
def world1_mesh(tag: str):
    """The all-ones mesh of a world-1 NCCL group started from a bootstrap
    file under ``SCRATCH/tag`` through the workload's ``init_distributed``
    and ``build_mesh``; the group is destroyed and the file removed on
    exit."""
    import torch.distributed as dist

    from tpu_network_operator_torch.workload.common import (build_mesh,
                                                            init_distributed)

    directory = SCRATCH / tag
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "jax-coordinator.json"
    _write_bootstrap(path)
    boot, dev = init_distributed(str(path), "cuda")
    try:
        check(dist.get_backend() == "nccl",
              f"the mesh's backend is {dist.get_backend()}, not nccl")
        yield build_mesh(argparse.Namespace(tensor=1, seq=1, expert=1,
                                            pipe=1), boot, dev)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)


def _a8_cells():
    """(name, model module, config, seed, batch, seq) of the two adamw8bit
    cells run through the mesh: the adam8 cell's llama3-1b and
    moe-small."""
    from tpu_network_operator_torch.models import llama, moe

    return (("llama3-1b", llama, train_cfg(remat_policy="ffn",
                                           xent_chunk=A8_CHUNK),
             SEED + 9, A8_BATCH, A8_SEQ),
            ("moe-small", moe, moe.MoEConfig.small(), SEED + 14, MOE_BATCH,
             MOE_SEQ))


def phase_mesh_world1_adam8() -> dict:
    """Each adamw8bit cell through a world-1 NCCL mesh with optimizer
    "adam8bit" (``adamw8bit(mesh=, param_specs=)``) beside the
    single-device adam8 step from the same seed: the same losses and the
    same bits of every leaf, code and scale after MESH_A8_STEPS steps, one
    adam8_fused launch a step, the update's device ms in a profiled
    step."""
    from tpu_network_operator_torch.workload.common import batch_rows

    t_phase = time.perf_counter()
    out = {}
    with world1_mesh("mesh_world1_adam8") as mesh:
        for tree, model, cfg, seed, batch, seq in _a8_cells():
            runs = {}
            for side, m in (("single", None), ("mesh", mesh)):
                step, init_all, _ = model.make_train_step(
                    cfg, optimizer="adam8bit", device="cuda", mesh=m)
                gen = torch.Generator("cuda").manual_seed(seed)
                torch.cuda.reset_peak_memory_stats()
                params, opt_state = init_all(gen)
                tokens = batch_rows(torch.randint(
                    0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                    generator=gen), m)
                params, opt_state, losses, step_s, per_step, first_s = \
                    run_steps(step, params, opt_state, tokens,
                              MESH_A8_STEPS - 2)

                def run():
                    nonlocal params, opt_state
                    params, opt_state, _ = step(params, opt_state, tokens)

                prof = profile_steps(run, 1, follow="adam8")
                peak = torch.cuda.max_memory_allocated()
                state = flat_state(params, opt_state)
                # the single side's state waits on the host
                kept = state if m is not None else {
                    k: t.to("cpu", copy=True) for k, t in state.items()}
                runs[side] = {
                    "state": kept, "count": opt_state["count"],
                    "losses": losses, "per_step": per_step,
                    "first_step_s": first_s, "step_s": step_s,
                    "median_step_s": statistics.median(step_s),
                    "adam8_fused_ms_in_step":
                        prof["ms_per_step_by_group"].get("adam8_fused"),
                    "adam8_launches_in_profiled_step":
                        len(prof["launches_of_adam8"]),
                    "max_memory_allocated_gib": peak / 2**30}
                del params, opt_state, state, step, kept
                torch.cuda.empty_cache()
            single, meshed = runs["single"], runs["mesh"]
            differ = [k for k, t in meshed["state"].items() if not torch.equal(
                bits(t), bits(single["state"][k].to(t.device)))]
            n_state = len(meshed["state"])
            del single["state"], meshed["state"]
            torch.cuda.empty_cache()
            want = {**remat_launches(cfg.layers), "adam8_fused": 1}
            emit({"phase": "mesh_world1_adam8", "preset": tree,
                  "mesh": mesh.shape, "layers": cfg.layers,
                  "remat_policy": cfg.remat_policy, "batch": batch,
                  "seq": seq, "optimizer": "adam8bit",
                  "steps": MESH_A8_STEPS, "count": meshed["count"],
                  "losses": meshed["losses"],
                  "single_device_losses": single["losses"],
                  "state_tensors": n_state,
                  "state_tensors_differing": differ,
                  **{k: meshed[k] for k in (
                      "first_step_s", "step_s", "median_step_s",
                      "adam8_fused_ms_in_step",
                      "adam8_launches_in_profiled_step",
                      "max_memory_allocated_gib")},
                  **{f"single_device_{k}": single[k] for k in (
                      "step_s", "median_step_s", "adam8_fused_ms_in_step",
                      "max_memory_allocated_gib")},
                  "launches_per_step": meshed["per_step"][-1]})
            check(meshed["losses"] == single["losses"],
                  f"{tree}: world-1 mesh adam8 losses {meshed['losses']} are "
                  f"not the single device's {single['losses']}")
            check(not differ, f"{tree}: world-1 mesh adam8 state differs from "
                              f"the single device's: {differ}")
            check(meshed["count"] == MESH_A8_STEPS,
                  f"{tree}: count {meshed['count']}")
            check(all(p == want for p in meshed["per_step"]
                      + single["per_step"])
                  and meshed["adam8_launches_in_profiled_step"] == 1,
                  f"{tree}: adam8 launches per step: mesh "
                  f"{meshed['per_step']}, single {single['per_step']}, "
                  f"expected {want}")
            out[tree] = {"launches": meshed["per_step"][-1],
                         "adam8_fused_ms_in_step":
                             meshed["adam8_fused_ms_in_step"],
                         "single_device_adam8_fused_ms_in_step":
                             single["adam8_fused_ms_in_step"]}
    emit({"phase": "mesh_world1_adam8_done",
          "seconds": time.perf_counter() - t_phase})
    return out


def phase_checkpoint_mesh() -> dict:
    """phase_checkpoint through a world-1 NCCL mesh: the adamw8bit step on
    the mesh, batches through ``sharded_batches``, a save of every leaf as
    a DTensor (``TrainCheckpointer(mesh=, specs=)``) after 2 steps, 1 more
    step; the save restored in place into a fresh mesh state must be the
    same bits and the resumed step give the same loss; the same save
    restored on one device, and a one-device save of that state restored
    through the mesh, the same bits."""
    from tpu_network_operator_torch.models.convert import param_specs

    cfg = train_cfg(layers=CKPT_LAYERS, remat_policy="ffn",
                    xent_chunk=A8_CHUNK)
    pspecs = param_specs(cfg)
    SCRATCH.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        path = tmp / "tokens.bin"
        np.random.default_rng(SEED + 10).integers(
            0, cfg.vocab_size, 1 << 22, dtype=np.uint32).tofile(path)
        source = data.MemmapTokens(str(path), vocab_size=cfg.vocab_size)
        dcfg = data.DataConfig(batch=CKPT_BATCH, seq_len=CKPT_SEQ, seed=SEED)
        with world1_mesh("checkpoint_mesh") as mesh:
            step, init_all, opt = make_train_step(
                cfg, optimizer="adam8bit", device="cuda", mesh=mesh)
            batches = data.sharded_batches(source, dcfg, mesh)
            params, opt_state = init_all(
                torch.Generator("cuda").manual_seed(SEED + 11))
            specs = (pspecs, opt.state_specs(params, pspecs))
            losses = []
            with TrainCheckpointer(tmp / "ckpt", mesh=mesh,
                                   specs=specs) as ckpt:
                for _ in range(2):
                    params, opt_state, loss = step(params, opt_state,
                                                   next(batches))
                    losses.append(loss.item())
                t0 = time.perf_counter()
                ckpt.save(2, params, opt_state)
                save_s = time.perf_counter() - t0
                saved = {k: t.to("cpu", copy=True)
                         for k, t in flat_state(params, opt_state).items()}
                params, opt_state, loss = step(params, opt_state,
                                               next(batches))
                loss_3 = loss.item()
                del params, opt_state
                t0 = time.perf_counter()
                ckpt.wait()
                write_s = time.perf_counter() - t0
                fresh = init_all(torch.Generator("cuda").manual_seed(
                    SEED + 12))
                t0 = time.perf_counter()
                at, params, opt_state = ckpt.restore(fresh)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            restored = flat_state(params, opt_state)
            differ = {k: int((bits(restored[k].cpu()) != bits(t)).sum())
                      for k, t in saved.items()}
            resumed = data.sharded_batches(source, dcfg, mesh, start_step=at)
            _kernels.reset_launches()
            params, opt_state, loss = step(params, opt_state, next(resumed))
            loss_resumed = loss.item()
            launches = dict(_kernels.LAUNCHES)
            del params, opt_state, fresh, restored
            torch.cuda.empty_cache()

            # the mesh's save on one device, then a one-device save of
            # that state restored through the mesh
            one_step, one_init, _ = make_train_step(
                cfg, optimizer="adam8bit", device="cuda")
            with TrainCheckpointer(tmp / "ckpt") as ckpt:
                at_one, p1, s1 = ckpt.restore(one_init(
                    torch.Generator("cuda").manual_seed(SEED + 13)))
            on_one = flat_state(p1, s1)
            differ_one = {k: int((bits(on_one[k].cpu()) != bits(t)).sum())
                          for k, t in saved.items()}
            with TrainCheckpointer(tmp / "one", async_save=False) as ckpt:
                ckpt.save(2, p1, s1)
            del p1, s1, on_one
            templates = init_all(torch.Generator("cuda").manual_seed(
                SEED + 14))
            with TrainCheckpointer(tmp / "one", mesh=mesh,
                                   specs=specs) as ckpt:
                _, p2, s2 = ckpt.restore(templates)
            back = flat_state(p2, s2)
            differ_back = {k: int((bits(back[k].cpu()) != bits(t)).sum())
                           for k, t in saved.items()}
            del p2, s2, back, templates, step, init_all, one_step, one_init
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "ckpt").rglob("*")
                         if f.is_file())
        files = sorted(f.name for f in (tmp / "ckpt" / "2").iterdir())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "checkpoint_mesh", "layers": cfg.layers,
          "mesh": mesh.shape, "batch": CKPT_BATCH, "seq": CKPT_SEQ,
          "optimizer": "adam8bit", "losses": losses + [loss_3],
          "resumed_from": at, "loss_uninterrupted": loss_3,
          "loss_resumed": loss_resumed,
          "round_trip_mismatched_values": sum(differ.values()),
          "on_one_device_mismatched_values": sum(differ_one.values()),
          "one_device_save_through_mesh_mismatched_values":
              sum(differ_back.values()),
          "checkpoint_bytes": ckpt_bytes, "files": files,
          "save_returns_s": save_s, "write_wait_s": write_s,
          "restore_s": restore_s, "resumed_step_launches": launches})
    check(at == 2 and at_one == 2, "resumed at the wrong step")
    check(not any(differ.values()),
          f"mesh checkpoint round trip changed {differ}")
    check(not any(differ_one.values()),
          f"the mesh checkpoint on one device changed {differ_one}")
    check(not any(differ_back.values()),
          f"a one-device checkpoint through the mesh changed {differ_back}")
    check(loss_resumed == loss_3,
          f"resumed loss {loss_resumed} != uninterrupted {loss_3}")
    check(launches == {**remat_launches(cfg.layers), "adam8_fused": 1},
          f"the resumed mesh step's launches {launches}")
    return launches


# -- the collectives -----------------------------------------------------------


@contextlib.contextmanager
def dist_calls(names=("all_reduce", "reduce_scatter_tensor",
                      "all_gather_into_tensor")):
    """The ``torch.distributed`` collectives ``names`` counted while the
    block runs: a dict of calls by name."""
    import torch.distributed as dist

    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def cli_on_bootstrap(tag: str, argv, plan=None) -> tuple:
    """The workload CLI's ``argv`` with ``--bootstrap`` a world-1 file
    (under ``SCRATCH/tag``, with ``plan`` as its plan block) in this
    process: (its JSON line, the group's backend, the file's sha256, the
    collectives it called).  The CLI starts the process group; it is
    destroyed and the file removed here."""
    import hashlib

    import torch.distributed as dist

    directory = SCRATCH / tag
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "jax-coordinator.json"
    _write_bootstrap(path, plan)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    try:
        with dist_calls() as calls:
            line = run_cli([*argv, "--bootstrap", str(path)])
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)
    return line, backend, digest, calls


def phase_collectives_world1() -> dict:
    """The collectives sweep over fsdp of a world-1 NCCL mesh (every op's
    output its input, bit for bit), and ``workload collectives`` at that
    world ("nothing to sweep")."""
    from tpu_network_operator_torch.parallel import collectives as coll

    t_phase = time.perf_counter()
    _kernels.reset_launches()
    with world1_mesh("collectives_world1") as mesh:
        backend = torch.distributed.get_backend()
        results = coll.sweep(mesh, axis="fsdp", sizes_mb=list(COLL_SIZES_MB),
                             iters=COLL_ITERS)
        same = {}
        for op in coll.OPS:
            fn = coll._collective_fn(op, "fsdp", mesh)
            for size in COLL_SIZES_MB:
                x, _ = coll.collective_input(mesh, op, "fsdp", size)
                want = x.clone()
                out = fn(x)
                torch.cuda.synchronize()
                same[f"{op}@{size}MB"] = (out.shape == want.shape and
                                          torch.equal(bits(out), bits(want)))
                del x, want, out
    torch.cuda.empty_cache()
    line, cli_backend, _, _ = cli_on_bootstrap(
        "collectives_cli", ["collectives", "--device", "cuda"])
    launches = dict(_kernels.LAUNCHES)
    rows = [r.to_dict() for r in results]
    emit({"phase": "collectives_world1", "backend": backend,
          "axis": "fsdp", "iters": COLL_ITERS,
          "note": "world of one: seconds are NCCL's per-call time at one "
                  "rank (best of iters); algbw / busbw are size over that "
                  "time, not a bandwidth of any link",
          "rows": rows, "output_is_input": same,
          "cli": line, "cli_backend": cli_backend,
          "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    check(all(same.values()),
          f"a world-1 NCCL collective changed its input: {same}")
    check([(r["op"], r["size_bytes"]) for r in rows] ==
          [(op, int(size * 1e6)) for op in coll.OPS for size in COLL_SIZES_MB],
          f"the sweep's points {[(r['op'], r['size_bytes']) for r in rows]}")
    check(all(r["seconds"] > 0 for r in rows), "a sweep point took no time")
    check(cli_backend == "nccl", f"workload collectives ran on {cli_backend}")
    check(line == {"metric": "collective busbw", "value": 0.0,
                   "unit": "GB/s", "axis": "data", "devices": 1},
          f"workload collectives at a world of one printed {line}")
    return launches


def phase_exec_bench_world1() -> dict:
    """``workload exec-bench`` over a world-1 bootstrap with a plan block
    (fsdp first, ``hierarchical``), and over one whose plan block is
    mangled."""
    from tpu_network_operator_torch.parallel.mesh import AXES

    t_phase = time.perf_counter()
    _kernels.reset_launches()
    line, backend, digest, calls = cli_on_bootstrap(
        "exec_bench_planned",
        ["exec-bench", "--device", "cuda", "--sizes-mb",
         *(str(s) for s in EXEC_SIZES_MB), "--iters", str(EXEC_ITERS)],
        plan=EXEC_PLAN)
    mangled, m_backend, m_digest, _ = cli_on_bootstrap(
        "exec_bench_mangled",
        ["exec-bench", "--device", "cuda", "--sizes-mb", "1", "--iters", "1"],
        plan={"meshAxisOrder": ["fsdp", "data"], "collective": "tree",
              "version": 3})
    launches = dict(_kernels.LAUNCHES)
    emit({"phase": "exec_bench_world1", "backend": backend,
          "note": "world of one: seconds are NCCL's per-call time at one "
                  "rank (best of iters), not a bandwidth",
          "line": line, "collective_calls": calls,
          "mangled_plan": {k: mangled[k] for k in (
              "mesh_planned", "mesh_axis_order", "collective_hint",
              "plan_version", "results")},
          "kernel_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    rows = line["results"]
    check(backend == m_backend == "nccl",
          f"exec-bench ran on {backend} / {m_backend}")
    check(line["bootstrap_sha256"] == digest
          and mangled["bootstrap_sha256"] == m_digest,
          "exec-bench's sha256 is not the bootstrap file's")
    check(line["mesh_axis_order"] == EXEC_PLAN["meshAxisOrder"]
          and list(line["mesh_planned"]) == EXEC_PLAN["meshAxisOrder"]
          and line["collective_hint"] == "hierarchical"
          and line["plan_version"] == EXEC_PLAN["version"],
          f"exec-bench did not take the plan: {line}")
    check((line["local_devices"], line["global_devices"]) == (1, 1),
          f"exec-bench's devices {line['local_devices']} / "
          f"{line['global_devices']}")
    check([r["size_mb"] for r in rows] == list(EXEC_SIZES_MB)
          and all(r["planned_strategy"] == "hierarchical"
                  and r["planned_s"] == r["hierarchical_s"]
                  and all(r[k] > 0 for k in ("planned_s", "ring_s",
                                              "hierarchical_s", "naive_s"))
                  for r in rows),
          f"exec-bench's rows {rows}")
    # hierarchical at ici 1 runs as ring: all-reduces only
    check(calls["reduce_scatter_tensor"] == calls["all_gather_into_tensor"]
          == 0 and calls["all_reduce"] > 0,
          f"hierarchical at ici 1 issued {calls}")
    check(mangled["mesh_axis_order"] == list(AXES)
          and mangled["collective_hint"] == "ring"
          and all(r["planned_strategy"] == "ring"
                  for r in mangled["results"]),
          f"a mangled plan block gave {mangled}")
    return launches


def _unflat(names, values) -> dict:
    """A nested tree from key paths (:func:`_leaf_names`) and leaves."""
    out = {}
    for name, v in zip(names, values):
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _a8_virtual_grads(start, step: int):
    """The whole tree's gradients of one step, leaf by leaf in tree order,
    from a generator seeded by the step (so a run can draw them again)."""
    gen = torch.Generator("cuda").manual_seed(SEED + 20 + step)
    for p in start:
        yield adam8_grad(p.shape, "f32" if p.dtype == torch.float32
                         else "random", gen)


def phase_adam8_virtual_shards(name: str) -> dict:
    """Each virtual rank of llama3-1b's 12 leaves at fsdp 2 x tensor 4 and
    at tensor 2, and of moe-small's 13 at expert 8 and at expert 2 x
    tensor 4, stepped A8_VIRTUAL_STEPS times in one process
    (``optim8bit.update_virtual_ranks``: one kernel launch a rank a step,
    over its per-shard leaves and the gathered rows of its global-block
    leaves): every rank's parameters, codes and scales the same bits as
    its slice of the whole tree stepped by the kernel; then each rank's
    kernel time against its bytes bound, and which leaves took which
    path."""
    from tpu_network_operator_torch.models import llama, moe
    from tpu_network_operator_torch.models.llama import shard_leaf
    from tpu_network_operator_torch.parallel import MeshCoord, plan_axes

    bw, _, _ = measure.peaks(name)
    out = {}
    for tree, model, cfg in (("llama3-1b", llama, LlamaConfig.llama3_1b()),
                             ("moe-small", moe, moe.MoEConfig.small())):
        opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
        whole = model.init_params(cfg, torch.Generator("cuda").manual_seed(
            SEED + 17), "cuda")
        names = list(_leaf_names(whole))
        pspecs = model.param_specs(cfg)
        spec_of = dict(zip(_leaf_names(pspecs), training.tree_leaves(pspecs)))
        leaves = list(training.tree_leaves(whole))
        start = [p.to("cpu", copy=True) for p in leaves]
        state = opt.init(whole)
        ms, vs = (list(training.tree_leaves(state[k])) for k in ("m", "v"))
        t0 = time.perf_counter()
        for i in range(A8_VIRTUAL_STEPS):
            g = list(_a8_virtual_grads(start, i))
            optim8bit.adam8_fused(list(zip(leaves, g, ms, vs)),
                                  opt.consts(i + 1))
            del g
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        ref = [(p.cpu(), m.q.cpu(), m.scale.cpu(), v.q.cpu(), v.scale.cpu())
               for p, m, v in zip(leaves, ms, vs)]
        del whole, state, leaves, ms, vs
        torch.cuda.empty_cache()
        for axes in A8_VIRTUAL_MESHES[tree]:
            plan = plan_axes(math.prod(axes.values()), **axes)
            coords = [MeshCoord(plan, dict(zip(plan.names, idx))) for idx in
                      itertools.product(*(range(n) for n in plan.shape))]
            shards = [[] for _ in coords]
            for j, p0 in enumerate(start):
                w = p0.to("cuda")
                for r, c in enumerate(coords):
                    shards[r].append(shard_leaf(w, spec_of[names[j]],
                                                c).clone())
                del w
            ranks = []
            for c, sh in zip(coords, shards):
                params = _unflat(names, sh)
                ropt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD,
                                           mesh=c, param_specs=pspecs)
                st = ropt.init(params)
                ranks.append((c, params, ropt, st))
            del shards
            launches = []
            for i in range(A8_VIRTUAL_STEPS):
                gsh = [[] for _ in coords]
                for j, gw in enumerate(_a8_virtual_grads(start, i)):
                    for r, c in enumerate(coords):
                        gsh[r].append(shard_leaf(gw, spec_of[names[j]], c))
                    del gw
                _kernels.reset_launches()
                optim8bit.update_virtual_ranks([
                    (c, list(zip(training.tree_leaves(p), g,
                                 training.tree_leaves(st["m"]),
                                 training.tree_leaves(st["v"]))),
                     list(training.tree_leaves(ropt.plans(p))))
                    for (c, p, ropt, st), g in zip(ranks, gsh)],
                    opt.consts(i + 1))
                torch.cuda.synchronize()
                launches.append(dict(_kernels.LAUNCHES))
                del gsh
            # each rank's tensors and cut of each leaf, by name
            per_rank = []
            for c, p, ropt, st in ranks:
                sspecs = ropt.state_specs(p, pspecs)["m"]
                cut = dict(zip(_leaf_names(sspecs),
                               training.tree_leaves(sspecs)))
                per_rank.append((c, {n: ((q, m.q, m.scale, v.q, v.scale),
                                         (cut[n].q, cut[n].q, cut[n].scale,
                                          cut[n].q, cut[n].scale))
                                     for n, q, m, v in zip(
                                         names, training.tree_leaves(p),
                                         training.tree_leaves(st["m"]),
                                         training.tree_leaves(st["v"]))}))
            differ = []
            for j, n in enumerate(names):
                want = [t.to("cuda") for t in ref[j]]
                for c, tensors in per_rank:
                    got, cuts = tensors[n]
                    for what, a, b, spec in zip(A8_NAMES, got, want, cuts):
                        if not torch.equal(bits(a),
                                           bits(shard_leaf(b, spec, c))):
                            differ.append([n, what, c.coord])
                del want
            del per_rank
            rows, path = [], {}
            for c, p, ropt, st in ranks:
                plans = list(training.tree_leaves(ropt.plans(p)))
                path = {n: a or "per_shard" for n, a in zip(names, plans)}
                run = _a8_rank_run(c, ranks, plans)
                k = opt.consts(A8_VIRTUAL_STEPS + 1)
                rows.append({"rank": c.coord,
                             "bytes": sum(adam8_bytes(t[0]) for t in run),
                             "kernel_ms": time_ms(
                                 lambda: optim8bit.adam8_fused(run, k),
                                 iters=5, reps=5)})
                rows[-1]["bound_ms"] = rows[-1]["bytes"] / bw * 1e3
                del run
            emit({"phase": "adam8_virtual_shards", "preset": tree,
                  "mesh": plan.axis_sizes, "ranks": len(coords),
                  "steps": A8_VIRTUAL_STEPS, "path": path,
                  "launches_per_step": launches,
                  "whole_tree_steps_s": whole_s,
                  "per_rank": rows, "differing": differ[:20],
                  "bound": "bytes / 3.35 TB/s: each rank's leaves and "
                           "gathered rows read and written once"})
            check(not differ, f"{tree} at {plan.axis_sizes}: virtual ranks "
                              f"differ from the whole tree: {differ[:5]}")
            check(all(n["adam8_fused"] == len(coords) for n in launches),
                  f"{tree} at {plan.axis_sizes}: adam8_fused launches "
                  f"{launches}, expected {len(coords)} a step")
            mesh_name = "_".join(f"{a}{n}" for a, n in axes.items() if n > 1)
            out[f"{tree}_{mesh_name}"] = {"launches": launches[-1],
                                          "per_rank": rows, "path": path}
            del ranks
            torch.cuda.empty_cache()
        del start, ref
    return out


def _a8_rank_run(coord, ranks, plans) -> list:
    """One virtual rank's kernel table as :func:`optim8bit.update_shards`
    builds it: its per-shard leaves, and for each global-block leaf the
    rows of the ranks along its axis, concatenated, with its own scales;
    fresh gradients as :func:`adam8_grad` draws them (a zero gradient
    sends a block with a zero moment down the kernel's exact path, which
    a training step rarely takes)."""
    gen = torch.Generator("cuda").manual_seed(SEED + 30)

    def grad(p):
        return adam8_grad(p.shape, "f32" if p.dtype == torch.float32
                          else "random", gen)

    index = {tuple(c.coord.values()): r for r, (c, *_) in enumerate(ranks)}
    trees = [(list(training.tree_leaves(p)),
              list(training.tree_leaves(st["m"])),
              list(training.tree_leaves(st["v"]))) for _, p, _, st in ranks]
    own_p, own_m, own_v = trees[index[tuple(coord.coord.values())]]
    run = []
    for j, axis in enumerate(plans):
        if axis is None:
            run.append((own_p[j], grad(own_p[j]), own_m[j], own_v[j]))
            continue
        peers = [index[tuple(i if a == axis else c
                             for a, c in coord.coord.items())]
                 for i in range(coord.size(axis))]
        p = torch.cat([trees[q][0][j] for q in peers], dim=-1)
        mq = torch.cat([trees[q][1][j].q for q in peers], dim=-1)
        vq = torch.cat([trees[q][2][j].q for q in peers], dim=-1)
        run.append((p, grad(p),
                    optim8bit.QTensor(mq, own_m[j].scale.clone()),
                    optim8bit.QTensor(vq, own_v[j].scale.clone())))
    return run


def _leaf_names(tree, prefix=""):
    """Key paths in training.tree_leaves order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def _bound(nbytes, flops, bw, peak):
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sdpa_backward_ms(q, k, v, do, causal=True):
    """One PyTorch call's backward for the same attention, as a yardstick:
    ``scaled_dot_product_attention`` forward + backward minus forward, on
    [B, H, S, D] copies, under the first fused backend that takes the GQA
    shapes (K/V repeated to the q-heads if none takes them as they are).
    Timed without a CUDA graph: milliseconds of device work per call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    n_rep = qt.shape[1] // kt.shape[1]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for gqa in (True, False):
            kk, vv = (kt, vt) if gqa else (
                t.repeat_interleave(n_rep, dim=1) for t in (kt, vt))
            leaves = [t.detach().requires_grad_() for t in (qt, kk, vv)]

            def fwd():
                return sdpa(*leaves, is_causal=causal, enable_gqa=gqa)

            def both():
                return torch.autograd.grad(fwd(), leaves, dot)

            try:
                with sdpa_kernel([backend]):
                    both()
                    torch.cuda.synchronize()
                    ms = time_ms_eager(both) - time_ms_eager(fwd)
            except RuntimeError:
                continue
            return ms, {"backend": backend.name, "gqa_native": gqa}
    return None, {"backend": None}


def _pairs(s: int, causal: bool) -> int:
    """(q, k) pairs per head of an s x s chunk: causal or full."""
    return s * (s + 1) // 2 if causal else s * s


def flash_fwd_entry(gen, b, s, h, hkv, d, iters_plain, bw, peak,
                    causal=True) -> dict:
    """The flash forward kernel at [B, S, H/Hkv, D], causal or full: its
    time, its plain version's, SDPA's and its bound."""
    q, k, v = _flash_case(b, h, hkv, s, d, gen)
    o, lse = fa._flash_fwd_kernel(q, k, v, causal=causal, seq_dim=1,
                                  head_dim=2)
    ro, rlse = _flash_plain_bshd(q, k, v, causal)
    err = max_err(o, ro)
    check(err <= FLASH_O_ATOL and max_err(lse, rlse) <= FLASH_LSE_ATOL,
          f"flash_fwd disagrees with its plain version at {(b, s, h, d)}")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + b * h * s * 4
    # QK^T and PV over the live pairs
    flops = 4 * d * _pairs(s, causal) * b * h
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {
        "shape": [b, s, h, hkv, d], "causal": causal, "max_abs_err": err,
        "ms": time_ms(lambda: fa._flash_fwd_kernel(
            q, k, v, causal=causal, seq_dim=1, head_dim=2)),
        "plain_ms": time_ms(lambda: _flash_plain_bshd(q, k, v, causal),
                            iters=iters_plain, reps=5),
        **_bound(nbytes, flops, bw, peak),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
    }


def flash_bwd_entries(gen, b, s, h, hkv, d, bw, peak, causal=True,
                      out_f32=False):
    """The dQ and the dK/dV kernels at [B, S, H/Hkv, D], causal or full,
    with bf16 outputs (the dense path) or f32 (a ring chunk): each one's
    time, its plain version's and its bound, and SDPA's whole backward."""
    inputs = _flash_bwd_inputs(b, h, hkv, s, d, causal, gen)
    q, k, v, do, lse, delta = inputs
    kw = dict(causal=causal, seq_dim=1, head_dim=2, out_f32=out_f32)
    outs = (fa._flash_bwd_dq_kernel(*inputs, **kw),
            *fa._flash_bwd_dkv_kernel(*inputs, **kw))
    if out_f32:
        refs = tuple(t.transpose(1, 2) for t in fa._flash_bwd_plain_at_tiles(
            *(t.transpose(1, 2) for t in (q, k, v, do)), lse, delta,
            causal=causal))
    else:
        refs = _flash_bwd_plain_bshd(*inputs, causal)
    res, ok = _grads_ok(outs, refs)
    check(ok, f"flash backward disagrees with its plain version at "
              f"{(b, s, h, hkv, d, causal)}: {res}")
    del outs, refs
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    bp_dq = fa._bwd_plain_at(qt, kt, vt, dot, lse, delta, fa.DQ_TILE,
                             causal)
    bp_dkv = fa._bwd_plain_at(qt, kt, vt, dot, lse, delta, fa.DKV_TILE,
                              causal)
    lib_ms, lib = _sdpa_backward_ms(q, k, v, do, causal)
    matmul = 2 * d * _pairs(s, causal) * b * h   # one product, all heads
    q_bytes, kv_bytes, stat_bytes = q.numel() * 2, k.numel() * 2, b * h * s * 4
    out_size = 4 if out_f32 else 2
    common = {"shape": [b, s, h, hkv, d], "causal": causal,
              "out_f32": out_f32, "library_ms": lib_ms,
              "library": {**lib, "covers": "dq+dkv"}}
    dq = {**common, "max_abs_err": res["dq"]["max_abs_err"],
          "ms": time_ms(lambda: fa._flash_bwd_dq_kernel(*inputs, **kw)),
          "plain_ms": time_ms(lambda: fa._flash_bwd_dq_plain(bp_dq, q.dtype),
                              iters=1, reps=3),
          # S, dP and dQ; reads q, dO, k, v, lse, delta, writes dq
          **_bound(2 * q_bytes + q.numel() * out_size + 2 * kv_bytes
                   + 2 * stat_bytes, 3 * matmul, bw, peak)}
    dkv = {**common, "max_abs_err": max(res["dk"]["max_abs_err"],
                                        res["dv"]["max_abs_err"]),
           "ms": time_ms(lambda: fa._flash_bwd_dkv_kernel(*inputs, **kw)),
           "plain_ms": time_ms(lambda: fa._flash_bwd_dkv_plain(bp_dkv),
                               iters=1, reps=3),
           # S, dP, dV and dK; reads q, dO, k, v, lse, delta, writes dk, dv
           **_bound(2 * q_bytes + 2 * kv_bytes + 2 * k.numel() * out_size
                    + 2 * stat_bytes, 4 * matmul, bw, peak)}
    return dq, dkv


def ring_chunk_entries(gen, bw, peak) -> dict:
    """The ring's chunk calls at RING_GEOMS, each chunk RING_SEQ /
    RING_CHUNKS long: the diagonal (causal) and a past chunk (full), the
    forward and the f32 backward that chunk_fwd / chunk_bwd launch (the
    same kernels on the same memory: the seams read [B, H, S, D] views of
    these [B, S, H, D] tensors through strides)."""
    s = RING_SEQ // RING_CHUNKS
    rows = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for geom, (b, _, h, hkv, d) in RING_GEOMS.items():
        for kind, causal in (("diagonal", True), ("past", False)):
            key = f"{geom}_d{d}_{kind}"
            rows["flash_fwd"][key] = flash_fwd_entry(
                gen, b, s, h, hkv, d, 1, bw, peak, causal=causal)
            dq, dkv = flash_bwd_entries(gen, b, s, h, hkv, d, bw, peak,
                                        causal=causal, out_f32=True)
            rows["flash_bwd_dq"][key] = dq
            rows["flash_bwd_dkv"][key] = dkv
    return rows


def _pipeline_run(step, init_all, tokens, gen, profile=False) -> dict:
    """A warm-up and PIPE_STEPS timed steps of a pipeline (or the
    single-device) step from a fresh init: times, losses, peak memory and
    each kernel's launches per step; with ``profile``, one more step
    under the profiler (the device's busy share, ms by kernel group)."""
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = init_all(gen)
    params, opt_state, losses, step_s, per_step, first_s = run_steps(
        step, params, opt_state, tokens, PIPE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    prof = None
    if profile:
        prof = profile_steps(lambda: step(params, opt_state, tokens), 1)
        prof.pop("top_kernels")
    del params, opt_state
    torch.cuda.empty_cache()
    med = statistics.median(step_s)
    return {"first_step_s": first_s, "step_s": step_s, "median_step_s": med,
            "tokens_per_s": tokens.shape[0] * (tokens.shape[1] - 1) / med,
            "losses": losses, "peak_mem_gib": peak / 2**30,
            "profile": prof, "per_step": per_step}


def phase_pipeline_virtual() -> dict:
    """The pipeline's executor over PIPE_STAGES stages held in one process
    (``make_pipeline_train_step(..., stages_in_process=)``: the in-process
    wire hands activations and cotangents between the stages, where a
    mesh makes one hop pair a tick on the pipe axis's group) at the train
    cell, each schedule: its grads_fn against autograd of the
    single-device loss_fn on the same parameters, then timed steps beside
    the single-device step with the launches a step asserted; then the
    MoE at 4 layers over 2 stages, 1f1b against gpipe."""
    from tpu_network_operator_torch.models import moe as tmoe
    from tpu_network_operator_torch.parallel import pipeline as tpipe

    t_phase = time.perf_counter()
    cfg = train_cfg()
    n, m = cfg.layers, PIPE_MICRO
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    params = init_params(cfg, gen, "cuda")           # phase train's draws
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           device="cuda", generator=gen)
    leaves = [p.requires_grad_() for p in training.tree_leaves(params)]
    ref_loss = loss_fn(params, tokens, cfg)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    ref_loss = ref_loss.item()
    # one device's loss_fn a microbatch at a time, the gradients summed
    # in f32 as the units' are
    micro_grads = [torch.zeros(p.shape, device="cuda") for p in leaves]
    for part in tokens.chunk(m):
        for acc, g in zip(micro_grads, torch.autograd.grad(
                loss_fn(params, part, cfg) / m, leaves)):
            acc.add_(g)
    for p in leaves:
        p.requires_grad_(False)
    names = list(_leaf_names(params))
    # per microbatch, the single-device step's launches (full remat)
    want = {k: m * v for k, v in remat_launches(n).items()}
    want["adam8_fused"] = 0
    runs, counts = {}, {}
    for schedule in PIPE_SCHEDULES:
        step, init_all, _ = tpipe.make_pipeline_train_step(
            cfg, None, m, schedule=schedule, virtual_stages=PIPE_V,
            device="cuda", stages_in_process=PIPE_STAGES)
        loss, grads = step.grads_fn(
            tpipe.chunked_layers(params, step.v), tokens)
        loss = loss.item()
        got = [g.reshape(r.shape) for g, r in
               zip(training.tree_leaves(grads), ref_grads)]
        checks = {name: grad_ok(g, r)
                  for name, g, r in zip(names, got, micro_grads)}
        batch = {name: rel_norm(g, r)
                 for name, g, r in zip(names, got, ref_grads)}
        del grads, got
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        run = _pipeline_run(step, init_all, tokens,
                            torch.Generator("cuda").manual_seed(SEED + 5),
                            profile=schedule == "1f1b")
        per_step = run.pop("per_step")
        worst = max(checks, key=lambda k: checks[k]["rel_norm"])
        worst_batch = max(batch, key=batch.get)
        runs[schedule] = {
            "virtual_stages": step.v, "loss": loss, "ref_loss": ref_loss,
            "loss_rel": loss_rel,
            "worst_grad_vs_microbatched": {worst: checks[worst]},
            "worst_grad_rel_norm_vs_batch": {worst_batch:
                                             batch[worst_batch]},
            "grads_ok": all(c["ok"] for c in checks.values()) and max(
                batch.values()) <= TRAIN_GRAD_REL,
            "max_live_graphs": step.stats["max_live_graphs"],
            "launches_per_step": per_step[-1], **run}
        emit({"phase": "pipeline_virtual", "schedule": schedule,
              "stages": PIPE_STAGES, "microbatches": m,
              **runs[schedule]})
        check(loss_rel <= PIPE_LOSS_REL,
              f"pipeline {schedule}: loss {loss} against the single "
              f"device's {ref_loss}")
        check(runs[schedule]["grads_ok"],
              f"pipeline {schedule}: gradients off the single device's: "
              f"{ {k: c for k, c in checks.items() if not c['ok']} }, "
              f"against the whole batch's {batch}")
        check(all(p == want for p in per_step),
              f"pipeline {schedule} launches {per_step}, expected {want} "
              "per step")
        check(run["losses"][-1] < run["losses"][0],
              f"pipeline {schedule}: the loss did not fall: "
              f"{run['losses']}")
        counts[schedule] = per_step[-1]
        del step, init_all
    del params, leaves, ref_grads, micro_grads
    torch.cuda.empty_cache()
    step, init_all, _ = make_train_step(cfg, device="cuda")
    single = _pipeline_run(step, init_all, tokens,
                           torch.Generator("cuda").manual_seed(SEED + 5),
                           profile=True)
    single.pop("per_step")
    del step, init_all, tokens
    torch.cuda.empty_cache()

    # the MoE: 1f1b's loss falls; its first step is gpipe's within the
    # reference's budget between its schedules
    mcfg = dataclasses.replace(tmoe.MoEConfig.small(),
                               layers=PIPE_MOE_LAYERS)
    mgen = torch.Generator("cuda").manual_seed(SEED + 9)
    mtokens = torch.randint(0, mcfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1),
                            device="cuda", generator=mgen)
    moe_runs = {}
    for schedule in ("1f1b", "gpipe"):
        step, init_all, _ = tpipe.make_moe_pipeline_train_step(
            mcfg, None, PIPE_MOE_MICRO, schedule=schedule, device="cuda",
            stages_in_process=PIPE_MOE_STAGES)
        run = _pipeline_run(step, init_all, mtokens,
                            torch.Generator("cuda").manual_seed(SEED + 9))
        counts[f"moe_{schedule}"] = run.pop("per_step")[-1]
        moe_runs[schedule] = run
        del step, init_all
        torch.cuda.empty_cache()
    f1b, gp = moe_runs["1f1b"]["losses"], moe_runs["gpipe"]["losses"]
    emit({"phase": "pipeline_virtual_moe", "preset": "moe-small",
          "layers": PIPE_MOE_LAYERS, "stages": PIPE_MOE_STAGES,
          "microbatches": PIPE_MOE_MICRO, "batch": MOE_BATCH,
          "seq": MOE_SEQ, "runs": moe_runs,
          "launches_per_step": {k: counts[f"moe_{k}"] for k in moe_runs},
          "first_loss_gap": abs(f1b[0] - gp[0])})
    check(all(math.isfinite(v) for v in f1b + gp), f"MoE losses {f1b} {gp}")
    check(f1b[-1] < f1b[0], f"MoE 1f1b: the loss did not fall: {f1b}")
    check(abs(f1b[0] - gp[0]) <= PIPE_MOE_SCHEDULE_TOL,
          f"MoE 1f1b's first loss {f1b[0]} against gpipe's {gp[0]}")

    emit({"phase": "pipeline_virtual_summary", "preset": "llama3-1b",
          "layers": n, "stages": PIPE_STAGES, "microbatches": m,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "tol": {"loss_rel": PIPE_LOSS_REL,
                  "grad_rel_norm_vs_microbatched": GRAD_REL,
                  "grad_max_frac": GRAD_MAX_FRAC,
                  "grad_rel_norm_vs_batch": TRAIN_GRAD_REL},
          "single_device": single,
          "step_s_vs_single": {
              k: r["median_step_s"] / single["median_step_s"]
              for k, r in runs.items()},
          "peak_mem_gib": {**{k: r["peak_mem_gib"]
                              for k, r in runs.items()},
                           "single_device": single["peak_mem_gib"]},
          "phase_s": time.perf_counter() - t_phase,
          "meaning": "the stages run one after another in one process, so "
                     "there is no bubble to see and no hop to pay; the gap "
                     "to the single-device step is the cost of six "
                     "microbatches (GEMMs at a sixth of the rows, the "
                     "gradients summed per unit in f32) and of the "
                     "executor"})
    return counts


def phase_probe(smi: str) -> None:
    """The port's CUDA device probe (``topology.from_runtime``): the
    card's name as ``nvidia-smi`` gives it, every visible device, a flat
    mesh."""
    from tpu_network_operator_torch import topology

    topo = topology.from_runtime()
    count = torch.cuda.device_count()
    smi_name = smi.split(",")[0].strip()
    emit({"phase": "probe", "topology": topo.to_dict(),
          "nvidia_smi_name": smi_name, "device_count": count})
    check(topo.accelerator_type == smi_name,
          f"the probe names the card {topo.accelerator_type!r}, nvidia-smi "
          f"{smi_name!r}")
    check(topo.num_chips == count,
          f"the probe found {topo.num_chips} devices, torch {count}")
    check(topo.ici_mesh == (count,) and topo.source == "cuda",
          f"the probe's mesh is {topo.ici_mesh} from {topo.source}")


def phase_entry() -> dict:
    """``graft.entry()``: the flagship forward at compile-check size on
    the card, logits [2, 128, 32000] finite, with the flash forward and
    RMSNorm forward launches of one call (8 and 17)."""
    from tpu_network_operator_torch import graft

    fn, args = graft.entry()
    logits, launches = kernel_launches_of(lambda: fn(*args))
    cfg = fn.keywords["cfg"]
    emit({"phase": "entry", "config": dataclasses.asdict(cfg) | {
              "dtype": str(cfg.dtype)},
          "params": cfg.num_params(), "logits": list(logits.shape),
          "finite": bool(torch.isfinite(logits).all()),
          "forward_ms": time_ms_eager(lambda: fn(*args)),
          "launches": launches})
    check(list(logits.shape) == [2, 128, cfg.vocab_size],
          f"entry() gave logits {list(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "entry() logits not finite")
    check(launches["flash_fwd"] == cfg.layers
          and launches["rms_norm_fwd"] == 2 * cfg.layers + 1,
          f"entry()'s forward launched {launches}")
    del logits, args
    return launches


def phase_dryrun_world1() -> dict:
    """``graft.dryrun_multichip(1)``: every section's two train steps
    through a world-1 NCCL mesh, each section's losses, seconds and
    launches; kernel 6 in sections 1 and 1b, kernels 1 to 5 in 1b, 1b's
    kernels' two steps on random tokens within 5e-2 of the plain steps on
    the CPU; ``dryrun_multichip(2)`` refused on a one-card machine."""
    from tpu_network_operator_torch import graft

    t0 = time.perf_counter()
    result = graft.dryrun_multichip(1)
    seconds = time.perf_counter() - t0
    sections = result["sections"]
    count = torch.cuda.device_count()
    refusal = None
    if count == 1:
        try:
            graft.dryrun_multichip(2)
        except RuntimeError as e:
            refusal = str(e)
    emit({"phase": "dryrun_world1", "seconds": seconds,
          "sections": sections, "lines": result["lines"],
          "refusal_at_2": refusal})
    check(result["lines"][-1] == graft.OK_LINE,
          f"the dry run ended with {result['lines'][-1]!r}")
    check(set(sections) == {"1", "1b", "2", "3"},
          f"the dry run at a world of one ran {sorted(sections)}")
    for section, res in sections.items():
        for key in ("loss", "next_loss"):
            check(math.isfinite(res[key]) and 0 < res[key] < 20,
                  f"dry-run section {section}'s {key} is {res[key]}")
    for section in ("1", "1b"):
        check(sections[section]["launches"]["adam8_fused"] > 0,
              f"kernel 6 did not launch in dry-run section {section}")
    check(all(n > 0 for n in sections["1b"]["launches"].values()),
          f"section 1b launched {sections['1b']['launches']}")
    check(sections["1b"]["drift"] < graft.DRIFT_TOL,
          f"section 1b's kernels drift {sections['1b']['drift']} from the "
          f"plain steps on the CPU: {sections['1b']['drift_losses']}")
    if count == 1:
        check(refusal is not None and "needs 2 CUDA devices" in refusal,
              f"dryrun_multichip(2) on one card: {refusal!r}")
    return {f"dryrun_world1_section_{k}": v["launches"]
            for k, v in sections.items()}


def decomp_cfg() -> LlamaConfig:
    return dataclasses.replace(LlamaConfig.llama3_1b(),
                               xent_chunk=DECOMP_CHUNK, remat_policy="full")


def phase_perf_decomp() -> dict:
    """``measure.decompose`` at tools/perf_decomp.py's defaults, then
    ``measure.measure`` at the same shape: the step's loss finite, its
    seconds within DECOMP_STEP_REL of measure()'s."""
    cfg = decomp_cfg()
    _kernels.reset_launches()
    out = measure.decompose(cfg, DECOMP_BATCH, DECOMP_SEQ, DECOMP_ITERS,
                            "cuda", name="llama3-1b")
    launches = dict(_kernels.LAUNCHES)
    torch.cuda.empty_cache()
    row = measure.measure("llama3-1b/full/adamw/b4", cfg, DECOMP_BATCH,
                          DECOMP_SEQ, "cuda", iters=DECOMP_ITERS,
                          log=lambda msg: print(msg, file=sys.stderr,
                                                flush=True))
    measured = DECOMP_BATCH * DECOMP_SEQ / row["tokens_per_sec_per_chip"]
    rel = abs(out["seconds"]["step"] - measured) / measured
    emit({"phase": "perf_decomp", **out, "measure_row": row,
          "measure_step_s": measured, "step_vs_measure_rel": rel,
          "launches": launches})
    check(math.isfinite(out["loss"]), f"the step's loss is {out['loss']}")
    check(rel <= DECOMP_STEP_REL,
          f"decompose's step {out['seconds']['step']} s and measure()'s "
          f"{measured} s differ by {rel:.3f}")
    torch.cuda.empty_cache()
    return launches


def phase_remat_search(batches) -> dict:
    """``measure.remat_search`` of llama3-1b over the five policies x
    adam8 / adamw at ``batches``: every row that ran has a loss in (0,
    20), at least one row per optimizer ran; rows that ran out of device
    memory are reported as failed."""
    out_path = SCRATCH / "remat_search.jsonl"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out_path.unlink(missing_ok=True)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = measure.remat_search(
        LlamaConfig.llama3_1b(), "llama3-1b", batches, SWEEP_OPTS, 2048,
        DECOMP_CHUNK, "cuda", str(out_path),
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    launches = dict(_kernels.LAUNCHES)
    written = len(out_path.read_text().splitlines())
    out_path.unlink()
    emit({"phase": "remat_search", "batches": list(batches),
          "seconds": time.perf_counter() - t0, "rows": res["rows"],
          "skipped": res["skipped"], "failed": res["failed"],
          "best": {k: v for k, v in res["best"].items() if k != "rows"},
          "rows_written": written,
          "budget_bytes": measure.device_bytes("cuda"),
          "launches": launches})
    for row in res["rows"]:
        check(0 < row["loss"] < 20, f"{row['config']}: loss {row['loss']}")
    for opt in SWEEP_OPTS:
        check(any(f"/{opt}/" in row["config"] for row in res["rows"]),
              f"no {opt} row of the sweep ran")
    check(written == len(res["rows"]),
          f"{written} rows written for {len(res['rows'])} run")
    torch.cuda.empty_cache()
    return launches


def phase_table(name: str, launches: dict, train_launches: dict,
                adam8: dict, moe_runs: dict, more_launches: dict,
                ring_runs: dict, mesh_adam8: dict, virtual: dict):
    bw, bf16_peak, f32_peak = measure.peaks(name)
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    cfg = LlamaConfig.llama3_1b()
    h, hkv, d = cfg.heads, cfg.kv_heads, cfg.head_dim
    tb, ts = TRAIN_BATCH, TRAIN_SEQ
    moe_launches = moe_runs["launches_per_step"]
    moe_geom = moe_runs["attention"]     # [B, S, H, Hkv, D]: D 128

    def rms_entry(n_rows):
        x, s = _rms_case((n_rows, cfg.hidden), gen)
        y, _ = norms.fused_rms_norm(x, s, cfg.rms_eps)
        ref = norms._rms_norm_plain(x, s, cfg.rms_eps)
        check(torch.allclose(y.float(), ref.float(), **RMS_TOL),
              f"rms_norm_fwd disagrees with its plain version at {n_rows} rows")
        nbytes = 2 * x.numel() * 2 + s.numel() * 2 + n_rows * 4
        return {
            "shape": [n_rows, cfg.hidden],
            "max_abs_err": max_err(y, ref),
            "ms": time_ms(lambda: norms.fused_rms_norm(x, s, cfg.rms_eps)),
            "plain_ms": time_ms(
                lambda: norms._rms_norm_plain(x, s, cfg.rms_eps)),
            **_bound(nbytes, 4 * x.numel(), bw, f32_peak),
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (cfg.hidden,), s, cfg.rms_eps)),
        }

    # -- RMSNorm forward: prefill and decode (serving), and the train shape
    rows = [{
        "name": "rms_norm_fwd", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/rms_norm_fwd.cu",
        "replaces": "tpu_network_operator/ops/norms.py:91",
        "design": DESIGN["rms_norm_fwd"],
        "launches": launches["rms_norm_fwd"],
        **rms_entry(BATCH * PROMPT), "decode": rms_entry(BATCH),
        "train": {**rms_entry(tb * ts),
                  "launches": train_launches["rms_norm_fwd"]},
        # the MoE cell's rows are the prefill shape's, 8192 x 2048
        "train_moe": {"shape": [MOE_BATCH * MOE_SEQ, cfg.hidden],
                      "launches": moe_launches["rms_norm_fwd"]},
    }]

    # -- RMSNorm backward at the train shape
    x, s = _rms_case((tb * ts, cfg.hidden), gen)
    dy = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
    _, rstd = norms.fused_rms_norm(x, s, cfg.rms_eps)
    dx, ds = norms.rms_norm_bwd(x, s, rstd, dy)
    rdx, rds = norms._rms_norm_bwd_plain(x, s, rstd, dy)
    check(torch.allclose(dx.float(), rdx.float(), **RMS_TOL),
          "rms_norm_bwd disagrees with its plain version at the train shape")
    xr, sr = x.detach().requires_grad_(), s.detach().requires_grad_()

    def lib_fwd():
        return torch.nn.functional.rms_norm(xr, (cfg.hidden,), sr,
                                            cfg.rms_eps)

    # x, dy and dx once each, rstd, scale and dscale; ~10 f32 flops each
    nbytes = 3 * x.numel() * 2 + x.shape[0] * 4 + 2 * s.numel() * 2
    rows.append({
        "name": "rms_norm_bwd", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/rms_norm_bwd.cu",
        "replaces": "tpu_network_operator/ops/norms.py:103",
        "launches": train_launches["rms_norm_bwd"],
        "shape": list(x.shape), "max_abs_err": max_err(dx, rdx),
        "max_abs_err_dscale": max_err(ds, rds),
        "ms": time_ms(lambda: norms.rms_norm_bwd(x, s, rstd, dy)),
        "plain_ms": time_ms(lambda: norms._rms_norm_bwd_plain(x, s, rstd, dy)),
        **_bound(nbytes, 10 * x.numel(), bw, f32_peak),
        # F.rms_norm forward + backward, minus its forward
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lib_fwd(), (xr, sr), dy)) - time_ms(lib_fwd),
        "train_moe": {"launches": moe_launches["rms_norm_bwd"]},
    })
    del x, dy, dx, rdx, xr, sr

    # -- the ring's chunk calls, and their launches in the ring phase
    chunks = ring_chunk_entries(gen, bw, bf16_peak)
    for kernel, entries in chunks.items():
        entries["launches"] = {geom: counts[kernel]
                               for geom, counts in ring_runs.items()}

    # -- flash forward: the prefill shape (serving), the train shape and
    # the MoE cell's (head_dim 128)
    rows.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tpu_network_operator/ops/pallas_attention.py:67",
        "design": DESIGN["flash_fwd"],
        "launches": launches["flash_fwd"],
        **flash_fwd_entry(gen, BATCH, PROMPT, h, hkv, d, 3, bw, bf16_peak),
        "train": {**flash_fwd_entry(gen, tb, ts, h, hkv, d, 1, bw,
                                    bf16_peak),
                  "launches": train_launches["flash_fwd"]},
        "train_moe_d128": {**flash_fwd_entry(gen, *moe_geom, 1, bw,
                                             bf16_peak),
                           "launches": moe_launches["flash_fwd"]},
        "ring_chunk": chunks["flash_fwd"],
    })

    # -- flash backward at the train shape and the MoE cell's
    dq, dkv = flash_bwd_entries(gen, tb, ts, h, hkv, d, bw, bf16_peak)
    moe_dq, moe_dkv = flash_bwd_entries(gen, *moe_geom, bw, bf16_peak)
    rows.append({
        "name": "flash_bwd_dq", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/flash_bwd.cu",
        "replaces": "tpu_network_operator/ops/pallas_attention.py:158",
        "design": DESIGN["flash_bwd_dq"],
        "launches": train_launches["flash_bwd_dq"], **dq,
        "train_moe_d128": {**moe_dq,
                           "launches": moe_launches["flash_bwd_dq"]},
        "ring_chunk": chunks["flash_bwd_dq"],
    })
    rows.append({
        "name": "flash_bwd_dkv", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "tpu_network_operator/ops/pallas_attention.py:204",
        "design": DESIGN["flash_bwd_dkv"],
        "launches": train_launches["flash_bwd_dkv"], **dkv,
        "train_moe_d128": {**moe_dkv,
                           "launches": moe_launches["flash_bwd_dkv"]},
        "ring_chunk": chunks["flash_bwd_dkv"],
    })

    # -- 8-bit AdamW: the largest leaf (embed and lm_head) as a one-leaf
    # table, moments non-zero from one step, each timed call stepping the
    # state in place; then the 12 llama3-1b leaves, each alone and all in
    # one launch; and the launches of the adam8 cell's profiled step
    leaves = adam8_leaf_times(name)
    opt = optim8bit.adamw8bit(A8_LR, weight_decay=A8_WD)
    shape = (cfg.vocab_size, cfg.hidden)
    p = (torch.randn(shape, device="cuda", generator=gen) * 0.1).bfloat16()
    g = adam8_grad(shape, "random", gen)
    _, m, v = _a8_leaf(p)
    optim8bit.adam8_fused([(p, g, m, v)], opt.consts(1))
    p2 = p.clone()
    m2, v2 = (optim8bit.QTensor(t.q.clone(), t.scale.clone()) for t in (m, v))
    kc = opt.consts(2)
    optim8bit.adam8_fused([(p, g, m, v)], kc)
    optim8bit.adam8_plain([(p2, g, m2, v2)], kc)
    check(all(torch.equal(bits(a), bits(b)) for a, b in
              zip(_a8_out((p, m, v)), _a8_out((p2, m2, v2)))),
          "adam8_fused disagrees with its plain version at the largest leaf")
    in_step = adam8["adam8_per_step"]
    rows.append({
        "name": "adam8_fused", "route": "cuda",
        "source": "tpu_network_operator_torch/ops/csrc/adam8_fused.cu",
        "replaces": "tpu_network_operator/models/optim8bit.py:167",
        "design": DESIGN["adam8_fused"],
        "launches": adam8["launches_per_step"]["adam8_fused"],
        "shape": list(shape), "max_abs_err": max_err(p, p2),
        "ms": time_ms(lambda: optim8bit.adam8_fused([(p, g, m, v)], kc)),
        "plain_ms": time_ms_eager(
            lambda: optim8bit.adam8_plain([(p2, g, m2, v2)], kc),
            iters=3, reps=3),
        **_bound(adam8_bytes(p), ADAM8_OPS * p.numel(), bw, f32_peak),
        "library_ms": None,
        "library": "none: no PyTorch call computes block-quantized 8-bit "
                   "AdamW",
        "llama3_1b_leaves": {
            "one_launch_each_ms": leaves["sum_apply_ms"],
            "one_launch_ms": leaves["whole_tree_apply_ms"],
            "one_launch_launches": leaves["whole_tree_launches"],
            "bound_ms": leaves["bound_ms"], "bound_by": "bytes",
            "per_leaf": leaves["leaves"],
            "add_pass_ms": leaves["sum_add_ms"]},
        "in_step": {"device_ms": in_step["device_ms"],
                    "launches": in_step["launches"],
                    "bound_ms": in_step["bound_ms"], "bound_by": "bytes"},
        "train_moe_adam8": {
            "shape": "the 13 MoEConfig.small leaves, one launch, in the step",
            "launches": moe_runs["adam8_launches_per_step"]["adam8_fused"],
            "ms": moe_runs["adam8_in_step_ms"],
            "bound_ms": moe_runs["adam8_bound_ms"], "bound_by": "bytes"},
        # on the mesh: in the world-1 mesh's step, and each virtual rank's
        # one launch over its shards and gathered rows
        "mesh_world1_adam8": {
            tree: {"launches": run["launches"]["adam8_fused"],
                   "ms_in_step": run["adam8_fused_ms_in_step"],
                   "single_device_ms_in_step":
                       run["single_device_adam8_fused_ms_in_step"]}
            for tree, run in mesh_adam8.items()},
        "virtual_shards": {
            mesh_name: {"launches": run["launches"]["adam8_fused"],
                        "per_rank": run["per_rank"], "bound_by": "bytes"}
            for mesh_name, run in virtual.items()},
    })
    # each kernel's launches in the import, convert -> train and offload
    # paths, each read just after its own run
    for row in rows:
        row["launches_in"] = {path: counts[row["name"]]
                              for path, counts in more_launches.items()}
    emit({"kernels": rows})


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--adam8-leaves", action="store_true",
                      help="only time the 8-bit AdamW update at the "
                           "llama3-1b leaves (phase_adam8_leaves)")
    args.add_argument("--remat-ffn", action="store_true",
                      help="only profile the llama3-1b+ffn+adam8 step and "
                           "count its layers' backward matmuls "
                           "(phase_remat_ffn)")
    args.add_argument("--collectives", action="store_true",
                      help="only the collectives at a world of one "
                           "(phase_collectives_world1, "
                           "phase_exec_bench_world1) in a fresh process")
    args.add_argument("--pipeline", action="store_true",
                      help="only build the kernels and run the pipeline "
                           "over virtual stages (phase_pipeline_virtual)")
    args.add_argument("--remat-search", action="store_true",
                      help="only build the kernels and run the remat sweep "
                           "at tools/remat_search.py's batches 4 and 8 "
                           "(phase_remat_search)")
    args = args.parse_args(argv)
    name, smi = phase_device()
    if args.collectives:
        phase_collectives_world1()
        phase_exec_bench_world1()
        print(smi, flush=True)
        return 0
    phase_build()
    if args.pipeline:
        phase_pipeline_virtual()
        print(smi, flush=True)
        return 0
    if args.remat_search:
        phase_remat_search(SWEEP_FULL_BATCHES)
        print(smi, flush=True)
        return 0
    if args.adam8_leaves or args.remat_ffn:
        if args.adam8_leaves:
            phase_adam8_leaves(name)
        if args.remat_ffn:
            phase_remat_ffn()
        print(smi, flush=True)
        return 0
    phase_kernels()
    phase_kernels_bwd()
    phase_kernels_adam8()
    launches = phase_generate()
    phase_card_vs_cpu()
    train_launches = phase_train()
    phase_train_card_vs_cpu()
    adam8 = phase_train_adam8(name)
    phase_checkpoint()
    moe_runs = phase_train_moe(name)
    phase_train_moe_card_vs_cpu()
    imported = phase_import_llama()
    more_launches = {
        "import_llama_generate": imported["generate"],
        "import_llama_train_2_steps": imported["train"],
        "convert_train_llama_3_steps": phase_convert_train("llama"),
        "convert_train_mixtral_3_steps": phase_convert_train("mixtral"),
        "remat_ffn_offload_step": phase_remat_ffn_offload(),
    }
    mesh = phase_mesh_world1()
    more_launches["mesh_world1_train_step"] = mesh["train"]
    more_launches["mesh_world1_generate"] = mesh["generate"]
    ring_runs = phase_ring_virtual()
    for geom, counts in ring_runs.items():
        more_launches[f"ring_virtual_{geom}_fwd_bwd"] = counts
    more_launches["mesh_world1_moe_train_step"] = phase_mesh_world1_moe()
    for n, counts in phase_expert_virtual().items():
        more_launches[f"expert_virtual_{n}_shards"] = counts
    more_launches["init_shards_mixtral_2_ranks"] = phase_init_shards()
    mesh_adam8 = phase_mesh_world1_adam8()
    for tree, run in mesh_adam8.items():
        more_launches[f"mesh_world1_adam8_{tree}_step"] = run["launches"]
    virtual = phase_adam8_virtual_shards(name)
    for mesh_name, run in virtual.items():
        more_launches[f"adam8_virtual_shards_{mesh_name}_step"] = \
            run["launches"]
    more_launches["checkpoint_mesh_resumed_step"] = phase_checkpoint_mesh()
    more_launches["collectives_world1"] = phase_collectives_world1()
    more_launches["exec_bench_world1"] = phase_exec_bench_world1()
    for run, counts in phase_pipeline_virtual().items():
        more_launches[f"pipeline_virtual_{run}_step"] = counts
    phase_probe(smi)
    more_launches["entry_forward"] = phase_entry()
    more_launches.update(phase_dryrun_world1())
    more_launches["perf_decomp_stages"] = phase_perf_decomp()
    more_launches["remat_search_sweep"] = phase_remat_search(SWEEP_BATCHES)
    phase_table(name, launches, train_launches, adam8, moe_runs,
                more_launches, ring_runs, mesh_adam8, virtual)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
