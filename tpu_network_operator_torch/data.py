"""Input pipeline: a flat token stream to batches on the device.

The port's own copy of ``tpu_network_operator/data.py`` (which it may not
import): the numpy token sources and :func:`local_batches` are the
reference's, unchanged, so both packages draw the same batches from the
same file and seed; :func:`device_batches` puts one process's rows on its
device, and :func:`sharded_batches` is the counterpart of the reference's
``sharded_batches`` on a mesh of one process per GPU.

* batches are built host-side in numpy from a flat token stream: a
  memory-mapped ``.bin`` file of uint16/uint32 token ids (the
  llama.cpp/nanoGPT convention) or a synthetic stream for benchmarks;
* **deterministic + resumable**: batch ``i`` of a given (seed, config) is
  a pure function of ``i``, so resuming from checkpoint step N means
  "start the iterator at N", with no iterator state to checkpoint;
* a one-deep device prefetch overlaps host batch assembly with device
  compute.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from . import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int                       # GLOBAL batch size
    seq_len: int                     # tokens per example (yields S+1 ids)
    seed: int = 0


def _mix64(x: np.ndarray) -> np.ndarray:
    """64-bit avalanche mix (splitmix64 finalizer) over a uint64 array."""
    x = x * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return x


class TokenSource:
    """A flat stream of token ids addressable by (index) -> window."""

    def __len__(self) -> int:                        # total tokens
        raise NotImplementedError

    def window(self, start: int, length: int) -> np.ndarray:
        raise NotImplementedError


class MemmapTokens(TokenSource):
    """Memory-mapped flat binary of little-endian token ids.

    ``dtype`` is inferred from ``vocab_size`` when given (uint16 for
    vocabs <= 65536) or passed explicitly, matching the nanoGPT-style
    ``.bin`` convention.
    """

    def __init__(self, path: str, dtype=None, vocab_size: Optional[int] = None):
        if dtype is None:
            dtype = np.uint16 if (vocab_size or 1 << 17) <= (1 << 16) else np.uint32
        self._arr = np.memmap(path, dtype=dtype, mode="r")
        if len(self._arr) == 0:
            raise ValueError(f"empty token file: {path}")
        if vocab_size is not None:
            # cheap sample check catches dtype/vocab mismatches (a uint16
            # file read as uint32 or vice versa trains silently on garbage)
            probe = np.asarray(
                self._arr[: min(len(self._arr), 1 << 16)]
            )
            hi = int(probe.max())
            if hi >= vocab_size:
                raise ValueError(
                    f"token file {path}: max id {hi} >= vocab_size "
                    f"{vocab_size} — wrong dtype ({np.dtype(dtype).name}?) "
                    "or wrong model preset"
                )

    def __len__(self) -> int:
        return len(self._arr)

    def window(self, start: int, length: int) -> np.ndarray:
        return np.asarray(self._arr[start:start + length], dtype=np.int32)


class SyntheticTokens(TokenSource):
    """Deterministic pseudo-random tokens (benchmarks, tests)."""

    def __init__(self, vocab_size: int, total: int = 1 << 24, seed: int = 0):
        self._vocab = vocab_size
        self._total = total
        self._seed = seed

    def __len__(self) -> int:
        return self._total

    def window(self, start: int, length: int) -> np.ndarray:
        # stateless: value at position i depends only on (seed, i)
        idx = (start + np.arange(length, dtype=np.uint64)) + (
            np.uint64(self._seed) << np.uint64(32)
        )
        return (_mix64(idx) % np.uint64(self._vocab)).astype(np.int32)


def _batch_positions(
    n_tokens: int, cfg: DataConfig, step: int, rng_mix: int = 0x9E3779B9
) -> np.ndarray:
    """Start offsets of the global batch at ``step``: a pure function of
    (cfg.seed, step), spread pseudo-randomly over the stream."""
    span = cfg.seq_len + 1
    max_start = n_tokens - span
    if max_start < 0:
        raise ValueError(
            f"dataset of {n_tokens} tokens shorter than seq_len+1={span}"
        )
    # 64-bit wraparound mixing in Python ints (numpy scalar uint64 ops
    # warn on the intended overflow)
    mask = (1 << 64) - 1
    base = ((cfg.seed * 0x100000001B3 + step) * rng_mix) & mask
    idx = np.arange(cfg.batch, dtype=np.uint64) + np.uint64(base)
    return (_mix64(idx) % np.uint64(max_start + 1)).astype(np.int64)


def local_batches(
    source: TokenSource,
    cfg: DataConfig,
    *,
    start_step: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    microbatches: int = 1,
) -> Iterator[np.ndarray]:
    """Yields this process's shard of each global batch:
    ``[batch/process_count, seq_len+1]`` int32, forever.

    Deterministic in (cfg, step): every process computes the same global
    offsets and slices its own contiguous row range, so shards are
    disjoint and the union is the global batch.  With ``microbatches``
    M > 1 (the pipeline's), the batch is M contiguous microbatches and the
    process takes its contiguous share of each, microbatch after
    microbatch.
    """
    # validate at construction, not first next(): config errors should
    # point at the call site, before model init has run
    if cfg.batch % (process_count * microbatches):
        raise ValueError(
            f"global batch {cfg.batch} not divisible by "
            f"process_count {process_count} x microbatches {microbatches}"
        )
    span = cfg.seq_len + 1
    if len(source) - span < 0:
        raise ValueError(
            f"dataset of {len(source)} tokens shorter than seq_len+1={span}"
        )
    per = cfg.batch // (process_count * microbatches)
    rows = np.concatenate([
        np.arange(per) + m * (cfg.batch // microbatches) + process_index * per
        for m in range(microbatches)])

    def gen():
        step = start_step
        while True:
            starts = _batch_positions(len(source), cfg, step)[rows]
            yield np.stack([source.window(int(s), span) for s in starts])
            step += 1

    return gen()


def device_batches(
    source: TokenSource,
    cfg: DataConfig,
    device=None,
    *,
    start_step: int = 0,
    prefetch: int = 1,
    process_index: int = 0,
    process_count: int = 1,
    microbatches: int = 1,
) -> Iterator[torch.Tensor]:
    """Yields the batches of :func:`local_batches` (this process's rows,
    ``[batch/process_count, seq_len+1]``) as int32 tensors on ``device``
    (None means CUDA), ``prefetch`` batches ahead.

    On CUDA each batch is copied from a pinned host tensor of its own with
    ``non_blocking=True``: a pinned buffer refilled while its copy is in
    flight would hand the device the next batch's tokens, so no buffer is
    reused (the caching host allocator holds a freed one back until its
    copy has finished)."""
    dev = resolve_device(device)
    it = local_batches(source, cfg, start_step=start_step,  # validates now
                       process_index=process_index,
                       process_count=process_count,
                       microbatches=microbatches)

    def put(local: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(local)
        if dev.type != "cuda":
            return host.to(dev)
        return host.pin_memory().to(dev, non_blocking=True)

    def gen():
        buf = collections.deque()
        for _ in range(max(prefetch, 0)):
            buf.append(put(next(it)))
        while True:
            buf.append(put(next(it)))
            yield buf.popleft()

    return gen()


def sharded_batches(
    source: TokenSource,
    cfg: DataConfig,
    mesh,
    *,
    start_step: int = 0,
    prefetch: int = 1,
    microbatches: int = 1,
) -> Iterator[torch.Tensor]:
    """This rank's rows of each global batch on its device: the batch is
    sharded over data x fsdp (the reference's ``P(("data", "fsdp"),
    None)``), so the rank's coordinate there is its ``process_index`` in
    :func:`local_batches`, and every rank of one batch shard (along
    ``seq``, ``tensor`` and ``pipe``) draws the same rows.  The
    pipeline's ``microbatches``: the rank's share of each microbatch
    (``parallel.pipeline.microbatch_rows``)."""
    return device_batches(
        source, cfg, mesh.device, start_step=start_step, prefetch=prefetch,
        process_index=mesh.index("data", "fsdp"),
        process_count=mesh.size("data", "fsdp"), microbatches=microbatches)
