"""Pipeline parallelism over the stacked-layer axis (the ``pipe`` mesh
axis): the GPipe, 1F1B and interleaved 1F1B schedules, for the dense
Llama and the MoE, composed with data / fsdp / tensor / expert and with
ring sequence parallelism inside each stage.

Counterpart of ``tpu_network_operator/parallel/pipeline.py``.  The
reference runs every pipe rank through one masked program inside
``shard_map``; here each pipe rank is its own process, so one executor
drives every schedule from host-side tick tables:

* the tables say which (microbatch, chunk) each stage forwards and
  backwards at each tick: :func:`_1f1b_tables` (the reference's, copied)
  for "1f1b" and "interleaved", :func:`_gpipe_tables` for "gpipe" (M
  forwards, then M backwards in reverse order);
* a stage with no unit at a tick skips it.  Every process group a unit
  uses (tensor, fsdp, data, seq, expert) joins ranks of one pipe
  coordinate, which follow one schedule row, so the skip is legal where
  the reference has to mask (its masked garbage adds zero);
* a forward unit runs one chunk of the stage's layers on the input banked
  under (chunk, microbatch), and on the last virtual stage also the final
  norm, ``lm_head`` and that microbatch's cross entropy.  It keeps its
  autograd graph until its backward unit (where the reference recomputes
  under ``jax.vjp``), so GPipe holds M graphs a stage and 1F1B at most its
  in-flight cap V - vs;
* a backward unit seeds from the loss on the last virtual stage, else
  from the banked cotangent, and adds the MoE's router aux term on every
  unit;
* the wire is tick-synchronous: each tick every stage sends its forward
  output to the right and its input cotangent to the left (zeros when
  idle), and banks what arrives by the neighbour's previous schedule row
  into ring buffers of depth ``min(V + 1, M)``; a hop across the chunk
  boundary (stage S-1 to 0) banks under the next chunk.

The wire has two implementations: :class:`PipeWire`, one ring hop pair a
tick on the pipe axis's own process group, and :class:`InProcessWire`, S
stages held in one process (one card) handing tensors to each other.  The
executor is the same for both.

Stored layout: "gpipe" and "1f1b" keep the flat ``[L, ...]`` layer leaves
sharded over ``pipe`` on axis 0 (their checkpoints interchange), and
"interleaved" stores ``[v, L/v, ...]`` sharded over ``pipe`` on axis 1,
so chunk c of stage r holds layers ``c*S*per + r*per + k`` and executing
the virtual stages in order is the canonical layer order.

The loss is the global token mean of the cross entropy, plus for the MoE
``router_aux_weight`` times the mean router aux over (layer, microbatch,
seq shard), the reference's microbatched estimator on every schedule.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from . import comm

# the leaves outside the layer stack: whole on every stage, used by the
# first virtual stage (embed) or the last (ln_final, lm_head)
SHARED = ("embed", "ln_final", "lm_head")


# -- the schedules --------------------------------------------------------------


def _1f1b_tables(n_stages: int, n_micro: int, v: int = 1):
    """Host-side list-scheduled 1F1B (PipeDream-flush) tick tables, with
    optional virtual-stage interleaving (Megatron-style).

    The pipeline has ``V = S*v`` *virtual* stages; virtual stage
    ``vs = c*S + r`` is model chunk ``c`` on device ``r``, so activations
    always hop to the right neighbour (chunk boundaries wrap rank
    ``S-1 → 0``).  Returns four ``[T, S]`` int32 arrays:
    ``(fwd_mb, fwd_ck, bwd_mb, bwd_ck)`` — the microbatch and chunk each
    device forwards / backwards at each tick (mb -1 = idle; the chunk
    entry is then meaningless).  One forward unit and one backward unit
    per device per tick; backward prefers the DEEPEST ready chunk
    (drains toward the loss), forwards are capped at ``V - vs`` in
    flight per virtual stage — the 1F1B memory bound (live stage inputs
    stay O(V) instead of GPipe's M).  Interleaving divides the
    fill/drain bubble by ``v``: each device's chunks give it work while
    its deeper neighbours fill.
    """
    S, M, V = n_stages, n_micro, n_stages * v
    tf = [[-1] * M for _ in range(V)]     # tick vs forwarded mb
    tb = [[-1] * M for _ in range(V)]
    nf, nb = [0] * V, [0] * V             # next fwd/bwd mb per vs
    rows = []
    t = 0
    while any(x < M for x in nb):
        if t > 4 * v * (M + V) + 8:       # pragma: no cover — safety net
            raise RuntimeError("1f1b scheduler failed to converge")
        rf_mb, rf_ck = [-1] * S, [0] * S
        rb_mb, rb_ck = [-1] * S, [0] * S
        for r in range(S):
            # backward: deepest ready chunk first (retires before the
            # same tick's forward banks; the kernel runs bwd first)
            for c in range(v - 1, -1, -1):
                vs = c * S + r
                g = nb[vs]
                if (
                    g < M
                    and 0 <= tf[vs][g] < t   # own forward, earlier tick
                    and (vs == V - 1 or 0 <= tb[vs + 1][g] < t)
                ):
                    rb_mb[r], rb_ck[r] = g, c
                    tb[vs][g] = t
                    nb[vs] += 1
                    break
            # forward: deepest ready chunk first (reaches the loss stage
            # sooner, so backwards can start draining); the in-flight
            # cap is checked after the backward retires
            for c in range(v - 1, -1, -1):
                vs = c * S + r
                f = nf[vs]
                if (
                    f < M
                    and (vs == 0 or 0 <= tf[vs - 1][f] < t)
                    and (f - nb[vs]) < max(V - vs, 1)
                ):
                    rf_mb[r], rf_ck[r] = f, c
                    tf[vs][f] = t
                    nf[vs] += 1
                    break
        rows.append((rf_mb, rf_ck, rb_mb, rb_ck))
        t += 1
    arrs = tuple(
        np.asarray([row[i] for row in rows], np.int32) for i in range(4)
    )
    return arrs


def _gpipe_tables(n_stages: int, n_micro: int):
    """GPipe's fill-drain schedule in :func:`_1f1b_tables`' format: stage
    r forwards microbatch m at tick ``m + r``; once every forward is done,
    the last stage backwards M-1, M-2, ..., 0 and each stage follows its
    right neighbour one tick later (the order reverse-mode AD of the
    reference's forward scan gives).  One chunk a stage."""
    S, M = n_stages, n_micro
    tf = M + S - 1
    T = tf + M + S - 1
    fmb = np.full((T, S), -1, np.int32)
    bmb = np.full((T, S), -1, np.int32)
    for r in range(S):
        for m in range(M):
            fmb[m + r, r] = m
            bmb[tf + (M - 1 - m) + (S - 1 - r), r] = m
    zeros = np.zeros((T, S), np.int32)
    return fmb, zeros, bmb, zeros.copy()


def _parse_schedule(schedule: str, virtual_stages: int):
    """(use_1f1b, v): "gpipe" | "1f1b" | "interleaved" (1F1B with
    ``virtual_stages`` chunks per device; must be >= 2)."""
    if schedule == "gpipe":
        return False, 1
    if schedule == "1f1b":
        return True, 1
    if schedule == "interleaved":
        if virtual_stages < 2:
            raise ValueError(
                "schedule='interleaved' needs virtual_stages >= 2 "
                f"(got {virtual_stages})"
            )
        return True, virtual_stages
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


# -- layout ---------------------------------------------------------------------


def pipeline_specs(specs, v: int = 1):
    """The family's ``param_specs`` with the stacked-layer axis over
    ``pipe``: ``[L, ...]`` leaves cut on axis 0 (v 1), ``[v, L/v, ...]``
    leaves on axis 1 (interleaved)."""
    lead = ("pipe",) if v == 1 else (None, "pipe")
    return {**specs, "layers": {name: lead + tuple(spec)[1:]
                                for name, spec in specs["layers"].items()}}


def chunked_layers(params, v: int):
    """``params`` with its ``[L, ...]`` layer leaves viewed as the
    interleaved schedule's ``[v, L/v, ...]`` (unchanged for v 1)."""
    if v == 1:
        return params
    return {**params, "layers": {
        name: a.reshape((v, a.shape[0] // v) + tuple(a.shape[1:]))
        for name, a in params["layers"].items()}}


def microbatch_rows(tokens: torch.Tensor, mesh, n_micro: int) -> torch.Tensor:
    """This rank's rows of a global batch [B, S+1] for the pipeline: its
    share along data x fsdp of each of the ``n_micro`` microbatches
    (global rows ``m*B/M .. (m+1)*B/M``, the reference's microbatches),
    microbatch after microbatch.  The whole batch without a mesh."""
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by microbatches {n_micro}")
    if mesh is None:
        return tokens
    n = mesh.size("data", "fsdp")
    per = b // n_micro
    if per % n:
        raise ValueError(
            f"a microbatch of {per} rows does not shard over the {n} ranks "
            "of data x fsdp"
        )
    rows = tokens.reshape(n_micro, per, -1).chunk(n, dim=1)
    return rows[mesh.index("data", "fsdp")].reshape(b // n, -1)


# -- the wire -------------------------------------------------------------------


class InProcessWire:
    """S pipe stages held in one process: stage r's forward output goes to
    stage r+1 and its input cotangent to stage r-1 (mod S), as tensors."""

    def __init__(self, n_stages: int):
        self.n = n_stages

    def exchange(self, acts, grads):
        n = self.n
        return ([acts[(r - 1) % n] for r in range(n)],
                [grads[(r + 1) % n] for r in range(n)])


class PipeWire:
    """This rank's stage on a mesh: each tick one hop of the forward
    outputs to the next pipe rank and one of the cotangents to the
    previous one (:func:`.comm.ring_hop` on the pipe axis's group), every
    rank issuing the same hops in the same order; an idle unit sends
    zeros of ``shape``."""

    def __init__(self, mesh, shape, dtype):
        self.mesh = mesh
        self.n = mesh.size("pipe")
        self.zeros = torch.zeros(shape, dtype=dtype, device=mesh.device)

    def exchange(self, acts, grads):
        if self.n == 1:                      # a one-rank ring: itself
            return acts, grads
        group = self.mesh.group("pipe")
        nxt, prv = self.mesh.ring_peers("pipe")
        a = acts[0] if acts[0] is not None else self.zeros
        g = grads[0] if grads[0] is not None else self.zeros
        (a_in,) = comm.ring_hop([a], group, nxt, prv)
        (g_in,) = comm.ring_hop([g], group, prv, nxt)
        return [a_in], [g_in]


class _Bank:
    """Arrivals banked per (chunk, microbatch) in ring buffers of depth
    ``depth``; a slot is taken once, and a put over a slot still holding
    another microbatch is a schedule fault."""

    def __init__(self, v: int, depth: int):
        self.depth = depth
        self.slots = [[None] * depth for _ in range(v)]

    def put(self, c: int, mb: int, t: torch.Tensor) -> None:
        slot = self.slots[c][mb % self.depth]
        if slot is not None and slot[0] != mb:
            raise RuntimeError(
                f"pipeline bank slot of chunk {c} still holds microbatch "
                f"{slot[0]} when {mb} arrives")
        self.slots[c][mb % self.depth] = (mb, t)

    def take(self, c: int, mb: int) -> torch.Tensor:
        slot = self.slots[c][mb % self.depth]
        if slot is None or slot[0] != mb:
            raise RuntimeError(
                f"pipeline input of chunk {c}, microbatch {mb} never arrived")
        self.slots[c][mb % self.depth] = None
        return slot[1]


# -- one stage ------------------------------------------------------------------


class _Stage:
    """One pipe stage's units: its chunks' layer leaves (views of the
    stored leaves, each a leaf of its own for autograd) and f32 gradient
    accumulators (views of the accumulators of the stored leaves), the
    banks, and the forward units' graphs awaiting their backward."""

    def __init__(self, run, rank: int, local: int, n_local: int):
        self.run, self.rank = run, rank
        v = run.v
        self.vs = [c * run.n_stages + rank for c in range(v)]
        self.chunks, self.accs = [], []
        for c in range(v):
            leaves, accs = {}, {}
            for name, leaf in run.params["layers"].items():
                acc = run.acc["layers"][name]
                if v > 1:
                    leaf, acc = leaf[c], acc[c]
                per = leaf.shape[0] // n_local
                leaves[name] = leaf.detach().narrow(
                    0, local * per, per).requires_grad_()
                accs[name] = acc.narrow(0, local * per, per)
            self.chunks.append(leaves)
            self.accs.append(accs)
        self.abuf = _Bank(v, run.depth)
        self.gbuf = _Bank(v, run.depth)
        self.graphs: Dict[tuple, tuple] = {}
        self.max_live = 0

    def forward(self, c: int, m: int) -> torch.Tensor:
        from ..models.llama import unbind_layers

        run = self.run
        lay, cfg = run.layout, run.cfg
        tok = run.tokens[m]
        first, last = self.vs[c] == 0, self.vs[c] == run.V - 1
        with torch.enable_grad():
            if first:
                x_in = None
                x = torch.nn.functional.embedding(
                    tok[:, :-1], lay.whole(run.shared["embed"])).to(cfg.dtype)
            else:
                x_in = self.abuf.take(c, m).detach().requires_grad_()
                x = x_in
            block = run.block()
            aux = None
            for lp in unbind_layers({"layers": self.chunks[c]}):
                x, a = block(x, lp)
                if a is not None:
                    aux = a.float() if aux is None else aux + a.float()
            obj = None if aux is None else aux * run.aux_scale
            if last:
                ce = run.xent(x, tok) * run.loss_scale
                run.loss_acc += ce.detach()
                obj = ce if obj is None else ce + obj
            if aux is not None:
                run.loss_acc += (aux * run.aux_scale).detach()
        self.graphs[(c, m)] = (x_in, x, obj)
        self.max_live = max(self.max_live, len(self.graphs))
        return x.detach()

    def backward(self, c: int, m: int) -> Optional[torch.Tensor]:
        run = self.run
        x_in, y, obj = self.graphs.pop((c, m))
        vs = self.vs[c]
        if vs == run.V - 1:
            outs, seeds = [obj], [None]
        else:
            outs, seeds = [y], [self.gbuf.take(c, m)]
            if obj is not None:
                outs.append(obj)
                seeds.append(None)
        names = list(self.chunks[c])
        inputs = [self.chunks[c][n] for n in names]
        accs = [self.accs[c][n] for n in names]
        for key in SHARED:
            if vs == (0 if key == "embed" else run.V - 1):
                inputs.append(run.shared[key])
                accs.append(run.acc[key])
        if x_in is not None:
            inputs.append(x_in)
        grads = torch.autograd.grad(outs, inputs, seeds, allow_unused=True)
        for acc, g in zip(accs, grads):
            if g is not None:
                acc.add_(g)
        return grads[-1] if x_in is not None else None


def run_schedule(stages: List[_Stage], tables, wire, n_stages: int,
                 v: int) -> None:
    """Drive ``stages`` (the stages this process holds, by pipe rank)
    through ``tables``: each tick, bank the previous tick's arrivals,
    run each stage's backward unit and then its forward unit, and hand
    the outputs to ``wire``."""
    fmb, fck, bmb, bck = (t.tolist() for t in tables)
    S = n_stages
    n_local = len(stages)
    act_in = grad_in = [None] * n_local
    for t in range(len(fmb)):
        acts, grads = [None] * n_local, [None] * n_local
        for i, st in enumerate(stages):
            r = st.rank
            if t > 0:
                # the neighbour's previous row says what is on the wire; a
                # hop across the chunk boundary lands in the next chunk
                af = fmb[t - 1][(r - 1) % S]
                afc = fck[t - 1][(r - 1) % S] + (1 if r == 0 else 0)
                if af >= 0 and afc < v:
                    st.abuf.put(afc, af, act_in[i])
                ag = bmb[t - 1][(r + 1) % S]
                agc = bck[t - 1][(r + 1) % S] - (1 if r == S - 1 else 0)
                if ag >= 0 and agc >= 0:
                    st.gbuf.put(agc, ag, grad_in[i])
            if bmb[t][r] >= 0:
                grads[i] = st.backward(bck[t][r], bmb[t][r])
            if fmb[t][r] >= 0:
                acts[i] = st.forward(fck[t][r], fmb[t][r])
        if t < len(fmb) - 1:
            act_in, grad_in = wire.exchange(acts, grads)
    for st in stages:
        if st.graphs:
            raise RuntimeError(f"stage {st.rank} ended the schedule with "
                               f"{len(st.graphs)} units not backwarded")


# -- the step -------------------------------------------------------------------


class PipelineStep:
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``,
    the train step's contract, over the pipeline; ``tokens`` are this
    rank's rows (:func:`microbatch_rows`), the whole batch in one process.
    :meth:`grads_fn` gives (loss, grads) alone: the global loss and every
    leaf's gradient as the optimizer takes it (summed over the mesh, in
    the leaf's dtype).  ``stats`` holds the last call's peak count of
    live forward-unit graphs, per stage."""

    def __init__(self, cfg, mesh, n_micro: int, schedule: str,
                 virtual_stages: int, seq_axis, attn_fn, device,
                 n_stages: int, optimizer):
        from ..models import training
        from ..models.convert import model

        self.cfg, self.mesh, self.M = cfg, mesh, n_micro
        self.S = n_stages
        self.schedule = schedule
        self.use_1f1b, self.v = _parse_schedule(schedule, virtual_stages)
        self.tables = (_1f1b_tables(n_stages, n_micro, self.v)
                       if self.use_1f1b else _gpipe_tables(n_stages, n_micro))
        self.V = self.S * self.v
        if self.use_1f1b and cfg.layers % self.V:
            raise ValueError(
                f"layers {cfg.layers} not divisible by stages*virtual "
                f"{self.S}*{self.v}"
            )
        if not self.use_1f1b and cfg.layers % self.S:
            raise ValueError(
                f"layers {cfg.layers} not divisible by stages {self.S}")
        if seq_axis not in (None, "seq"):
            raise ValueError(f"seq_axis must be None or 'seq', got "
                             f"{seq_axis!r}")
        self.device = device
        # the family's layout of one stage (its pipe coordinate's sub-mesh)
        seq = mesh is not None and seq_axis is not None
        self.layout = model(cfg).Layout(cfg, mesh, None if seq else attn_fn,
                                        pipeline_stage=True, seq_parallel=seq)
        self.seq_size = mesh.size("seq") if seq else 1
        self.specs = pipeline_specs(self.layout.specs(), self.v)
        self.optimizer = training.resolve_optimizer(optimizer, mesh,
                                                    self.specs)
        self.stats: Dict[str, List[int]] = {}

    # -- the stage's pieces

    def _xent(self, shared, y, tok):
        from ..ops.norms import rms_norm

        z = rms_norm(y, shared["ln_final"], self.cfg.rms_eps)
        return self.layout.xent(shared["lm_head"], z, tok)

    # -- the entry points

    def grads_fn(self, params, tokens):
        """(global loss, grads tree in the params' dtypes)."""
        from ..models import training
        from ..models.llama import rope_tables

        cfg, lay, mesh, M = self.cfg, self.layout, self.mesh, self.M
        n_batch = 1 if mesh is None else mesh.size("data", "fsdp")
        b, s1 = tokens.shape
        if b % M:
            what = "microbatches" if self.use_1f1b else "n_microbatches"
            raise ValueError(f"batch {b * n_batch} not divisible by {what} "
                             f"{M}")
        s = s1 - 1
        if s % self.seq_size:
            raise ValueError(f"seq {s} not divisible by seq axis "
                             f"{self.seq_size}")
        self._rope = rope_tables(cfg, s, tokens.device)[0]
        micro = [lay.local_tokens(t) for t in tokens.reshape(M, b // M, s1)]
        acc = training.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        shared = {k: params[k].detach().requires_grad_() for k in SHARED}
        # the state of this call that its stages share
        run = SimpleNamespace(
            cfg=cfg, layout=lay, params=params, acc=acc, shared=shared,
            tokens=micro, n_stages=self.S, v=self.v, V=self.V,
            depth=min(self.V + 1, M),
            block=lambda: lay.block(*self._rope),
            xent=functools.partial(self._xent, shared),
            loss_scale=lay.loss_scale / M,
            aux_scale=lay.aux_weight * lay.loss_scale / (cfg.layers * M),
            loss_acc=torch.zeros((), dtype=torch.float32,
                                 device=tokens.device),
        )
        if mesh is None:
            stages = [_Stage(run, r, r, self.S) for r in range(self.S)]
            wire = InProcessWire(self.S)
        else:
            stages = [_Stage(run, mesh.coord["pipe"], 0, 1)]
            shape = (b // M, micro[0].shape[1] - 1, cfg.hidden)
            wire = PipeWire(mesh, shape, cfg.dtype)
        run_schedule(stages, self.tables, wire, self.S, self.v)
        self.stats = {"max_live_graphs": [st.max_live for st in stages]}

        grads = list(training.tree_leaves(acc))
        loss = run.loss_acc
        if mesh is not None:
            grads = lay.reduce_grads(params, grads)
            loss = comm.all_reduce(lay.reduce_loss(loss), mesh.group("pipe"))
            grads = self._sum_over_pipe(params, grads)
        leaves = list(training.tree_leaves(params))
        grads = [g.to(p.dtype) for g, p in zip(grads, leaves)]
        it = iter(grads)
        return loss, training.tree_map(lambda _: next(it), params)

    def _sum_over_pipe(self, params, grads):
        """``embed``, ``ln_final`` and ``lm_head`` summed over pipe (one
        all-reduce), so every rank holds their whole gradient."""
        from ..models import training

        group = self.mesh.group("pipe")
        if group is None:
            return grads
        tops = [k for k, v in params.items() for _ in
                (training.tree_leaves(v) if isinstance(v, dict) else (v,))]
        idx = [i for i, k in enumerate(tops) if k in SHARED]
        flat = comm.all_reduce(torch.cat([grads[i].reshape(-1)
                                          for i in idx]), group)
        grads = list(grads)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view(grads[i].shape)
        return grads

    def __call__(self, params, opt_state, tokens):
        from ..models import training

        loss, grads = self.grads_fn(params, tokens)
        params, opt_state = self.optimizer.apply(
            params, list(training.tree_leaves(grads)), opt_state)
        return params, opt_state, loss

    def init_all(self, generator: torch.Generator):
        """(params, opt_state): the whole tree drawn from ``generator`` as
        the family's single-device ``init_params`` draws it, in the
        schedule's stored layout, and on a mesh this rank's shards (the
        same tree at every world size)."""
        from ..models.llama import shard_leaf

        mesh = self.mesh
        # this rank's shards of everything but the pipe axis, as the
        # family's layout draws them, then its stage's layers
        params = chunked_layers(self.layout.draw(generator, self.device),
                                self.v)
        if mesh is not None:
            lead = ("pipe",) if self.v == 1 else (None, "pipe")
            params = {**params, "layers": {
                n: shard_leaf(a, lead, mesh)
                for n, a in params["layers"].items()}}
        return params, self.optimizer.init(params)


def make_pipeline_train_step(cfg, mesh=None, n_microbatches: int = 4,
                             optimizer=None, attn_fn: Optional[Callable] =
                             None, seq_axis: Optional[str] = None,
                             schedule: str = "gpipe",
                             virtual_stages: int = 2, *, device=None,
                             stages_in_process: int = 1):
    """Pipeline-parallel training step over the mesh's ``pipe`` axis, of
    either family (the config's type picks it, as
    :func:`..models.llama.make_train_step` does): (step, init_all,
    optimizer), with the plain step's contract; ``step`` is a
    :class:`PipelineStep`, whose ``grads_fn`` gives (loss, grads) alone.

    Composes with data / fsdp (the batch), tensor (heads / ffn), for the
    MoE expert (each stage's MoE layout) and, with ``seq_axis="seq"``,
    ring sequence parallelism inside each stage (the activations each seq
    rank's chunk, rope at its absolute positions), on every schedule.
    ``schedule``: "gpipe", "1f1b" or "interleaved" (``virtual_stages``
    chunks a stage, layers stored ``[v, L/v, ...]``).  ``optimizer``: an
    optimizer object, ``"adam8bit"`` (built with the mesh and the
    pipeline's specs) or None (``training.adamw(3e-4,
    weight_decay=0.1)``).  ``attn_fn``: the stage's attention (default:
    flash where it takes the shape, plain otherwise).  The MoE's router
    aux loss is the reference's microbatched estimator: the mean of every
    (layer, microbatch) unit's aux, each computed on that microbatch's
    global rows, and with ``seq_axis`` on each seq shard's positions
    (routing groups local to the shard, capacity by its length).

    ``mesh`` None holds ``stages_in_process`` stages in this process on
    ``device`` (None means CUDA), handing activations and cotangents
    between them in place of the pipe axis's hops: the same executor over
    the same tables, for one card."""
    from ..models import llama

    if mesh is None:
        dev = resolve_device(device)
        n_stages = stages_in_process
    else:
        dev = mesh.device if device is None else resolve_device(device)
        llama.check_mesh_step(dev, mesh, optimizer)
        n_stages = mesh.size("pipe")
    step = PipelineStep(cfg, mesh, n_microbatches, schedule, virtual_stages,
                        seq_axis, attn_fn, dev, n_stages, optimizer)
    return step, step.init_all, step.optimizer
