"""The job's device mesh over torch.distributed ranks, one GPU per rank.

Counterpart of ``tpu_network_operator/parallel/mesh.py``.  The axis
vocabulary, the planning rules and their errors are the reference's:

* ``data``: pure data parallelism (gradients summed; the only axis that
  may cross slices);
* ``fsdp``: parameters sharded, gathered per layer in the forward and
  reduce-scattered in the backward;
* ``pipe``: pipeline stages over the stacked-layer axis;
* ``expert``: expert parallelism for MoE models;
* ``seq``: sequence parallelism (ring or Ulysses attention);
* ``tensor``: Megatron-style tensor parallelism (innermost, the fastest
  links).

:func:`plan_axes` and :func:`validate_axis_order` are pure Python.
:func:`make_mesh` lays the ranks out row-major in plan order (rank r is
the process that ``init_process_group`` numbered r, one per GPU), builds a
``DeviceMesh`` with ``init_device_mesh`` (``mesh_dim_names`` in plan
order) and the groups over two or three axes that the sharded step reduces
over.  :func:`init_process_group` starts the group from the bootstrap
file: NCCL for a CUDA device, gloo for the CPU, by the device asked for.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..bootstrap import BootstrapConfig, gpu_rank

AXES = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
# the groups over several axes that the sharded train step reduces over:
# the batch (data x fsdp), with sequence parallelism data x seq and
# data x fsdp x seq, and the MoE's expert x tensor (each rank's partial
# sum of the expert FFN)
MULTI_AXIS_GROUPS = (("data", "fsdp"), ("data", "seq"),
                     ("data", "fsdp", "seq"), ("expert", "tensor"))
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class MeshPlan:
    """A named axis -> size assignment totaling the device count."""

    axis_sizes: Dict[str, int] = field(default_factory=dict)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.axis_sizes.keys())

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.axis_sizes.values())

    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1


def plan_axes(
    n_devices: int,
    *,
    tensor: int = 1,
    seq: int = 1,
    expert: int = 1,
    pipe: int = 1,
    fsdp: Optional[int] = None,
    data: Optional[int] = None,
    dcn_slices: int = 1,
    axis_order: Optional[Sequence[str]] = None,
) -> MeshPlan:
    """Fill unset axes so the product covers all devices: ``tensor``,
    ``seq``, ``expert`` and ``pipe`` as given, ``fsdp`` the remaining
    intra-slice factor, ``data`` the rest (the slice factor included).
    ``axis_order`` (a permutation of :data:`AXES`) reorders the axes."""
    fixed = tensor * seq * expert * pipe
    if n_devices % fixed != 0:
        raise ValueError(
            f"tensor*seq*expert*pipe={fixed} does not divide "
            f"device count {n_devices}"
        )
    rest = n_devices // fixed
    if data is None and fsdp is None and dcn_slices > 1:
        # the slice factor rides the (outermost) data axis
        if rest % dcn_slices != 0:
            raise ValueError(
                f"dcn_slices={dcn_slices} does not divide remainder {rest}"
            )
        data = dcn_slices
    if fsdp is None:
        fsdp = rest if data is None else rest // data
    if fsdp == 0 or rest % fsdp != 0:
        raise ValueError(f"fsdp={fsdp} does not divide remainder {rest}")
    if data is None:
        data = rest // fsdp
    if data * fsdp * fixed != n_devices:
        raise ValueError(
            f"axis product {data}*{fsdp}*{fixed} != {n_devices}"
        )
    if dcn_slices > 1 and data % dcn_slices != 0:
        raise ValueError(
            f"data axis {data} not divisible by dcn_slices {dcn_slices}"
        )
    sizes = {
        "data": data, "fsdp": fsdp, "pipe": pipe, "expert": expert,
        "seq": seq, "tensor": tensor,
    }
    order = validate_axis_order(axis_order) if axis_order else AXES
    return MeshPlan({name: sizes[name] for name in order})


def validate_axis_order(order: Sequence[str]) -> Tuple[str, ...]:
    """An axis order must be a permutation of ``AXES``; anything else is
    an error here, not a silently misshaped mesh."""
    if sorted(order) != sorted(AXES):
        raise ValueError(
            f"axis order {list(order)!r} is not a permutation of {AXES}"
        )
    return tuple(order)


class MeshCoord:
    """A rank's place on a plan: the axis sizes and its coordinate on
    each, which is all that drawing or slicing its shards needs.  Built
    alone it stands for any rank of a job with no process group, as a
    check on one card does: :meth:`group` is None for every axis, so a
    layout over it computes that rank's part with every collective left
    out, for the caller to stand in for."""

    def __init__(self, plan: MeshPlan, coord: Dict[str, int]):
        self.plan = plan
        self.ranks = np.arange(plan.size()).reshape(plan.shape)
        self.coord = {a: int(coord.get(a, 0)) for a in plan.names}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.plan.axis_sizes)

    def size(self, *axes: str) -> int:
        return math.prod(self.plan.axis_sizes[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's position along ``axes`` taken together, the first
        axis outermost (its shard of a dim sharded over them)."""
        i = 0
        for a in axes:
            i = i * self.plan.axis_sizes[a] + self.coord[a]
        return i

    def group(self, *axes: str):
        """No process group: None, for every axis."""
        return None


class Mesh(MeshCoord):
    """This rank's view of the job mesh: the plan, the rank layout, this
    rank's coordinate on every axis, its device, the ``DeviceMesh`` and
    the process groups.  :meth:`group` is None for axes of total size 1,
    which makes every collective over them the identity
    (:mod:`.comm`)."""

    def __init__(self, plan: MeshPlan, device: torch.device, device_mesh,
                 multi_groups: Dict[Tuple[str, ...], object]):
        ranks = np.arange(plan.size()).reshape(plan.shape)
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)[0]
        super().__init__(plan, dict(zip(plan.names, (int(i) for i in where))))
        self.device = device
        self.device_mesh = device_mesh
        self._multi = multi_groups

    def group(self, *axes: str):
        """The process group over ``axes``; None where they span one rank."""
        if self.size(*axes) == 1:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._multi[tuple(axes)]

    def ring_peers(self, axis: str) -> Tuple[int, int]:
        """(next, previous) global ranks along ``axis``: where this rank's
        ring hop sends and where it receives from."""
        i = self.coord[axis]
        n = self.plan.axis_sizes[axis]
        dim = self.plan.names.index(axis)

        def at(j):
            idx = [self.coord[a] for a in self.plan.names]
            idx[dim] = j
            return int(self.ranks[tuple(idx)])

        return at((i + 1) % n), at((i - 1) % n)


def _subgroups(ranks: np.ndarray, names: Tuple[str, ...],
               axes: Tuple[str, ...]):
    """Every group of ranks that differ only along ``axes``, in one fixed
    order (each rank builds all of them, as ``new_group`` requires)."""
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(ranks.ndim) if d not in dims]
    moved = ranks.transpose(rest + dims)
    return moved.reshape(-1, math.prod(ranks.shape[d] for d in dims))


def make_mesh(plan: MeshPlan, device) -> Mesh:
    """The mesh of the initialized process group in plan order; the world
    must be the plan's size.  ``device`` is this rank's device."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(init_process_group, or the workload's init_distributed)"
        )
    world = dist.get_world_size()
    if world != plan.size():
        raise ValueError(
            f"plan covers {plan.size()} devices but the process group has "
            f"{world} ranks"
        )
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    device_mesh = init_device_mesh(device.type, plan.shape,
                                   mesh_dim_names=plan.names)
    ranks = np.arange(world).reshape(plan.shape)
    multi = {}
    for axes in MULTI_AXIS_GROUPS:
        if math.prod(plan.axis_sizes[a] for a in axes) == 1:
            continue
        for members in _subgroups(ranks, plan.names, axes):
            g = dist.new_group([int(r) for r in members])
            if dist.get_rank() in members:
                multi[axes] = g
    return Mesh(plan, device, device_mesh, multi)


def placements(plan: MeshPlan, spec) -> list:
    """The DTensor placements of a leaf sharded by ``spec`` (per dim, the
    mesh axis it is cut over, or None), one per mesh dim in plan order:
    ``Shard(dim)`` on the axis that cuts ``dim``, ``Replicate`` on every
    other axis and on axes of one rank."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return [Shard(dims[a]) if a in dims and n > 1 else Replicate()
            for a, n in plan.axis_sizes.items()]


def global_shape(shape, spec, plan: MeshPlan) -> Tuple[int, ...]:
    """The global shape of a shard of ``shape`` cut by ``spec`` (per dim,
    the mesh axis it is sharded over, or None) on ``plan``."""
    return tuple(d * (plan.axis_sizes[a] if a is not None else 1)
                 for d, a in zip(shape, spec))


def as_dtensor(local: torch.Tensor, spec, plan: MeshPlan, device_mesh):
    """This rank's shard ``local`` of a leaf sharded by ``spec`` viewed as
    a ``DTensor`` on ``device_mesh`` (whose dims are ``plan``'s, in plan
    order), without a copy: the global shape is the shard's times the
    ranks of each axis that cuts it, and nothing is communicated.
    ``device_mesh`` must be of ``local``'s device type, or ``from_local``
    moves the shard there."""
    from torch.distributed.tensor import DTensor

    shape = global_shape(local.shape, spec, plan)
    stride, step = [], 1
    for d in reversed(shape):
        stride.insert(0, step)
        step *= d
    return DTensor.from_local(local, device_mesh, placements(plan, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def host_device_mesh(plan: MeshPlan):
    """A CPU ``DeviceMesh`` of ``plan``'s rank layout with no process
    groups of its own: what a DTensor of a host copy of a shard is laid
    out on, where the job's mesh is on the GPUs (a DTensor of a CPU shard
    on a CUDA mesh would be copied to the card)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(plan.size()).reshape(plan.shape),
                      mesh_dim_names=plan.names, _init_backend=False)


# -- the operator's topology plan ---------------------------------------------
#
# The planner's block in the bootstrap file: DCN ring order, a suggested
# axis order and a ring-vs-hierarchical collective hint.  Each helper falls
# back to the plan-less behaviour when the block is absent or mangled.

COLLECTIVE_RING = "ring"
COLLECTIVE_HIERARCHICAL = "hierarchical"


def plan_block(cfg: BootstrapConfig) -> Dict:
    """The bootstrap's plan block, ``{}`` when absent or malformed."""
    plan = getattr(cfg, "plan", None)
    return plan if isinstance(plan, dict) else {}


def planned_axis_order(cfg: BootstrapConfig) -> Tuple[str, ...]:
    """The plan's axis order, validated; :data:`AXES` when the block is
    absent or the hint is not a permutation of them."""
    order = plan_block(cfg).get("meshAxisOrder")
    if not isinstance(order, (list, tuple)):
        return AXES
    try:
        return validate_axis_order([str(a) for a in order])
    except ValueError:
        return AXES


def dcn_collective(cfg: BootstrapConfig) -> str:
    """``hierarchical`` when the plan says so, else ``ring``."""
    hint = plan_block(cfg).get("collective")
    return (
        COLLECTIVE_HIERARCHICAL
        if hint == COLLECTIVE_HIERARCHICAL else COLLECTIVE_RING
    )


def planned_ring_index(cfg: BootstrapConfig) -> int:
    """This host's position in the planned DCN ring; -1 when unplanned."""
    idx = plan_block(cfg).get("ringIndex", -1)
    return idx if isinstance(idx, int) and not isinstance(idx, bool) else -1


def plan_from_bootstrap(cfg: BootstrapConfig, world: int, *,
                        tensor: int = 1, seq: int = 1, expert: int = 1,
                        pipe: int = 1) -> MeshPlan:
    """The job's plan from the bootstrap file: ``num_chips x num_slices``
    devices (``world`` where the file gives no chips), the slice factor
    folded into ``data``, the plan's axis order honoured."""
    topo = cfg.topology
    have_topo = topo is not None and topo.num_chips > 0
    n = topo.num_chips * topo.num_slices if have_topo else world
    return plan_axes(n, tensor=tensor, seq=seq, expert=expert, pipe=pipe,
                     dcn_slices=topo.num_slices if have_topo else 1,
                     axis_order=planned_axis_order(cfg))


def mesh_from_bootstrap(cfg: BootstrapConfig, device, *, tensor: int = 1,
                        seq: int = 1, expert: int = 1,
                        pipe: int = 1) -> Mesh:
    """The job mesh from the bootstrap file (:func:`plan_from_bootstrap`)
    over the initialized process group."""
    plan = plan_from_bootstrap(cfg, dist.get_world_size(), tensor=tensor,
                               seq=seq, expert=expert, pipe=pipe)
    return make_mesh(plan, device)


def init_process_group(cfg: BootstrapConfig, device, *, local_rank: int = 0,
                       local_world: int = 1,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT
                       ) -> torch.device:
    """``torch.distributed.init_process_group`` from the bootstrap file
    (``device`` None means CUDA, and raises without it):
    the coordinator address as the TCP rendezvous, this GPU process's
    rank and the world from :func:`..bootstrap.gpu_rank`, NCCL for a CUDA
    ``device`` and gloo for the CPU.  Returns this rank's device
    (``cuda:<local_rank>`` on a GPU host)."""
    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    rank, world = gpu_rank(cfg, local_rank, local_world)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        BACKENDS[device.type], init_method=f"tcp://{cfg.coordinator_address}",
        rank=rank, world_size=world, timeout=timeout)
    return device

