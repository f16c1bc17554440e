"""Device layouts over processes, and the collectives that run on them.

Counterpart of ``distkeras_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is an
array of devices with named axes, and ``shard_map`` binds those axes for
the collectives inside it.  Here one process is one device: a
:class:`Mesh` lays the ranks of the initialized ``torch.distributed``
world out row-major over named axes (as the JAX package's
``np.array(devices[:n]).reshape(sizes)`` does), holds this rank's
coordinate, and makes one process group for every axis and for each set
of several axes in ``joint_axes`` (by default the steps' sets: the LM
loss over ``("dp", "sp")``, the MoE loss over ``("dp", "ep")``, the
pipeline's outer grads over ``("dp", "pp")``), so that a collective "over
dp x sp" is a call on that group.  Every rank builds every group, in the same order, as
``dist.new_group`` requires; axes of size 1 drop out of a set, a set of
size 1 gets no group, and a collective over it is the identity.  A mesh
of one device needs no process group at all.

The collectives of the layouts are ``torch.autograd.Function`` objects
whose backward is the adjoint that JAX applies:

- :func:`ring_shift`: ``lax.ppermute`` by +1 along an axis; the backward
  shifts the cotangent by -1.  Paired ``isend``/``irecv`` in one batch.
- :func:`copy_to_tp` (Megatron's f): identity forward, all-reduce of the
  cotangent over the axis; at the input of a column-parallel layer.
- :func:`reduce_from_tp` (Megatron's g): all-reduce forward, identity
  backward; after a row-parallel layer.  (``torch.distributed.nn``'s
  ``all_reduce`` would all-reduce the cotangent too, which multiplies the
  gradient by the axis size here.)
- :func:`sum_over`: the sum of a scalar over a set of axes, identity
  backward (JAX's ``psum`` of a varying value, whose transpose is the
  broadcast).
- :func:`all_to_all`: the tiled ``lax.all_to_all``; the backward is the
  all-to-all with the split and concat axes swapped.
- :func:`reduce_scatter`: the tiled ``lax.psum_scatter`` over dim 0; the
  backward is the all-gather of the cotangent.
- :func:`join`: its first input as it is, every other input given a zero
  cotangent, so that a collective whose output this rank does not read
  still runs its adjoint here (the others wait for it).

:func:`ring_exchange` (no autograd) posts a +1 and a -1 shift in one
batch, for schedules that carry their own cotangents (1F1B).

Backend.  A Gloo group takes CUDA tensors for all-reduce and broadcast
only, not for send, receive, all-gather, all-to-all or reduce-scatter.
A group whose backend is Gloo therefore stages every CUDA tensor through
pinned host memory (one copy to the host, the collective, one copy back),
for every op alike; an NCCL group and a Gloo group on CPU tensors run
on the tensors as they are.  The rule reads the group's backend
(:func:`_staged`), never an error.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distkeras_torch.platform import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]
# the sets of several axes whose groups a mesh makes by default (where it
# has every axis of the set): the LM loss, the MoE loss, the pipeline's
# outer grads
JOINT_AXES = (("dp", "sp"), ("dp", "ep"), ("dp", "pp"))


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> Tuple[int, int]:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """Named axes over the first ``prod(axis_sizes)`` ranks of the world.

    ``shape`` maps each axis name to its size, in order (``mesh.shape["sp"]``
    reads as in JAX); ``ranks`` is the array of global ranks; ``coords``
    this rank's index along each axis (``None`` on a rank outside the
    mesh); ``device`` where this process computes.  ``joint_axes`` names
    the sets of several axes that a collective runs over; a set whose
    axes the mesh lacks is left out."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device: DeviceLike = None,
                 joint_axes: Iterable[Sequence[str]] = JOINT_AXES):
        sizes = tuple(int(n) for n in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis sizes {sizes} and names {names} must pair up, "
                             f"each name once")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.size = int(np.prod(sizes, dtype=np.int64))
        self.device = resolve_device(device)
        world, rank = _world()
        if self.size > world:
            raise ValueError(f"mesh of {self.size} devices requested, have {world}")
        self.rank = rank
        self.ranks = np.arange(self.size).reshape(sizes)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
            if rank < self.size else None)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        if self.size > 1:
            sets = [self._live(a) for a in names]
            sets += [self._live(j) for j in joint_axes if all(a in self.shape for a in j)]
            self._make_groups(world, [axes for axes in dict.fromkeys(sets) if axes])

    def _make_groups(self, world: int, sets: List[Tuple[str, ...]]) -> None:
        """For each set of axes, one group for every coordinate of the
        other axes; the same calls in the same order on every rank."""
        dist = _dist()
        n = len(self.axis_names)
        for axes in sets:
            idx = [self.axis_names.index(a) for a in axes]
            others = [i for i in range(n) if i not in idx]
            arr = self.ranks.transpose(others + idx).reshape(-1, self.axis_size(axes))
            for members in arr.tolist():
                group = dist.group.WORLD if len(members) == world else dist.new_group(members)
                if self.rank in members:
                    self._groups[axes] = (group, members)

    def _live(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, without those of size 1."""
        return tuple(a for a in self._axes(axes) if self.shape[a] > 1)

    def __repr__(self) -> str:
        inner = ", ".join(f"'{a}': {n}" for a, n in self.shape.items())
        return f"Mesh({inner})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not a mesh axis of {self}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes: Axes) -> int:
        """Product of the sizes of ``axes``."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)], dtype=np.int64))

    def coord(self, axes: Axes) -> int:
        """This rank's index within its group over ``axes`` (row-major)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside {self}")
        axes = self._axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group over ``axes`` that holds this rank; ``None``
        where the axes' sizes multiply to 1."""
        return self._group(axes)[0]

    def group_ranks(self, axes: Axes) -> List[int]:
        """Global ranks of the group over ``axes``, in coordinate order."""
        return list(self._group(axes)[1])

    def _group(self, axes: Axes) -> Tuple[object, List[int]]:
        axes = self._live(axes)
        if not axes:
            return None, [self.rank]
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is outside {self}")
        if axes not in self._groups:
            raise ValueError(f"{self} has no group over {axes}: name the set in "
                             f"joint_axes when the mesh is made")
        return self._groups[axes]


def create_mesh(num_devices: Optional[int] = None, axis_name: str = "replica",
                device: DeviceLike = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` ranks (data parallelism)."""
    world, _ = _world()
    if num_devices is None:
        num_devices = world
    if num_devices > world:
        raise ValueError(f"requested {num_devices} devices, have {world}")
    return Mesh((num_devices,), (axis_name,), device=device)


def create_nd_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
                   device: DeviceLike = None,
                   joint_axes: Iterable[Sequence[str]] = JOINT_AXES) -> Mesh:
    """N-D mesh, e.g. ``create_nd_mesh((2, 2, 2), ('dp', 'tp', 'sp'))``;
    ``joint_axes`` as :class:`Mesh` takes it."""
    n = int(np.prod(axis_sizes, dtype=np.int64))
    world, _ = _world()
    if n > world:
        raise ValueError(f"mesh of {n} devices requested, have {world}")
    return Mesh(axis_sizes, axis_names, device=device, joint_axes=joint_axes)


# -- collectives ---------------------------------------------------------------------------

def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through pinned host memory for ``group``: a Gloo
    group given a CUDA tensor (see the module note)."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` as a new tensor (``t`` itself when
    ``group`` is ``None``)."""
    if group is None:
        return t
    dist = _dist()
    if _staged(group, t):
        buf = _host(t)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_tensors(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum of each tensor over ``group``, in one collective per dtype: the
    tensors are packed into one flat buffer and cut out again."""
    if group is None or not tensors:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    dist = _dist()
    staged = _staged(group, t)
    src = _host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def _shifts(pairs: List[Tuple[torch.Tensor, int]], group,
            ranks: List[int]) -> List[torch.Tensor]:
    """For each ``(x, step)``: send ``x`` to the rank ``step`` ahead in
    ``ranks`` and receive its like from the rank ``step`` behind, every
    send and receive posted in one batch (never a blocking send before a
    receive)."""
    dist = _dist()
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    staged = _staged(group, pairs[0][0])
    ops, dsts = [], []
    for x, step in pairs:
        src = _host(x) if staged else x.contiguous()
        dsts.append(torch.empty_like(src))
        ops += [dist.P2POp(dist.isend, src, ranks[(me + step) % n], group),
                dist.P2POp(dist.irecv, dsts[-1], ranks[(me - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [d.to(x.device) if staged else d for d, (x, _) in zip(dsts, pairs)]


def _shift(x: torch.Tensor, group, ranks: List[int], step: int) -> torch.Tensor:
    return _shifts([(x, step)], group, ranks)[0]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x, mesh.group(axis), mesh.group_ranks(axis), 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh.group(ctx.axis), ctx.mesh.group_ranks(ctx.axis), -1), None, None


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.ppermute`` by +1 along ``axis``: rank ``i`` receives rank
    ``i - 1``'s ``x``.  Every rank of the axis must call it, in the same
    order as the others."""
    if mesh.axis_size(axis) == 1:
        return x
    return _RingShift.apply(x, mesh, axis)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh], axis: Optional[str]) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its cotangent all-reduced over
    ``axis``; the identity outside a mesh or where the axis is absent (as
    the JAX package's ``_maybe_psum`` is outside a ``shard_map``)."""
    group = _tp_group(mesh, axis)
    return x if group is None else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh], axis: Optional[str]) -> torch.Tensor:
    """Megatron's g: ``x`` all-reduced over ``axis``, its cotangent as it
    is; the identity outside a mesh or where the axis is absent."""
    group = _tp_group(mesh, axis)
    return x if group is None else _ReduceFromTp.apply(x, group)


def _tp_group(mesh: Optional[Mesh], axis: Optional[str]):
    if mesh is None or axis is None or axis not in mesh.shape:
        return None
    return mesh.group(axis)


def sum_over(x: torch.Tensor, mesh: Optional[Mesh], axes: Iterable[str]) -> torch.Tensor:
    """``lax.psum`` of ``x`` over ``axes``: all-reduced forward, its
    cotangent as it is."""
    axes = tuple(a for a in axes if mesh is not None and a in mesh.shape)
    group = mesh.group(axes) if axes else None
    return x if group is None else _ReduceFromTp.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.group, concat_axis, split_axis), None, None, None


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    dist = _dist()
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not split {n} ways")
    # chunk j goes to group rank j; what rank i sent lands at row i
    send = torch.stack(x.chunk(n, dim=split_axis))
    staged = _staged(group, x)
    src = _host(send) if staged else send.contiguous()
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=group)
    out = torch.cat(dst.unbind(0), dim=concat_axis)
    return out.to(x.device) if staged else out


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into ``n`` blocks along ``split_axis``, block ``j`` sent to
    the ``j``-th rank of the axis, the blocks received concatenated along
    ``concat_axis`` in the senders' order.  The identity where the axis
    has size 1."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        dist = _dist()
        n = dist.get_world_size(group)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split {n} ways")
        staged = _staged(group, x)
        src = _host(x) if staged else x.contiguous()
        dst = src.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(dst, src, group=group)
        return dst.to(x.device) if staged else dst

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group), None


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: the
    sum of ``x`` over the axis, of which the ``i``-th rank keeps the
    ``i``-th block along dim 0.  ``x`` itself where the axis has size 1."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _ReduceScatter.apply(x, group)


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *dead):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in dead]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.shapes)


def join(out: torch.Tensor, *dead: torch.Tensor) -> torch.Tensor:
    """``out`` as it is, with ``dead`` as inputs whose cotangent is 0.
    Autograd runs a node only where its output reaches the loss; a
    collective whose output this rank never reads (the last ring rotation,
    a pipeline tick's shift into rank 0) is joined to what the rank does
    read, so that its adjoint runs on every rank, in the same order."""
    live = [d for d in dead if d.requires_grad]
    return _Join.apply(out, *live) if live else out


def ring_exchange(down: torch.Tensor, up: torch.Tensor, mesh: Mesh,
                  axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift ``down`` by +1 and ``up`` by -1 along ``axis`` in one batch of
    sends and receives: returns (the previous rank's ``down``, the next
    rank's ``up``).  No autograd; every rank of the axis calls it."""
    group = mesh.group(axis)
    if group is None:
        return down, up
    prev_down, next_up = _shifts([(down, 1), (up, -1)], group, mesh.group_ranks(axis))
    return prev_down, next_up
