"""Meshes of the port: ranks of a process group, or one process's devices.

The port of ``repro.launch.mesh``. The reference's mesh is a jax
``Mesh``: devices on named axes that one program drives. Here a
collective runs between processes, so the mesh the aggregation tree
reduces over is :class:`RankMesh`: the ranks of a process group the
caller has started (``torch.distributed.init_process_group``), laid out
row-major on named axes. Each rank knows its coordinate on each axis;
the mesh creates the process group of every axis line and, on request,
the subgroups of a grouped reduction, cached by their rank tuples.
``torch.distributed`` requires every rank to create every group in the
same order, so every rank must ask for the same groups in the same
order. The aggregation plan is the same on every rank, so the psums of
``fl.aggregation`` do.

Backends. ``gloo`` is the backend on one card: every rank's tensors sit
on ``cuda:0``, and gloo stages a CUDA tensor through pinned host memory
for each collective (the reductions here run in bounded chunks, so the
staging never holds a model's second copy). ``nccl`` is accepted only
when every rank has a card of its own (``cuda:<rank>``): NCCL refuses two
ranks of one communicator on one card. No run of this repository
exercises nccl.

:class:`DeviceMesh` is the single-controller kind: one process, devices
on named axes. ``fl.distributed.shard_rows`` takes a 1-D ``("rows",)``
one, which may repeat one card.

Tensor collectives (:meth:`RankMesh.all_reduce_`, :meth:`RankMesh.all_gather`,
:meth:`RankMesh.reduce_scatter`) serve the model axis of the sharded
decoder (``models/tensor_parallel.py``): sums, gathers and scatters of
activations along one tensor dim over one axis line. Gloo takes CUDA
tensors for all three (it stages them through pinned host memory
itself; checked on an H100 with torch 2.11). Each call adds its bytes
(this rank's input) to :attr:`RankMesh.traffic`, and, with
:attr:`RankMesh.timed` set, its host-clock seconds (the card
synchronised before and after).

``make_production_mesh`` keeps the reference's shapes, ``(16, 16)``
over ``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data",
"model")``, as a rank mesh over a world of that many ranks. The
reference's hardware constants are not carried over.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Elements a collective moves per call: 64 MiB of float32. A flat buffer
# is reduced in chunks of this size, which bounds gloo's host staging.
COLLECTIVE_CHUNK = 1 << 24


def mesh_chip_count(mesh) -> int:
    """Devices (or ranks) of a mesh: the product of its axis sizes."""
    return math.prod(mesh.shape.values())


@dataclass(frozen=True)
class DeviceMesh:
    """One process's devices on named axes, row-major (the reference's
    ``jax.make_mesh`` in a single controller)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) or \
                math.prod(self.dims) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"{self.dims} mesh over {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims, strict=True))


def row_mesh(n: int, device="cuda", axis: str = "rows") -> DeviceMesh:
    """A 1-D mesh of ``n`` entries over the visible devices of
    ``device``'s type, round-robin (``n`` entries on one card repeat
    it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a cuda row mesh needs a card; "
                               "torch.cuda.device_count() is 0")
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devices = (dev,) * n
    return DeviceMesh(devices, (axis,), (n,))


class RankMesh:
    """The ranks of the default process group on named axes, row-major.

    ``device`` is where this rank's tensors live. Construct it on every
    rank, after ``init_process_group``, with the same shape and names.
    """

    def __init__(self, dims: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs torch.distributed."
                               "init_process_group first")
        self.dims = tuple(int(d) for d in dims)
        self.axis_names = tuple(axis_names)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"{self.dims} and {self.axis_names} differ "
                             f"in length")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if math.prod(self.dims) != self.world:
            raise ValueError(
                f"a {self.dims} mesh over {self.axis_names} needs "
                f"{math.prod(self.dims)} ranks; the world has {self.world}")
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # before any group exists, so a refused layout runs no collective
        check_backend(self.backend, self.device, self.rank, self.world)
        self.coords = dict(zip(self.axis_names,
                               _unravel(self.rank, self.dims), strict=True))
        self._groups: Dict[tuple, Optional[object]] = {}
        self._axis_groups = {a: self.subgroup(a, (tuple(range(n)),))
                             for a, n in zip(self.axis_names, self.dims,
                                             strict=True)}
        # {op: [calls, bytes put in, seconds (when timed)]} of the tensor
        # collectives
        self.traffic: Dict[str, list] = {}
        self.timed = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims, strict=True))

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None
        when the axis has one entry)."""
        return self._axis_groups[axis]

    def _line(self, axis: str, others: Dict[str, int]) -> list:
        """Global ranks along ``axis`` at the other axes' coordinates."""
        out = []
        for i in range(self.shape[axis]):
            coords = [i if a == axis else others[a]
                      for a in self.axis_names]
            out.append(_ravel(coords, self.dims))
        return out

    def subgroup(self, axis: str, index_groups: Sequence[Sequence[int]]):
        """This rank's process group of a grouped reduction along ``axis``
        (the reference's ``axis_index_groups``): every line along the
        axis splits into ``index_groups``. Groups of more than one rank
        are created on first use, on every rank, in one order (lines in
        row-major order of the other axes, then the groups as given) and
        cached by their rank tuples; returns None when this rank's group
        is itself alone."""
        others = [a for a in self.axis_names if a != axis]
        rank_groups = []
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            line = self._line(axis, dict(zip(others, combo, strict=True)))
            rank_groups.extend(tuple(line[i] for i in g)
                               for g in index_groups)
        key = tuple(rank_groups)
        if key not in self._groups:
            mine = None
            for ranks in rank_groups:
                if len(ranks) < 2:
                    continue
                pg = dist.new_group(list(ranks))
                if self.rank in ranks:
                    mine = pg
            self._groups[key] = mine
        return self._groups[key]

    def all_reduce(self, buf: torch.Tensor, group) -> int:
        """Sum a contiguous 1-D ``buf`` over ``group`` in place, in
        chunks of COLLECTIVE_CHUNK elements; returns the bytes this rank
        put in (0 for no group: a rank alone is its own sum)."""
        if group is None:
            return 0
        if buf.dim() != 1 or not buf.is_contiguous():
            raise ValueError("all_reduce takes a contiguous 1-D buffer")
        for off in range(0, buf.numel(), COLLECTIVE_CHUNK):
            dist.all_reduce(buf[off:off + COLLECTIVE_CHUNK], group=group)
        return buf.numel() * buf.element_size()

    # ---- tensor collectives along one axis -------------------------------
    def _record(self, op: str, x: torch.Tensor, t0: float) -> None:
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        row = self.traffic.setdefault(op, [0, 0, 0.0])
        row[0] += 1
        row[1] += x.numel() * x.element_size()
        row[2] += time.perf_counter() - t0 if self.timed else 0.0

    def _start(self, x: torch.Tensor) -> float:
        if self.timed and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def all_reduce_(self, x: torch.Tensor, axis: str,
                    op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` (contiguous) in place over ``axis`` (``op``
        "sum" or "max"); returns it."""
        group = self.axis_group(axis)
        if group is None:
            return x
        t0 = self._start(x)
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        self._record(f"all_reduce_{op}", x, t0)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The axis line's ``x`` concatenated along ``dim`` in axis order
        (a new tensor)."""
        group = self.axis_group(axis)
        if group is None:
            return x
        n = self.shape[axis]
        t0 = self._start(x)
        inp = x.movedim(dim, 0).contiguous()
        out = inp.new_empty((n * inp.shape[0],) + inp.shape[1:])
        _all_gather(out, inp, group=group)
        self._record("all_gather", inp, t0)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """The sum of the axis line's ``x``, this rank's part of it along
        ``dim`` (its coordinate's slice of ``x.shape[dim] / n``)."""
        group = self.axis_group(axis)
        if group is None:
            return x
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {n} ranks of {axis!r}")
        t0 = self._start(x)
        inp = x.movedim(dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] // n,) + inp.shape[1:])
        _reduce_scatter(out, inp, group=group)
        self._record("reduce_scatter", inp, t0)
        return out.movedim(0, dim).contiguous()


def _all_gather(out, inp, group=None):
    # all_gather_single is all_gather_into_tensor's newer name
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out, inp, group=None):
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def check_backend(backend: str, device, rank: int, world: int,
                  cards: Optional[int] = None) -> None:
    """Raise unless ``backend`` can run this rank on ``device``: gloo
    anywhere; nccl only with a card a rank (rank r on ``cuda:r``, as
    many cards as ranks), since NCCL refuses two ranks of one
    communicator on one card."""
    if backend != "nccl":
        return
    device = torch.device(device)
    cards = torch.cuda.device_count() if cards is None else cards
    if device.type != "cuda" or cards < world or device.index != rank:
        raise ValueError(
            f"nccl needs a card a rank (rank {rank} on cuda:{rank} of "
            f"{world} cards); rank {rank} is on {device} with {cards} "
            f"card(s) visible. Use backend='gloo' to run several ranks "
            f"on one card")


def _unravel(rank: int, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], dims: Tuple[int, ...]) -> int:
    r = 0
    for c, d in zip(coords, dims, strict=True):
        r = r * d + c
    return r


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> RankMesh:
    """The reference's production layout as a rank mesh: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model");
    raises when the world has fewer (or more) ranks than the shape."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(dims):
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(
            f"the production mesh {dims} over {axes} needs a world of "
            f"{math.prod(dims)} ranks; this one has {have}")
    return RankMesh(dims, axes, device=device)
