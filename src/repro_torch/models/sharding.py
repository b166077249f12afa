"""Sharding policy: maps *logical* tensor dims to physical mesh axes (the
port of ``repro.models.sharding``).

Models never hard-code mesh axis names: they annotate tensors with
logical dims ("batch", "model", "fsdp", "seq", None) and the active
``ShardingPolicy`` resolves them to a :class:`PartitionSpec`, or to
nothing at all without a mesh, so the same model code serves both
paths. ``dim("model", size)`` returns None when ``size`` does not divide
by the model axis (RecurrentGemma's 10 heads on a 16-wide axis are
replicated; its flat 2560 projections shard).

The mesh is a :class:`~repro_torch.launch.mesh.RankMesh` (the ranks of a
process group on named axes) or, for the pure spec rules, any object
with ``axis_names`` and a ``shape`` dict (``launch.mesh.DeviceMesh``).
:class:`PartitionSpec` is the port's own (a tuple of axis names, tuples
of names or None per tensor dim); :meth:`ShardingPolicy.named` maps one
to a placement per mesh axis, ``Shard(d)`` or ``Replicate()``, the
counterpart of JAX's ``NamedSharding``.

A tensor annotated by :func:`shard_hint` is already laid out: the port's
ranks hold local shards and the models place their collectives by hand
(``models/tensor_parallel.py``), one collective or a conjugate pair at
each point where the reference puts a hint. :func:`resolve_hint` gives
the spec the reference's hint would constrain to.

What runs under which axis (:func:`check_runnable`): the dense, vlm,
hybrid and audio families run a model axis, with or without sequence
parallelism (``seq_axis``), an fsdp axis and batch axes of any size
(each rank its rows of the batch); the pod and data replica policies of
the federated round step run every family. The xlstm family under a
model, seq or fsdp axis comes with ROADMAP.md queue 1 item 12b-1b-2b;
the moe family under a model or fsdp axis and the 2-D ``ep2d`` layout
with item 12b-1c.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

Logical = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis name, or a tuple of
    names (split over their product, row-major); trailing dims past the
    spec's length are replicated. ``PartitionSpec("model", None)``. A
    tuple of one name is that name, and an empty one None, as JAX's spec
    normalises them."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1
            else None if p == () else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingPolicy:
    """Resolution table from logical dims to mesh axes, field for field
    the reference's.

    batch_axes: axes the global batch is split over, e.g. ("data",) or
        ("pod", "data").
    model_axis: tensor-parallel axis name ("model") or None.
    fsdp_axes: axes params are ZeRO-sharded over, or None.
    seq_axis: axis the sequence dim of activations is split over between
        blocks (sequence parallelism, Korthikanti et al.); the model
        axis when on.
    mesh: the mesh; None resolves everything to unsharded.
    ep2d_axis: the 2-D expert layout's expert axis (serving moe).
    """
    mesh: Optional[Any] = None
    batch_axes: Optional[Tuple[str, ...]] = None
    model_axis: Optional[str] = None
    fsdp_axes: Optional[Tuple[str, ...]] = None
    seq_axis: Optional[str] = None
    ep2d_axis: Optional[str] = None

    @property
    def replicas_only(self) -> bool:
        """True when no model, fsdp, seq or ep2d axis is set: every rank
        holds whole models (the federated round step's policies)."""
        return (self.model_axis is None and not self.fsdp_axes
                and self.seq_axis is None and self.ep2d_axis is None)

    # ---- axis arithmetic -------------------------------------------------
    def axis_size(self, axes: Logical) -> int:
        if self.mesh is None or axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def batch_size_divisor(self) -> int:
        return self.axis_size(self.batch_axes)

    # ---- logical -> physical ---------------------------------------------
    def dim(self, logical: Optional[str], size: Optional[int] = None) -> Logical:
        """Resolve one tensor dim; ``size`` (if given) gates divisibility."""
        if self.mesh is None or logical is None:
            return None
        axes = {"batch": self.batch_axes, "model": self.model_axis,
                "fsdp": self.fsdp_axes, "seq": self.seq_axis}.get(logical)
        if axes is None:
            return None
        if size is not None and size % self.axis_size(axes) != 0:
            return None
        if isinstance(axes, tuple) and len(axes) == 1:
            return axes[0]
        return axes

    def spec(self, *logical_dims) -> PartitionSpec:
        """A PartitionSpec from logical dim names (or (name, size))."""
        return PartitionSpec(*(self.dim(d[0], d[1]) if isinstance(d, tuple)
                               else self.dim(d) for d in logical_dims))

    def named(self, *logical_dims) -> Optional["NamedSharding"]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*logical_dims))


# A policy that shards nothing.
UNSHARDED = ShardingPolicy()


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: :meth:`placements` gives, for each mesh axis in
    order, ``Shard(d)`` for the tensor dim ``d`` split over it, else
    ``Replicate()`` (``torch.distributed.tensor``'s placements, as a
    ``DTensor`` over the same mesh would carry them)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, s in enumerate(self.spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def resolve_hint(policy: ShardingPolicy, shape, *logical_dims,
                 force: bool = False) -> Optional[PartitionSpec]:
    """The spec the reference's ``shard_hint`` constrains a tensor of
    ``shape`` to, or None where it emits no constraint (no mesh; every
    dim unsharded and not ``force``). Each dim's size gates its axis."""
    if policy.mesh is None:
        return None
    if len(logical_dims) != len(shape):
        raise ValueError(f"shard_hint rank mismatch: {len(logical_dims)} "
                         f"dims for shape {tuple(shape)}")
    resolved = [policy.dim(d[0], d[1]) if isinstance(d, tuple)
                else policy.dim(d, size)
                for d, size in zip(logical_dims, shape, strict=True)]
    if not force and all(r is None for r in resolved):
        return None
    return PartitionSpec(*resolved)


def shard_hint(x, policy: ShardingPolicy, *logical_dims, force: bool = False):
    """The reference's sharding constraint: ``x`` itself. The port's
    ranks hold ``x`` already laid out (the models place the collectives
    by hand); the hint is checked (a rank mismatch raises, catching a
    refactor that desyncs it) and resolved as the reference would
    (:func:`resolve_hint`)."""
    resolve_hint(policy, tuple(x.shape), *logical_dims, force=force)
    return x


def make_policy(mesh, fsdp: bool = False,
                seq_shard: bool = False) -> ShardingPolicy:
    """Standard policy for a mesh over ([pod,] data, model) axes, as the
    production mesh (``launch.mesh.make_production_mesh``) has them."""
    if mesh is None:
        return UNSHARDED
    names = tuple(mesh.axis_names)
    batch = tuple(a for a in names if a in ("pod", "data"))
    model = "model" if "model" in names else None
    return ShardingPolicy(mesh=mesh, batch_axes=batch or None,
                          model_axis=model, fsdp_axes=batch if fsdp else None,
                          seq_axis=model if seq_shard else None)


# the families whose forward runs a model, seq and fsdp axis
TENSOR_PARALLEL_FAMILIES = ("dense", "vlm", "hybrid", "audio")


def check_runnable(policy: ShardingPolicy, family: str) -> None:
    """Raise NotImplementedError, naming its ROADMAP.md item, where the
    port cannot run ``family`` under ``policy``."""
    if policy.mesh is None or policy.replicas_only or family == "mlp":
        return          # the mlp's spec rule replicates every param
    if policy.ep2d_axis is not None:
        raise NotImplementedError(
            "the 2-D ep2d expert layout comes with ROADMAP.md queue 1 item "
            "12b-1c")
    if family == "moe":
        raise NotImplementedError(
            "the moe family under a model or fsdp axis (the expert-"
            "parallel island, capacity_of's policy, make_serve_step's "
            "wrapper) comes with ROADMAP.md queue 1 item 12b-1c")
    if family not in TENSOR_PARALLEL_FAMILIES:
        raise NotImplementedError(
            f"the {family} family under a model, seq or fsdp axis comes "
            f"with ROADMAP.md queue 1 item 12b-1b-2b")
