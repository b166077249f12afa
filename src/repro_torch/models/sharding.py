"""Sharding policy: maps *logical* tensor dims to physical mesh axes (the
port of ``repro.models.sharding``, pod and data axes only).

Models never hard-code mesh axis names: they annotate tensors with
logical dims ("batch", "model", "fsdp", "seq", None) and the active
``ShardingPolicy`` resolves them. The port builds :data:`UNSHARDED`
(``mesh is None``) and, for the federated round step over a
:class:`~repro_torch.launch.mesh.RankMesh`, policies whose mesh carries
only ``pod`` and ``data`` axes: each rank holds whole replicas of its
client's model, so no logical dim resolves to a mesh axis and every hint
is a no-op. Tensor-parallel, FSDP, sequence and 2-D expert axes
(``make_policy`` and the model, fsdp, seq and ep2d policies) raise:
they come with ROADMAP.md queue 1 item 12b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

_NOT_PORTED = ("tensor-parallel, FSDP, sequence and 2-D expert mesh axes "
               "come with ROADMAP.md queue 1 item 12b")


@dataclass(frozen=True)
class ShardingPolicy:
    """Resolution table from logical dims to mesh axes, field for field
    the reference's; ``mesh=None`` resolves everything to unsharded."""
    mesh: Optional[Any] = None
    batch_axes: Optional[Tuple[str, ...]] = None
    model_axis: Optional[str] = None
    fsdp_axes: Optional[Tuple[str, ...]] = None
    seq_axis: Optional[str] = None
    ep2d_axis: Optional[str] = None

    @property
    def replicas_only(self) -> bool:
        """True when no model, fsdp, seq or ep2d axis is set: the only
        mesh policies the port runs."""
        return (self.model_axis is None and not self.fsdp_axes
                and self.seq_axis is None and self.ep2d_axis is None)

    def axis_size(self, axes) -> int:
        """Devices along ``axes`` (a name or a tuple of names): 1 without
        a mesh or axes; the mesh's extent for ``pod`` and ``data``."""
        if self.mesh is None or axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        if any(a not in ("pod", "data") for a in axes):
            raise NotImplementedError(_NOT_PORTED)
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

    def dim(self, logical: Optional[str]):
        """One logical dim's mesh axes (None: unsharded); raises where a
        model, fsdp, seq or ep2d axis would be used."""
        if self.mesh is None or logical is None:
            return None
        axes = {"batch": self.batch_axes, "model": self.model_axis,
                "fsdp": self.fsdp_axes, "seq": self.seq_axis}.get(logical)
        if axes is not None and logical != "batch":
            raise NotImplementedError(_NOT_PORTED)
        return axes


# A policy that shards nothing.
UNSHARDED = ShardingPolicy()


def shard_hint(x, policy: ShardingPolicy, *logical_dims, force: bool = False):
    """The reference's sharding constraint: ``x`` itself where every
    logical dim resolves to no axis (always without a mesh, and on the
    replica policies of the federated round step, whose ``batch_axes``
    are None); a dim on a mesh axis raises (ROADMAP.md queue 1 item
    12b)."""
    if policy.mesh is None:
        return x
    if len(logical_dims) != x.dim():
        raise ValueError(f"shard_hint rank mismatch: {len(logical_dims)} "
                         f"dims for shape {tuple(x.shape)}")
    if not policy.replicas_only or any(
            policy.dim(d[0] if isinstance(d, tuple) else d) is not None
            for d in logical_dims):
        raise NotImplementedError(_NOT_PORTED)
    return x
