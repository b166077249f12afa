"""Sharding policy: maps *logical* tensor dims to physical mesh axes (the
single-device part of ``repro.models.sharding``).

Models never hard-code mesh axis names: they annotate tensors with
logical dims ("batch", "model", "fsdp", "seq", None) and the active
``ShardingPolicy`` resolves them. The port runs on one device, so the
only policy it builds is :data:`UNSHARDED` (``mesh is None``), under
which every hint is a no-op; the mesh policies and ``make_policy`` come
with the multi-device paths (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


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

    def axis_size(self, axes) -> int:
        """Devices along ``axes`` (a name or a tuple of names): 1 without
        a mesh or axes, as the reference's."""
        if self.mesh is None or axes is None:
            return 1
        raise NotImplementedError(
            "mesh sharding policies come with the port's multi-device "
            "paths (ROADMAP.md queue 1 item 12)")

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def batch_size_divisor(self) -> int:
        return self.axis_size(self.batch_axes)


# A policy that shards nothing: the port's only one.
UNSHARDED = ShardingPolicy()


def shard_hint(x, policy: ShardingPolicy, *logical_dims, force: bool = False):
    """The reference's sharding constraint: ``x`` itself when the policy
    has no mesh, the port's only case."""
    if policy.mesh is None:
        return x
    raise NotImplementedError(
        "mesh sharding policies come with the port's multi-device paths "
        "(ROADMAP.md queue 1 item 12)")
