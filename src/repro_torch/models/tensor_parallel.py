"""Tensor and sequence parallelism over a rank mesh's model axis.

Each rank of a :class:`~repro_torch.launch.mesh.RankMesh` holds its own
shard of the params, cut by the model's ``param_pspecs``
(:func:`shard_params`, or drawn shard by shard at init), and runs the
model on local tensors. Where the reference marks a layout change with
``shard_hint`` and lets GSPMD place the collective, the port places one
collective by hand, as an autograd function whose backward is its
conjugate (Megatron-LM's column- and row-parallel pairs, Shoeybi et
al.; sequence parallelism, Korthikanti et al.):

==============  =========================  ===========================
function        forward                    backward
==============  =========================  ===========================
``copy``        identity                   all-reduce (sum)
``reduce``      all-reduce (sum)           identity
``gather_seq``  all-gather along S         reduce-scatter along S
``scatter_seq`` reduce-scatter along S     all-gather along S
``split_seq``   this rank's slice of S     all-gather along S
``gather_rep``  all-gather along S         this rank's slice of S
==============  =========================  ===========================

Every rank computes one replicated loss, so the backward of a
replicated tensor that several ranks read in part (the input of a
column-parallel product) sums their parts (``copy``), and the backward
of a sum the ranks' partial products made (``reduce``) passes the
loss's one gradient to each part. Every sum runs in float32: a bf16
operand (attention's output, an activation's gradient) is widened,
summed and rounded back once. That is twice gloo's bytes of a bf16 sum;
a bf16 sum (gloo's ring rounds at each of its M - 1 steps) put reduced
granite-8b's loss 1.2e-3 from the reference's own sharded run, against
6.2e-5 with float32 sums and the reference's own sharded-to-unsharded
gap of 3.9e-4 (``tests/test_torch_tensor_parallel.py``).

The same pairs serve the batch and fsdp axes (:class:`AxisGroup`, over
one mesh axis or several, row-major): ``gather_seq`` of a weight along
the dim its spec splits over the fsdp axes is the ZeRO gather, whose
backward reduce-scatters its gradient in float32; ``copy`` of a leaf
replicated over batch axes sums its gradient over them; ``reduce`` of
each rank's share of the loss gives the global batch's mean.

Every rank issues the collectives of a forward, and of its backward, in
one order (the graphs are the same on every rank); with ``cfg.remat``
``torch.utils.checkpoint`` replays the forward's collectives in the
backward, in order too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.sharding import PartitionSpec, ShardingPolicy
from repro_torch.utils.trees import tree_map_with_path


class AxisGroup:
    """One rank's place on a tuple of mesh axes (their product, row-major,
    as a spec entry of several names splits a dim), and the collectives
    over it: a sum runs over each axis in turn, a gather the last axis
    first and a scatter the first axis first, so a row-major split comes
    back in order. With no axes (or axes of one rank) every collective
    is the identity."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = tuple(a for a in entry_axes(axes) if mesh.shape[a] > 1)
        self.size = math.prod(mesh.shape[a] for a in self.axes)
        self.index = 0
        for a in self.axes:
            self.index = self.index * mesh.shape[a] + mesh.axis_index(a)

    def part(self, n: int) -> slice:
        """This rank's slice of ``n`` entries split over the axes."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    # ---- plain collectives (no autograd) ------------------------------
    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axes of ``x``, in float32, in ``x``'s dtype
        (a new tensor)."""
        y = x.to(torch.float32, copy=True).contiguous()
        for a in self.axes:
            y = self.mesh.all_reduce_(y, a)
        return y.to(x.dtype)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone().contiguous()
        for a in self.axes:
            y = self.mesh.all_reduce_(y, a, "max")
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        for a in reversed(self.axes):
            x = self.mesh.all_gather(x, a, dim)
        return x

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of the sum over the axes, in
        float32, in ``x``'s dtype."""
        y = x.float()
        for a in self.axes:
            y = self.mesh.reduce_scatter(y, a, dim)
        return y.to(x.dtype)

    def slice_(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.narrow(dim, self.index * (x.shape[dim] // self.size),
                        x.shape[dim] // self.size).contiguous()

    # ---- autograd pairs -------------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def gather_seq(self, x, dim: int = 1):
        return _GatherSeq.apply(x, self, dim)

    def scatter_seq(self, x, dim: int = 1):
        return _ScatterSeq.apply(x, self, dim)

    def split_seq(self, x, dim: int = 1):
        return _SplitSeq.apply(x, self, dim)

    def gather_rep(self, x, dim: int = 1):
        return _GatherRep.apply(x, self, dim)


class TensorParallel(AxisGroup):
    """One rank's place on the model axis of ``policy``'s rank mesh,
    and the collectives over that axis (none without one)."""

    def __init__(self, policy: ShardingPolicy):
        super().__init__(policy.mesh, policy.model_axis)
        self.axis = policy.model_axis
        self.seq = policy.seq_axis is not None

    def seq_on(self, s: int) -> bool:
        """Whether a sequence of ``s`` positions lives S-split between
        blocks: sequence parallelism is on and ``s`` divides (the
        reference's ``dim("seq", s)`` gate; decode's S of 1 never
        splits)."""
        return self.seq and s % self.size == 0


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum_(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum_(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.scatter_sum(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.scatter_sum(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather(g, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.slice_(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather(g, ctx.dim), None, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.slice_(g, ctx.dim), None, None


# ---------------------------------------------------------------------------
# params: cut into one rank's shards, gathered back
# ---------------------------------------------------------------------------
def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry: None, a name or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """``shape``'s local shape under ``spec``; raises where a split dim
    does not divide."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def local_slice(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``spec`` (a new
    contiguous tensor): along each split dim, the slice at this rank's
    row-major coordinate over the dim's axes."""
    local = local_shape(tuple(x.shape), spec, mesh)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.axis_index(a)
        x = x.narrow(d, i * local[d], local[d])
    return x.clone(memory_format=torch.contiguous_format)


def shard_params(params, pspecs, mesh):
    """This rank's shards of a full param tree (the JAX-to-port
    converter's, ``core.state.params_from_numpy``), cut by ``pspecs``
    (``Model.param_pspecs()``)."""
    return tree_map_with_path(
        lambda path, x, spec: local_slice(x, spec, mesh), params, pspecs)


def gather_params(local, pspecs, mesh):
    """The full tree from every rank's shards (each rank gets it, new
    tensors outside autograd): along each split dim an all-gather over
    its axes, the last axis first."""

    def one(path, x, spec):
        x = x.detach()
        for d, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                x = mesh.all_gather(x, a, d)
        return x

    with torch.no_grad():
        return tree_map_with_path(one, local, pspecs)
