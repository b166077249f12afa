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

:class:`RankShards` is what every family's sharded model shares: a
rank's batch rows, its fsdp gathers, its vocab rows (the split
embedding, logits and cross-entropy) and the column- and row-parallel
entry and exit of the stream. The families subclass it:
``transformer_tp.py`` (dense, vlm), ``rglru_tp.py`` (hybrid) and
``encdec_tp.py`` (audio). A replicated tensor carries its whole
gradient on every rank; a split one, its rank's part.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.sharding import PartitionSpec, ShardingPolicy, check_runnable
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


# ---------------------------------------------------------------------------
# one rank's part of a model: what every family shares
# ---------------------------------------------------------------------------
class RankShards:
    """The model ``cfg`` on this rank of ``policy``'s mesh: its batch
    rows, its fsdp shards and its vocab rows. ``spec_rule`` is the
    family's param rule and ``shapes`` its global param tree on the meta
    device; a leaf under one of :attr:`STACKED`'s prefixes stacks layers
    on a leading dim."""

    STACKED: tuple = ()

    def __init__(self, cfg: ModelConfig, policy: ShardingPolicy, spec_rule,
                 shapes):
        check_runnable(policy, cfg.family)
        self.cfg, self.policy = cfg, policy
        self.tp = TensorParallel(policy)
        mesh = policy.mesh
        self.batch = AxisGroup(mesh, policy.batch_axes)
        self.fsdp = AxisGroup(mesh, policy.fsdp_axes)
        if not set(self.fsdp.axes) <= set(self.batch.axes):
            raise ValueError(f"fsdp axes {policy.fsdp_axes} must split the "
                             f"batch (batch axes {policy.batch_axes})")
        self.require(("padded vocab", cfg.padded_vocab))
        self.spec_rule = spec_rule
        # per leaf path: the dim its spec splits over the fsdp axes (a
        # layer's, unstacked), and the group its gradient sums over (the
        # batch axes that do not split it)
        self.fsdp_dims, self.grad_sums = {}, {}
        fsdp_entry = set(self.fsdp.axes)

        def leaf(path, x):
            spec = spec_rule(path, tuple(x.shape))
            lead = 1 if self.stacked(path) else 0
            split = set()
            for d, entry in enumerate(spec):
                axes = set(entry_axes(entry))
                split |= axes
                if fsdp_entry and axes == fsdp_entry:
                    self.fsdp_dims[path] = d - lead
            self.grad_sums[path] = AxisGroup(
                mesh, tuple(a for a in self.batch.axes if a not in split))

        tree_map_with_path(leaf, shapes)
        self.vocab = cfg.padded_vocab // self.tp.size
        self.v_lo = self.tp.index * self.vocab
        self.dt = getattr(torch, cfg.dtype)

    def require(self, *sizes) -> None:
        """Raise unless each (name, size) splits over the model axis."""
        m = self.tp.size
        for name, n in sizes:
            if n % m:
                raise ValueError(f"{self.cfg.name}'s {name} {n} does not "
                                 f"split over a model axis of {m}")

    def stacked(self, path: str) -> bool:
        return path.startswith(self.STACKED)

    # ---- batch rows and fsdp shards -------------------------------------
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: its row-major part
        over the batch axes, or all ``n`` where they do not divide."""
        if n % self.batch.size:
            return slice(0, n)
        return self.batch.part(n)

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of every array of ``batch`` (dim 0)."""
        n = next(iter(batch.values())).shape[0]
        return {k: v[self.rows(n)] for k, v in batch.items()}

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The global batch's ``n`` rows (dim 0) of this rank's ``x``."""
        return x if n % self.batch.size else self.batch.gather(x, 0)

    def batch_mean(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch's mean from this rank's rows' mean ``local``
        (the same on every rank; each rank's share is its own in the
        backward). Where the batch does not divide, every rank's
        ``local`` is the whole batch's and its share is 1/D of it."""
        if self.batch.size == 1:
            return local
        return self.batch.reduce(local / self.batch.size)

    def enter_params(self, params: dict) -> dict:
        """``params`` as the loss reads them: each leaf replicated over
        batch axes passed through ``copy`` over them (one all-reduce of
        its whole gradient in the backward)."""
        if self.batch.size == 1 or not torch.is_grad_enabled():
            return params

        def one(path, x):
            group = self.grad_sums[path]
            return group.copy(x) if group.size > 1 and x.requires_grad \
                else x

        return tree_map_with_path(one, params)

    def whole(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """A leaf as its reader needs it: gathered over the fsdp axes
        along the dim they split (backward: the float32 reduce-scatter),
        else ``x``."""
        d = self.fsdp_dims.get(path)
        return x if d is None else self.fsdp.gather_seq(x, d)

    def gather_layer(self, layer: dict, prefix: Optional[str] = None) -> dict:
        """One layer's leaves (of the stack under ``prefix``, default the
        first of :attr:`STACKED`), each :meth:`whole`."""
        if not self.fsdp_dims:
            return layer
        return tree_map_with_path(self.whole, layer,
                                  prefix=prefix or self.STACKED[0])

    def cut(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a freshly drawn leaf (a layer's leaves
        unstacked), by the spec rule on the leaf's global shape."""
        shape = tuple(x.shape)
        stacked = self.stacked(path)
        spec = self.spec_rule(path, (1,) + shape if stacked else shape)
        return local_slice(x, spec[1:] if stacked else spec,
                           self.policy.mesh)

    # ---- embedding, head, loss -----------------------------------------
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The ids' rows of the vocab-split table, summed over the ranks
        (forward all-reduce, backward identity)."""
        ids = tokens.long() - self.v_lo
        inside = (ids >= 0) & (ids < self.vocab)
        table = self.whole("embed/table", params["embed"]["table"])
        rows = table[ids.clamp(0, self.vocab - 1)]
        return self.tp.reduce(rows * inside[..., None].to(rows.dtype))

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """This rank's vocab columns of the logits of ``x`` (already
        entered: gathered or copied to every rank)."""
        if self.cfg.tie_embeddings:
            return common.unembed({"table": self.whole(
                "embed/table", params["embed"]["table"])}, x)
        return common.unembed_untied({"proj": self.whole(
            "lm_head/proj", params["lm_head"]["proj"])}, x)

    def gathered_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The full logits of ``x`` (replicated, no grad) on every rank,
        the padded vocab's columns included."""
        return self.tp.gather(self.logits(params, x), -1)

    def xent(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``common.softmax_xent`` over the vocab split across the ranks:
        the padded columns masked by global index, the log-sum-exp from
        the ranks' max and their summed exponentials, the target logit
        summed from the rank that holds it."""
        logits = logits.float()
        ids = self.v_lo + torch.arange(self.vocab, device=logits.device)
        if self.cfg.padded_vocab > self.cfg.vocab_size:
            logits = torch.where(ids < self.cfg.vocab_size, logits, -1e9)
        top = self.tp.max_(logits.detach().amax(-1))
        sumexp = self.tp.reduce(torch.exp(logits - top[..., None]).sum(-1))
        lab = labels.long() - self.v_lo
        inside = (lab >= 0) & (lab < self.vocab)
        gold = torch.gather(logits, -1, lab.clamp(0, self.vocab - 1)[..., None])
        gold = self.tp.reduce(gold[..., 0] * inside.to(logits.dtype))
        return torch.mean(torch.log(sumexp) + top - gold)

    # ---- the stream -----------------------------------------------------
    def norm(self, scale_params: dict, x, seq_on: bool):
        """RMSNorm; under sequence parallelism the scale's gradient is
        summed over the ranks (each saw its own positions)."""
        if seq_on:
            scale_params = {"scale": self.tp.copy(scale_params["scale"])}
        return common.rmsnorm(scale_params, x, self.cfg.norm_eps)

    def enter(self, x, seq_on: bool):
        """A column-parallel product's input on every rank: gathered
        along S (backward: reduce-scatter), or copied (backward:
        all-reduce)."""
        return self.tp.gather_seq(x) if seq_on else self.tp.copy(x)

    def leave(self, partial, seq_on: bool, dtype):
        """A row-parallel product's partial sums, summed in float32:
        reduce-scattered along S, or all-reduced; in ``dtype``."""
        out = self.tp.scatter_seq(partial) if seq_on \
            else self.tp.reduce(partial)
        return out.to(dtype)

    def last_position(self, x, p: int, seq_on: bool):
        """Position ``p`` of the stream ``x`` as (B, 1, D) on every rank
        (``x`` this rank's S / M positions under ``seq_on``: the owner's
        row, summed over the ranks)."""
        if not seq_on:
            return x[:, p:p + 1]
        s_l = x.shape[1]
        last = torch.zeros_like(x[:, :1])
        if p // s_l == self.tp.index:
            last = x[:, p % s_l:p % s_l + 1]
        return self.tp.sum_(last)


def lazy(make):
    """A getter of ``make()``, built at its first call (a model's specs
    are read without a rank mesh, so its shards wait for one)."""
    box = []

    def get():
        if not box:
            box.append(make())
        return box[0]

    return get
