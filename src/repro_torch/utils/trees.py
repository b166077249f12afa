"""Helpers over parameter trees: nests of dicts and lists of tensors.

The port's counterpart of ``repro.utils.trees``. A tree is what the
reference calls a pytree, restricted to what the port's models hold:
dicts (walked in sorted key order, as ``jax.tree`` walks them), lists
and tuples, with tensors at the leaves. So the leaf order, and with it
the flat layout below, is the reference's.

:func:`flatten_tree` packs a tree's leaves into one contiguous buffer
whose last dimension is the concatenation of the flattened leaves;
:func:`unflatten_tree` hands back a tree of views into such a buffer.
Leading dimensions ride along, so a ``(C, N)`` buffer unflattens into a
client-stacked tree of ``(C, ...)`` views. The FedAvg aggregator and
``kernels.ops.fedavg_tree`` share these.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def tree_flatten(tree) -> Tuple[list, Callable]:
    """``(leaves, rebuild)``: ``rebuild(new_leaves)`` is a tree of the
    same structure holding ``new_leaves``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]
    kind = type(tree)

    def rebuild(flat):
        out, at = [], 0
        for (_, sub), n in zip(parts, counts, strict=True):
            out.append(sub(flat[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out, strict=True))
        return kind(out)

    return leaves, rebuild


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others, strict=True)])


def tree_map_with_path(fn, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *others)`` over a tree's leaves, ``path`` the
    keys (and list indices) down to the leaf joined by "/" (the
    reference's ``_path_str`` of ``jax.tree_util`` key paths)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      prefix=f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, x, *(r[i] for r in rest),
                               prefix=f"{prefix}{i}/")
            for i, x in enumerate(tree))
    return fn(prefix[:-1], tree, *rest)


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree (each leaf at its own dtype)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_weighted_sum(trees, weights):
    """sum_i weights[i] * trees[i], leaf by leaf in plain torch ops (the
    reference's FedAvg primitive; the port's kernels are held to it)."""
    def _leaf(*leaves):
        stacked = torch.stack(leaves)
        w = torch.as_tensor(np.asarray(weights), device=stacked.device)
        w = w.to(stacked.dtype).reshape((-1,) + (1,) * (stacked.dim() - 1))
        return torch.sum(stacked * w, dim=0)

    return tree_map(_leaf, *trees)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (``repro.utils.trees.tree_global_norm``), a 0-dim float32 tensor."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(sums))


def _spec_axes(spec) -> frozenset:
    """The mesh axes a PartitionSpec splits its tensor over."""
    out = set()
    for entry in spec:
        if isinstance(entry, str):
            out.add(entry)
        elif entry is not None:
            out.update(entry)
    return frozenset(out)


def sharded_global_norm(tree, pspecs, mesh) -> torch.Tensor:
    """:func:`tree_global_norm` of the global tree whose shards this rank
    of ``mesh`` (a ``launch.mesh.RankMesh``) holds, ``pspecs`` their
    specs: each leaf's float32 sum of squares is summed over the mesh
    axes that split it and counted once over the axes that replicate
    it. The leaves are grouped by their split axes; one all-reduce an
    axis sums the groups that axis splits. The same value on every
    rank."""
    groups = {}

    def add(path, x, spec):
        key = _spec_axes(spec)
        s = torch.sum(torch.square(x.float()))
        groups[key] = groups[key] + s if key in groups else s

    tree_map_with_path(add, tree, pspecs)
    keys = sorted(groups, key=lambda k: sorted(k))
    sums = torch.stack([groups[k] for k in keys])
    for axis in mesh.axis_names:
        hit = torch.tensor([axis in k for k in keys], device=sums.device)
        if mesh.shape[axis] > 1 and bool(hit.any()):
            part = mesh.all_reduce_(torch.where(hit, sums, 0.0), axis)
            sums = torch.where(hit, part, sums)
    return torch.sqrt(sums.sum())


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_stack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading
    dim (``jax.tree.map(jnp.stack ...)``)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree) -> list:
    """A tree with a leading dim as a list of trees, one per index,
    from one ``unbind`` per leaf: the backward of ``x[i]`` writes a zero
    tensor the size of the whole leaf for every ``i``, the backward of
    ``unbind`` one."""
    leaves, rebuild = tree_flatten(tree)
    if not leaves:
        return []
    per_leaf = [x.unbind(0) for x in leaves]
    return [rebuild([parts[i] for parts in per_leaf])
            for i in range(leaves[0].shape[0])]


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.allclose(_np(x), _np(y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb, strict=True))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# flat layout
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TreeLayout:
    """Where each leaf lives in a flat buffer's last dimension."""
    rebuild: Callable
    shapes: Tuple[tuple, ...]       # per-leaf shape, leading dims excluded
    offsets: Tuple[int, ...]
    numel: int                      # N, the flat width


def tree_layout(tree, lead: int = 0) -> TreeLayout:
    """The layout of ``tree``'s leaves with ``lead`` leading dims that
    the flat buffer keeps (0 for one model, 1 for a client stack)."""
    leaves, rebuild = tree_flatten(tree)
    shapes = tuple(tuple(x.shape[lead:]) for x in leaves)
    sizes = [int(np.prod(s)) for s in shapes]
    offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    return TreeLayout(rebuild, shapes, offsets, int(sum(sizes)))


def flatten_tree(tree, layout: Optional[TreeLayout] = None, *,
                 lead: int = 0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack ``tree`` into a ``(*lead_shape, N)`` buffer (``out`` when
    given, else a new one on the first leaf's device and dtype)."""
    leaves = tree_leaves(tree)
    layout = layout if layout is not None else tree_layout(tree, lead)
    lead_shape = tuple(leaves[0].shape[:lead])
    if out is None:
        out = torch.empty(lead_shape + (layout.numel,),
                          dtype=leaves[0].dtype, device=leaves[0].device)
    for x, view in zip(leaves, tree_leaves(unflatten_tree(out, layout)),
                       strict=True):
        view.copy_(x)
    return out


def unflatten_tree(flat: torch.Tensor, layout: TreeLayout):
    """A tree of views into ``flat`` (``(*lead, N)``): writing a leaf
    writes the buffer."""
    lead = tuple(flat.shape[:-1])
    views: List[torch.Tensor] = []
    for shape, off in zip(layout.shapes, layout.offsets, strict=True):
        size = int(np.prod(shape))
        views.append(flat[..., off:off + size].view(lead + shape))
    return layout.rebuild(views)


def flat_buffer_of(tree, layout: Optional[TreeLayout] = None, *,
                   lead: int = 0) -> Optional[torch.Tensor]:
    """The ``(*lead_shape, N)`` buffer whose :func:`unflatten_tree` views
    ``tree``'s leaves are, when they are such views (one storage, in
    layout order, no gaps); else None. ``lead`` counts the leading dims
    the buffer keeps (1 for a client stack)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return None
    layout = layout if layout is not None else tree_layout(tree, lead)
    first = leaves[0]
    shape = tuple(first.shape[:lead]) + (layout.numel,)
    storage = first.untyped_storage()
    end = (first.storage_offset() + int(np.prod(shape))) \
        * first.element_size()
    if storage.nbytes() < end:
        return None
    flat = first.new_empty(0).set_(storage, first.storage_offset(), shape)
    return flat if is_view_of(tree, flat, layout) else None


def is_view_of(tree, flat: torch.Tensor, layout: TreeLayout) -> bool:
    """Is every leaf of ``tree`` exactly the view :func:`unflatten_tree`
    gives of ``flat``? (Then the buffer already holds the tree.)"""
    leaves = tree_leaves(tree)
    views = tree_leaves(unflatten_tree(flat, layout))
    return len(leaves) == len(views) and all(
        x.data_ptr() == v.data_ptr() and x.shape == v.shape
        and x.stride() == v.stride() and x.dtype == v.dtype
        for x, v in zip(leaves, views, strict=True))
