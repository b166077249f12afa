"""npz-based tree checkpointing (``repro.checkpoint.store``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, as the
reference's. Leaves are stored under stable ``/``-joined key paths, the
reference's own (dict keys, list and tuple indices, NamedTuple field
names), so the port and the reference write the same key set for the
same model and optimizer. Writes are atomic (tmp dir + rename): a
killed trainer never leaves a half checkpoint behind. npz cannot hold
bfloat16, so a bfloat16 leaf is widened to float32 through torch (which
holds it exactly); restore casts back to the template leaf's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs in the reference's leaf order: dicts in
    sorted key order, lists and tuples by index, NamedTuples by field;
    None and empty containers hold no leaf."""
    def join(tok):
        return f"{prefix}/{tok}" if prefix else str(tok)

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_paths(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in leaves_with_paths(getattr(tree, f), join(f))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in leaves_with_paths(x, join(i))]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure holding the leaves of the iterator
    ``leaves``, consumed in order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _to_savable(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` (+ JSON-serializable ``extra``) at ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = {k: _to_savable(x) for k, x in leaves_with_paths(tree)}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": int(step), "keys": sorted(flat), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a template tree).

    Returns (tree, extra_meta): new tensors, each with its template
    leaf's dtype and device. Raises if the stored keys or shapes don't
    match the template's: a mismatched restore fails loudly.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        stored = {k: npz[k] for k in npz.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    template = leaves_with_paths(like)
    if {k for k, _ in template} != set(stored):
        missing = {k for k, _ in template} ^ set(stored)
        raise ValueError(f"checkpoint keys mismatch (diff: "
                         f"{sorted(missing)[:10]}...)")
    leaves = []
    for key, leaf in template:
        arr = stored[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                               dtype=leaf.dtype))
    return _rebuild(like, iter(leaves)), meta.get("extra", {})
