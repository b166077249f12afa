"""Batched TPD (paper eqs. 6-7) over a placement swarm: the CUDA port of
``repro/kernels/tpd.py:batch_tpd_pallas`` (body ``_tpd_kernel``).

The kernel is ``repro_torch/csrc/tpd.cu``, written for Hopper
(``sm_90a``); its source note gives the design and the bound. It is
built at first use by :mod:`repro_torch.kernels.build` and bound
through ``ctypes``: a plain C entry point that takes the pointers and
the stream.

``batch_tpd_cuda`` launches the kernel for tensors on a CUDA device and
hands tensors on the CPU to the plain torch version,
:func:`repro_torch.kernels.ref.tpd_ref`; it never falls back from the
card to the host. ``batch_tpd_cuda.launches`` counts launches.

Around the kernel, in torch ops on the caller's device:

* :func:`tpd_kernel_inputs` — the static per-hierarchy operands;
* :func:`leaf_loads` — the trainer load of every leaf aggregator, the
  counterpart of the host numpy prefix-sum in the reference's
  ``CostModel._make_pallas_tpd``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import tpd_ref

SOURCE = CSRC_DIR / "tpd.cu"
MAX_DEPTH = 32                 # kMaxDepth in csrc/tpd.cu
# placement row + delays in dynamic shared memory: 8 bytes a slot out of
# the 227 KB a block may use, less room for the kernel's static arrays
MAX_SLOTS = (232448 - 1024) // 8


def tpd_kernel_inputs(hierarchy, device="cuda"):
    """Static operands for one hierarchy: ``(kids, level_starts)``.

    kids (D, W) int32 child slots on ``device``, -1 where a slot has
    fewer than W child slots; level_starts a tuple of depth + 1 ints on
    the host — level ``l`` is the slot range
    ``level_starts[l]:level_starts[l + 1]`` and the last level holds the
    leaf aggregators. The kernel takes the level starts as launch
    arguments, so neither it nor the plain version reads them from the
    device.
    """
    kids = torch.as_tensor(hierarchy.kids_table.astype(np.int32),
                           device=resolve_device(device))
    return kids, tuple(int(b) for b in hierarchy.level_starts)


def leaf_loads(placements: torch.Tensor, mds: torch.Tensor,
               n_leaves: int) -> torch.Tensor:
    """(P, D) int placements, (C,) f32 payloads -> (P, L) f32 trainer
    loads per leaf aggregator, on the placements' device.

    The canonical trainer split: every unplaced client, ranked in
    ascending id order, goes to leaf ``rank % L``. Sums accumulate in
    float64, as ``np.bincount`` does, then round to float32. For a pool
    whose payloads span a few binary orders of magnitude every float64
    sum is exact, so the result does not depend on the order the
    device's atomics add in.
    """
    P, C = placements.shape[0], mds.shape[0]
    dev = placements.device
    placed = torch.zeros((P, C), dtype=torch.int32, device=dev)
    placed.scatter_(1, placements.long(), 1)
    unplaced = placed == 0
    rank = torch.cumsum(unplaced, dim=1, dtype=torch.int64) - 1
    bins = torch.remainder(rank, n_leaves) \
        + n_leaves * torch.arange(P, device=dev)[:, None]
    t_mds = torch.where(unplaced, mds.to(torch.float64)[None], 0.0)
    out = torch.zeros(P * n_leaves, dtype=torch.float64, device=dev)
    out.index_add_(0, bins.reshape(-1), t_mds.reshape(-1))
    return out.view(P, n_leaves).to(torch.float32)


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tpd_launch.argtypes = [ptr] * 5 + [ctypes.POINTER(i32)] \
        + [i32] * 5 + [ctypes.c_float, ptr]
    lib.tpd_launch.restype = i32
    lib.tpd_error_string.argtypes = [i32]
    lib.tpd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, placements on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def batch_tpd_cuda(placements, attrs, leaf_load, kids, level_starts, *,
                   penalty: float = 0.0) -> torch.Tensor:
    """placements (P, D) int32, attrs (3, C) f32, leaf_load (P, L) f32
    and the operands of :func:`tpd_kernel_inputs` -> (P,) f32 TPDs.

    On a CUDA device this launches the kernel on the current stream
    (asynchronously; the output is allocated here). On the CPU it
    returns :func:`tpd_ref` of the same operands.
    """
    dev = placements.device
    if dev.type == "cpu":
        return tpd_ref(placements, attrs, leaf_load, kids, level_starts,
                       penalty=penalty)
    if dev.type != "cuda":
        raise ValueError(f"batch_tpd_cuda runs on cuda or cpu, not {dev}")
    if placements.dim() != 2 or attrs.dim() != 2 or kids.dim() != 2:
        raise ValueError("placements, attrs and kids must be 2-D")
    P, D = placements.shape
    C, W = attrs.shape[1], kids.shape[1]
    starts = tuple(int(b) for b in level_starts)
    depth = len(starts) - 1
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {MAX_DEPTH}], got {depth}")
    if starts[0] != 0 or starts[-1] != D or any(
            a >= b for a, b in zip(starts, starts[1:])):
        raise ValueError(f"level_starts {starts} do not split {D} slots "
                         f"into non-empty levels")
    if D > MAX_SLOTS:
        raise ValueError(f"{D} slots exceed the kernel's shared-memory "
                         f"row of {MAX_SLOTS}")
    _check("placements", placements, torch.int32, (P, D), dev)
    _check("attrs", attrs, torch.float32, (3, C), dev)
    _check("leaf_load", leaf_load, torch.float32, (P, D - starts[-2]), dev)
    _check("kids", kids, torch.int32, (D, W), dev)
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.tpd_launch(
            placements.data_ptr(), attrs.data_ptr(), leaf_load.data_ptr(),
            kids.data_ptr(), out.data_ptr(), (ctypes.c_int * (depth + 1))(
                *starts), P, D, C, W, depth, float(penalty), stream)
    if code != 0:
        raise RuntimeError(f"TPD kernel launch failed: "
                           f"{lib.tpd_error_string(code).decode()} ({code})")
    batch_tpd_cuda.launches += 1
    return out


batch_tpd_cuda.launches = 0
