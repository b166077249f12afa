"""Batched TPD (paper eqs. 6-7) over a placement swarm: the CUDA port of
``repro/kernels/tpd.py:batch_tpd_pallas`` (body ``_tpd_kernel``).

The kernel is ``repro_torch/csrc/tpd.cu``, written for Hopper
(``sm_90a``); its source note gives the design and the bound. It is
built at first use by :mod:`repro_torch.kernels.build` and bound
through ``ctypes``: a plain C entry point that takes the pointers and
the stream.

``batch_tpd_cuda`` launches the kernel for tensors on a CUDA device and
hands tensors on the CPU to the plain torch versions; it never falls
back from the card to the host. Given the trainer leaf loads it takes
the TPU kernel's operands; without them (``leaf_load=None``) the one
launch also builds them from the placements. ``batch_tpd_cuda.launches``
counts launches, ``batch_tpd_cuda.routes`` launches by route.

Beside the kernel, in torch ops on the caller's device:

* :func:`tpd_kernel_inputs` — the static per-hierarchy operands;
* :func:`leaf_loads` — the trainer load of every leaf aggregator, the
  counterpart of the host numpy prefix-sum in the reference's
  ``CostModel._make_pallas_tpd``, and the plain version of the kernel's
  leaf stage;
* :func:`launch_plan` — the route, block size and memory of a launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import tpd_ref

SOURCE = CSRC_DIR / "tpd.cu"
MAX_DEPTH = 32                 # kMaxDepth in csrc/tpd.cu
MAX_THREADS = 1024             # kMaxThreads
# the route codes 0, 1 and 2 of the kernel: leaf loads given, built in
# shared memory, built in a scratch tensor
ROUTES = ("given", "shared", "scratch")
H100_SMS = 132
# threads a block once a swarm has more than two particles an SM: smaller
# blocks keep more of them resident (chip_smoke.py phase 9 times 256, 512
# and 1024 at P = 1000)
CROWDED_THREADS = {"given": 256, "shared": 512, "scratch": 512}
SMEM_PER_BLOCK = 227 * 1024    # H100: the most one block may take
# the kernel's static shared memory (the level maxima and starts, the
# scan's warp totals: 400 bytes in the sm_90a build), rounded up;
# chip_smoke.py holds the build's to it
STATIC_SMEM = 512
# the most slots the kernel takes: 8 bytes a slot of the 227 KB a block
# may use, less 1 KB (the placement row in shared memory takes 4 of them)
MAX_SLOTS = (232448 - 1024) // 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: ``route`` (one of :data:`ROUTES`), ``threads``
    a block (one block a particle), ``smem_bytes`` of dynamic shared
    memory a block and ``scratch_words`` of 4 bytes a particle in the
    scratch tensor (0 off the scratch route)."""
    route: str
    threads: int
    smem_bytes: int
    scratch_words: int


def work_words(C: int, L: int) -> int:
    """4-byte words of the leaf stage's work area (the kernel's
    ``work_words``): the leaf row, the C-bit bitmap of placed ids, the
    rank of each bitmap word and the ranked payloads."""
    return L + 2 * -(-C // 32) + C


def launch_plan(P: int, D: int, C: int, L: int, build: bool,
                sms: int = H100_SMS) -> LaunchPlan:
    """The launch for P particles of D slots, C clients and L leaves on
    a card of ``sms`` SMs.

    ``build`` (no leaf loads given): a copy of mdatasize and the leaf
    stage's work area go to shared memory beside the placement row where
    all three fit a block; else the work area goes to a scratch tensor
    and mdatasize is read where it lies. A block has a thread a slot,
    and when it builds the leaf loads a warp a bitmap word (the
    compaction's unit), up to :data:`MAX_THREADS`; past two particles an
    SM, at most :data:`CROWDED_THREADS` of its route.
    """
    words = work_words(C, L)
    shared = 4 * (D + C + words)
    route = "given" if not build else \
        "shared" if shared <= SMEM_PER_BLOCK - STATIC_SMEM else "scratch"
    items = max(D, 32 * -(-C // 32)) if build else D
    threads = min(MAX_THREADS, 32 * -(-items // 32))
    if P > 2 * sms:
        threads = min(threads, CROWDED_THREADS[route])
    if route == "given":
        return LaunchPlan(route, threads, 4 * D, 0)
    if route == "shared":
        return LaunchPlan(route, threads, shared, 0)
    return LaunchPlan(route, threads, 4 * D, words)


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
    """(P, D) int placements, (C,) f32 payloads (or (P, C): one row a
    particle) -> (P, L) f32 trainer loads per leaf aggregator, on the
    placements' device.

    The canonical trainer split: every unplaced client, ranked in
    ascending id order, goes to leaf ``rank % L``. Each leaf adds its
    trainers' payloads in float64 in ascending id order, the order in
    which ``np.bincount`` adds them, then rounds to float32; so the
    result equals the reference's host prefix-sum bit for bit whatever
    the payloads.
    """
    P, C = placements.shape[0], mds.shape[-1]
    dev = placements.device
    placed = torch.zeros((P, C), dtype=torch.bool, device=dev)
    placed.scatter_(1, placements.long(), True)
    unplaced = ~placed
    depth = -(-C // n_leaves)          # trainers a leaf has at most
    # every unplaced client's payload at its rank; the placed ones all
    # land in one last column, which is dropped
    ranks = torch.where(unplaced, torch.cumsum(unplaced, dim=1) - 1,
                        depth * n_leaves)
    ranked = torch.zeros((P, depth * n_leaves + 1), dtype=torch.float64,
                         device=dev)
    ranked.scatter_(1, ranks, mds.to(torch.float64).expand(P, C))
    ranked = ranked[:, :-1].reshape(P, depth, n_leaves)
    out = torch.zeros((P, n_leaves), dtype=torch.float64, device=dev)
    for k in range(depth):             # ranks j, j + L, ... in order
        out = out + ranked[:, k]
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpd_launch.argtypes = [ptr] * 7 + [ctypes.POINTER(i32)] \
        + [i32] * 7 + [ctypes.c_float, ptr]
    lib.tpd_launch.restype = i32
    lib.tpd_smem_bytes.argtypes = [i32] * 4
    lib.tpd_smem_bytes.restype = i64
    lib.tpd_scratch_words.argtypes = [i32] * 2
    lib.tpd_scratch_words.restype = i64
    lib.tpd_static_smem_bytes.argtypes = []
    lib.tpd_static_smem_bytes.restype = i32
    lib.tpd_error_string.argtypes = [i32]
    lib.tpd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                   penalty: float = 0.0, leaf_out=None) -> torch.Tensor:
    """placements (P, D) int32, attrs (3, C) f32, leaf_load (P, L) f32
    or None, and the operands of :func:`tpd_kernel_inputs` -> (P,) f32
    TPDs.

    ``leaf_load=None`` asks for the canonical trainer split of the
    unplaced clients, :func:`leaf_loads` of the placements, with L from
    the level starts; a (P, L) f32 ``leaf_out`` then receives those leaf
    loads (how the tests read them). On a CUDA device this launches the
    kernel on the current stream (asynchronously; the output, and on the
    scratch route the scratch tensor, are allocated here); without
    ``leaf_load`` the same launch builds the leaf loads. On the CPU it
    returns :func:`tpd_ref` of the same operands, with
    :func:`leaf_loads` in place of a missing ``leaf_load``.
    """
    dev = placements.device
    starts = tuple(int(b) for b in level_starts)
    if leaf_load is not None and leaf_out is not None:
        raise ValueError("leaf_out receives built leaf loads; leaf_load "
                         "was given")
    if dev.type == "cpu":
        if leaf_load is None:
            leaf_load = leaf_loads(placements, attrs[0],
                                   starts[-1] - starts[-2])
            if leaf_out is not None:
                leaf_out.copy_(leaf_load)
        return tpd_ref(placements, attrs, leaf_load, kids, starts,
                       penalty=penalty)
    if dev.type != "cuda":
        raise ValueError(f"batch_tpd_cuda runs on cuda or cpu, not {dev}")
    if placements.dim() != 2 or attrs.dim() != 2 or kids.dim() != 2:
        raise ValueError("placements, attrs and kids must be 2-D")
    P, D = placements.shape
    C, W = attrs.shape[1], kids.shape[1]
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
    L = D - starts[-2]
    _check("placements", placements, torch.int32, (P, D), dev)
    _check("attrs", attrs, torch.float32, (3, C), dev)
    if leaf_load is not None:
        _check("leaf_load", leaf_load, torch.float32, (P, L), dev)
    if leaf_out is not None:
        _check("leaf_out", leaf_out, torch.float32, (P, L), dev)
    _check("kids", kids, torch.int32, (D, W), dev)
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    plan = launch_plan(P, D, C, L, build=leaf_load is None,
                       sms=_sms(dev))
    scratch = torch.empty((P, plan.scratch_words), dtype=torch.float32,
                          device=dev) if plan.scratch_words else None
    lib = _library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.tpd_launch(
            placements.data_ptr(), attrs.data_ptr(), ptr(leaf_load),
            kids.data_ptr(), ptr(scratch), ptr(leaf_out), out.data_ptr(),
            (ctypes.c_int * (depth + 1))(*starts), P, D, C, W, depth,
            plan.threads, ROUTES.index(plan.route), float(penalty), stream)
    if code != 0:
        raise RuntimeError(f"TPD kernel launch failed: "
                           f"{lib.tpd_error_string(code).decode()} ({code})")
    batch_tpd_cuda.launches += 1
    batch_tpd_cuda.routes[plan.route] += 1
    return out


batch_tpd_cuda.launches = 0
batch_tpd_cuda.routes = dict.fromkeys(ROUTES, 0)
