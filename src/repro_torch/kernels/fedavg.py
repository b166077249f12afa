"""Weighted FedAvg reductions: the CUDA port of both FedAvg TPU kernels,
``repro/kernels/fedavg.py:fedavg_batched_pallas`` (body
``_fedavg_batched_kernel``) and ``fedavg_pallas`` (body
``_fedavg_kernel``).

One kernel, ``repro_torch/csrc/fedavg.cu`` (its source note gives the
design and the bound), built at first use by
:mod:`repro_torch.kernels.build` and bound through ``ctypes``. It takes
a row-indexed form::

    fedavg_rows(pool (R, N), rows (G, K) int32, -1 = no row, w (G, K) f32)
        -> out (G, N),  out[g] = sum_k w[g, k] * pool[rows[g, k]]

with float32 accumulation and the output in the pool's dtype (float32
or bfloat16). The dense entry points are views of it:

* :func:`fedavg_batched` — (G, K, N) x (G, K) -> (G, N), the port of
  ``fedavg_batched_pallas`` (table row 2), is ``fedavg_rows`` over the
  stack seen as G*K rows; :func:`fedavg_rows` is the same kernel in its
  row-indexed form, which the aggregator's level reductions use. Both
  count their launches on ``fedavg_batched.launches``.
* :func:`fedavg` — (K, N) x (K,) -> (N,), the port of ``fedavg_pallas``
  (table row 3), the case G = 1; it counts on ``fedavg.launches``.

Every entry point launches the kernel for a pool on a CUDA device and
hands a pool on the CPU to its plain torch version in
:mod:`repro_torch.kernels.ref`; it never falls back from the card to
the host. ``rows`` and ``w`` may lie on the host (they are staged
through pinned memory) or on the pool's device (then the range check of
``rows`` reads them back once).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import fedavg_rows_ref

SOURCE = CSRC_DIR / "fedavg.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fedavg_rows_launch.argtypes = [ptr] * 4 + [i32, i32,
                                                   ctypes.c_longlong, i32,
                                                   ptr]
    lib.fedavg_rows_launch.restype = i32
    lib.fedavg_error_string.argtypes = [i32]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    return lib


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, contiguous; a host tensor goes through pinned
    memory, so the copy queues on the stream without stalling it."""
    if t.device == dev:
        return t.contiguous()
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(dev, non_blocking=True)


def _checked(pool, rows, w, out):
    """Validate the operands; returns ``(rows, w, out)`` as tensors,
    ``out`` allocated when not given. Raises on anything the kernel
    does not take."""
    if pool.device.type not in ("cuda", "cpu"):
        raise ValueError(f"FedAvg runs on cuda or cpu, not {pool.device}")
    if pool.dtype not in _DTYPE_CODE:
        raise TypeError(f"pool must be float32 or bfloat16, got {pool.dtype}")
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous (R, N) tensor, got "
                         f"shape {tuple(pool.shape)}"
                         + ("" if pool.is_contiguous() else ", strided"))
    rows = torch.as_tensor(rows)
    w = torch.as_tensor(w)
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if rows.dim() != 2 or tuple(w.shape) != tuple(rows.shape):
        raise ValueError(f"rows and w must both be (G, K), got "
                         f"{tuple(rows.shape)} and {tuple(w.shape)}")
    for name, t in (("rows", rows), ("w", w)):
        if t.device.type != "cpu" and t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on "
                             f"{pool.device}")
    G, K = rows.shape
    if K < 1:
        raise ValueError("K must be >= 1 (rows has no columns)")
    if rows.numel():
        lo, hi = (int(v) for v in torch.aminmax(rows))
        if lo < -1 or hi >= pool.shape[0]:
            raise ValueError(f"rows must lie in [-1, {pool.shape[0]}), got "
                             f"[{lo}, {hi}]")
    shape = (G, pool.shape[1])
    if out is None:
        out = torch.empty(shape, dtype=pool.dtype, device=pool.device)
    elif (out.device != pool.device or out.dtype != pool.dtype
          or tuple(out.shape) != shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} {pool.dtype} "
                         f"tensor on {pool.device}")
    return rows, w, out


def _reduce(pool, rows, w, out, counter) -> torch.Tensor:
    rows, w, out = _checked(pool, rows, w, out)
    dev = pool.device
    if dev.type == "cpu":
        return fedavg_rows_ref(pool, rows, w, out=out)
    rows_d, w_d = _to(rows, dev), _to(w, dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fedavg_rows_launch(
            pool.data_ptr(), rows_d.data_ptr(), w_d.data_ptr(),
            out.data_ptr(), rows.shape[0], rows.shape[1], pool.shape[1],
            _DTYPE_CODE[pool.dtype], stream)
    if code != 0:
        raise RuntimeError(f"FedAvg kernel launch failed: "
                           f"{lib.fedavg_error_string(code).decode()} "
                           f"({code})")
    counter.launches += 1
    return out


def fedavg_rows(pool: torch.Tensor, rows, w, *, out=None) -> torch.Tensor:
    """pool (R, N), rows (G, K) int32 (-1 = no row), w (G, K) f32 ->
    (G, N) in the pool's dtype, written into ``out`` when given (``out``
    may be rows of the pool that ``rows`` does not read). The
    row-indexed form of :func:`fedavg_batched`; its launches count on
    ``fedavg_batched.launches``."""
    return _reduce(pool, rows, w, out, fedavg_batched)


def fedavg_batched(stacked: torch.Tensor, w) -> torch.Tensor:
    """stacked (G, K, N), w (G, K) f32 -> (G, N): one weighted FedAvg
    reduction per cluster, all clusters in one launch; padding clusters
    and members carry zero weight."""
    if stacked.dim() != 3:
        raise ValueError(f"stacked must be (G, K, N), got "
                         f"{tuple(stacked.shape)}")
    G, K, N = stacked.shape
    rows = torch.arange(G * K, dtype=torch.int32).view(G, K)
    return _reduce(stacked.reshape(G * K, N), rows, w, None, fedavg_batched)


def fedavg(stacked: torch.Tensor, w) -> torch.Tensor:
    """stacked (K, N), w (K,) f32 -> (N,) = sum_k w_k * stacked_k."""
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be (K, N), got "
                         f"{tuple(stacked.shape)}")
    K = stacked.shape[0]
    rows = torch.arange(K, dtype=torch.int32).view(1, K)
    w = torch.as_tensor(w)
    if w.dim() != 1:
        raise ValueError(f"w must be (K,), got {tuple(w.shape)}")
    return _reduce(stacked, rows, w.view(1, -1), None, fedavg)[0]


fedavg_batched.launches = 0
fedavg.launches = 0
