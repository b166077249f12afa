"""GQA flash attention forward: the CUDA port of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas`` (body
``_flash_kernel``).

One kernel, ``repro_torch/csrc/flash_attention.cu`` (its source note
gives the design and the bound), built at first use by
:mod:`repro_torch.kernels.build` and bound through ``ctypes``::

    flash_attention(q (B, Hq, S, hd), k, v (B, Hkv, S, hd), *, causal,
                    window, scale, kv_len) -> (B, Hq, S, hd)

float32 or bfloat16 (all three alike), hd 64, 128 or 256, Hq a multiple
of Hkv. The kernel masks its own ragged edge, so S need not be a
multiple of any tile and nothing is padded. A tensor on a CUDA device
launches the kernel (counted on ``flash_attention.launches``); a tensor
on the CPU goes to the plain torch version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, with the same
masks. There is no fallback from the card to the host.

The gradient. When q, k or v requires grad, ``flash_attention`` runs
through an autograd Function: the forward also keeps each row's float32
log-sum-exp (B, Hq, S), and the backward is a second source,
``repro_torch/csrc/flash_attention_bwd.cu`` (no TPU counterpart: the
reference has no backward kernel)::

    flash_attention_bwd(q, k, v, out, dout, lse, *, causal, window,
                        scale, kv_len) -> (dq, dk, dv)

two deterministic passes (dq, then dk and dv), each launch counted on
``flash_attention_bwd.launches``, with its plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

SOURCE = CSRC_DIR / "flash_attention.cu"
BWD_SOURCE = CSRC_DIR / "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 5 + [i32] * 8 + [
        ctypes.c_float, i32, ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(BWD_SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [ptr] * 10 + [i32] * 8 + [
        ctypes.c_float, i32, ptr]
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_error_string.argtypes = [i32]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window, kv_len) -> None:
    """Raise on anything the kernel does not take."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, Hq, S, hd) and k, v (B, Hkv, S, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B, S or hd")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, "
                         f"Hkv={k.shape[1]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if kv_len is not None and not 0 <= kv_len <= s:
        raise ValueError(f"kv_len must lie in [0, {s}], got {kv_len}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, S, hd); k, v (B, Hkv, S, hd) -> (B, Hq, S, hd) in q's
    dtype. Key j is visible from query i where j <= i (``causal``),
    j > i - window (``window``) and j < kv_len (``kv_len``).
    Differentiable in q, k and v."""
    _check(q, k, v, window, kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    masks = (causal, window, scale, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, masks)
    return _forward(q, k, v, masks, with_lse=False)[0]


def _forward(q, k, v, masks, with_lse: bool):
    """(out, lse or None) of one forward launch (the plain version for a
    CPU tensor)."""
    causal, window, scale, kv_len = masks
    b, hq, s, hd = q.shape
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, kv_len=kv_len,
                                       return_lse=True)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, kv_len=kv_len), None
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, hq, k.shape[1], s, hd,
            int(causal), window or 0, s if kv_len is None else kv_len,
            scale, _DTYPE_CODE[q.dtype], stream)
    if code != 0:
        raise RuntimeError(f"flash attention launch failed: "
                           f"{lib.flash_attention_error_string(code).decode()}"
                           f" ({code})")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None):
    """dq, dk, dv of :func:`flash_attention` from its operands, its
    output ``out`` and log-sum-exp ``lse`` (B, Hq, S) float32, and the
    output's gradient ``dout`` (like q); each gradient in q's dtype."""
    _check(q, k, v, window, kv_len)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor like q")
    b, hq, s, hd = q.shape
    if tuple(lse.shape) != (b, hq, s) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 (B, Hq, S) = "
                         f"{(b, hq, s)} tensor")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, window=window,
                                       scale=scale, kv_len=kv_len)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, k.shape[1], s, hd,
            int(causal), window or 0, s if kv_len is None else kv_len,
            scale, _DTYPE_CODE[q.dtype], stream)
    if code != 0:
        raise RuntimeError(
            f"flash attention backward launch failed: "
            f"{lib.flash_attention_bwd_error_string(code).decode()} ({code})")
    flash_attention_bwd.launches += 2       # the dq pass and the dk/dv pass
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernel as its backward; saves
    q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, masks):
        out, lse = _forward(q, k, v, masks, with_lse=True)
        ctx.masks = masks
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, kv_len = ctx.masks
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.to(q.dtype).contiguous(), lse, causal=causal,
            window=window, scale=scale, kv_len=kv_len)
        return dq, dk, dv, None
