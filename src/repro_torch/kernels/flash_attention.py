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
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = CSRC_DIR / "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr] * 4 + [i32] * 8 + [
        ctypes.c_float, i32, ptr]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
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
    j > i - window (``window``) and j < kv_len (``kv_len``)."""
    _check(q, k, v, window, kv_len)
    b, hq, s, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, kv_len=kv_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, hd, int(causal), window or 0,
            s if kv_len is None else kv_len, scale, _DTYPE_CODE[q.dtype],
            stream)
    if code != 0:
        raise RuntimeError(f"flash attention launch failed: "
                           f"{lib.flash_attention_error_string(code).decode()}"
                           f" ({code})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
