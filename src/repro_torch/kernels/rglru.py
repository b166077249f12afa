"""The RG-LRU scan h_t = a_t * h_{t-1} + u_t: the CUDA port of the TPU
kernel ``repro/kernels/rglru.py:rglru_scan_pallas`` (body
``_rglru_kernel``, in-tile scan ``_tile_scan``).

One kernel, ``repro_torch/csrc/rglru.cu`` (its source note gives the
design and the bound), built at first use by
:mod:`repro_torch.kernels.build` and bound through ``ctypes``::

    rglru_scan(a (B, T, D), u (B, T, D)) -> h (B, T, D),  h_{-1} = 0

float32 or bfloat16 (both alike, the output too), float32 math. Any T
and D: the kernel masks its own ragged edge. A tensor on a CUDA device
launches the kernel (counted on ``rglru_scan.launches``); a tensor on
the CPU goes to the plain torch version,
:func:`repro_torch.kernels.ref.rglru_scan_ref`, which does the same
arithmetic in the same order, so the two agree bit for bit. There is no
fallback from the card to the host. A carried-in state is the caller's
to fold into ``u[:, 0]`` (``models.rglru.rglru_scan`` does).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import rglru_scan_ref

SOURCE = CSRC_DIR / "rglru.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.rglru_scan_launch.restype = i32
    lib.rglru_error_string.argtypes = [i32]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, u) -> None:
    """Raise on anything the kernel does not take."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the RG-LRU scan runs on cuda or cpu, not "
                         f"{a.device}")
    if u.device != a.device:
        raise ValueError(f"u is on {u.device}, a on {a.device}")
    if a.dtype not in _DTYPE_CODE or u.dtype != a.dtype:
        raise TypeError(f"a and u must both be float32 or both bfloat16, got "
                        f"{a.dtype} and {u.dtype}")
    if a.dim() != 3 or tuple(u.shape) != tuple(a.shape):
        raise ValueError(f"a and u must both be (B, T, D), got "
                         f"{tuple(a.shape)} and {tuple(u.shape)}")
    if not (a.is_contiguous() and u.is_contiguous()):
        raise ValueError("a and u must be contiguous")


def rglru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """a, u (B, T, D) -> h (B, T, D) with h_t = a_t h_{t-1} + u_t, h_{-1}
    = 0, in a's dtype."""
    _check(a, u)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, u)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    b, t, d = a.shape
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_launch(a.data_ptr(), u.data_ptr(),
                                     out.data_ptr(), b, t, d,
                                     _DTYPE_CODE[a.dtype], stream)
    if code != 0:
        raise RuntimeError(f"RG-LRU scan launch failed: "
                           f"{lib.rglru_error_string(code).decode()} ({code})")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
