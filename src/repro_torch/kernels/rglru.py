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

The gradient. When a or u requires grad, ``rglru_scan`` runs through
an autograd Function whose backward is the second entry of the same
source, the adjoint walk (no TPU counterpart: the reference has no
backward kernel)::

    rglru_scan_bwd(a, h, dh) -> (da, du)

counted on ``rglru_scan_bwd.launches``, with its plain version
:func:`repro_torch.kernels.ref.rglru_scan_bwd_ref` for CPU tensors
(bit for bit the same arithmetic).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

SOURCE = CSRC_DIR / "rglru.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.rglru_scan_launch.restype = i32
    lib.rglru_scan_bwd_launch.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.rglru_scan_bwd_launch.restype = i32
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
    = 0, in a's dtype; differentiable in a and u."""
    _check(a, u)
    if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
        return _RGLRUScan.apply(a, u)
    return _forward(a, u)


def _forward(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
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


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The scan's adjoint: a, h (the forward's output) and dh, all (B, T,
    D) of one dtype -> (da, du) in that dtype."""
    _check(a, h)
    _check(a, dh)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    da, du = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, du
    b, t, d = a.shape
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_bwd_launch(a.data_ptr(), h.data_ptr(),
                                         dh.data_ptr(), da.data_ptr(),
                                         du.data_ptr(), b, t, d,
                                         _DTYPE_CODE[a.dtype], stream)
    if code != 0:
        raise RuntimeError(f"RG-LRU adjoint launch failed: "
                           f"{lib.rglru_error_string(code).decode()} ({code})")
    rglru_scan_bwd.launches += 1
    return da, du


rglru_scan_bwd.launches = 0


class _RGLRUScan(torch.autograd.Function):
    """The scan with the adjoint kernel as its backward; saves a and the
    output h."""

    @staticmethod
    def forward(ctx, a, u):
        h = _forward(a, u)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, du = rglru_scan_bwd(a, h, dh.to(a.dtype).contiguous())
        return da, du
