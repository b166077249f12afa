"""One fused AdamW step over flat buffers: the CUDA port of the TPU kernel
``repro/kernels/fused_adamw.py:fused_adamw_pallas`` (body
``_adamw_kernel``).

One kernel, ``repro_torch/csrc/fused_adamw.cu`` (its source note gives
the design and the bound), built at first use by
:mod:`repro_torch.kernels.build` and bound through ``ctypes``::

    fused_adamw(p (N,), g (N,), m (N,), v (N,), lr, bc1, bc2, *, b1, b2,
                eps, wd) -> (p, m, v), updated in place

p and g float32 or bfloat16 (alike), m and v float32, all contiguous;
any N (64-bit: the full-width model has more than 2^31 params). The
scalars are host floats, rounded to float32 and passed by value, so a
step never waits on the device for them. A tensor on a CUDA device
launches the kernel (counted on ``fused_adamw.launches``, one per call);
a tensor on the CPU goes to the plain torch version,
:func:`repro_torch.kernels.ref.fused_adamw_ref`, a chunk of
``CPU_CHUNK`` elements at a time, each result copied back into p, m and
v. The chunk keeps the temporaries small beside a
multi-billion-parameter state and near the cache: much larger chunks
make the allocator map and fault in every fresh temporary, much smaller
ones are too small to spread over the threads. The math is elementwise,
so the chunk does not change a bit. The two agree bit for bit. There
is no fallback from the card to the host.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import fused_adamw_ref

SOURCE = CSRC_DIR / "fused_adamw.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CPU_CHUNK = 1 << 19


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, f32 = ctypes.c_void_p, ctypes.c_float
    lib.fused_adamw_launch.argtypes = [ptr] * 4 + [ctypes.c_longlong] \
        + [f32] * 9 + [ctypes.c_int, ptr]
    lib.fused_adamw_launch.restype = ctypes.c_int
    lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.fused_adamw_error_string.restype = ctypes.c_char_p
    return lib


def _check(p, g, m, v) -> None:
    """Raise on anything the kernel does not take."""
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused AdamW runs on cuda or cpu, not {p.device}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    if p.dtype not in _DTYPE_CODE:
        raise TypeError(f"p must be float32 or bfloat16, got {p.dtype}")
    if g.dtype != p.dtype:
        raise TypeError(f"g is {g.dtype}, p is {p.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"m and v must be float32, got {m.dtype} and "
                        f"{v.dtype}")
    if p.dim() != 1 or any(tuple(t.shape) != tuple(p.shape)
                           for t in (g, m, v)):
        raise ValueError(f"p, g, m and v must be one (N,) shape, got "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("p, g, m and v must be contiguous")


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, lr, bc1, bc2, *, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1):
    """One AdamW step, in place on p, m and v; returns (p, m, v)."""
    _check(p, g, m, v)
    if p.device.type == "cpu":
        for lo in range(0, p.numel(), CPU_CHUNK):
            part = [t[lo:lo + CPU_CHUNK] for t in (p, g, m, v)]
            new = fused_adamw_ref(*part, lr, bc1, bc2, b1=b1, b2=b2,
                                  eps=eps, wd=wd)
            for dst, src in zip((part[0], part[2], part[3]), new,
                                strict=True):
                dst.copy_(src)
        return p, m, v
    if p.numel() == 0:
        return p, m, v
    f32 = [float(np.float32(x)) for x in (lr, bc1, bc2, b1, 1 - b1, b2,
                                          1 - b2, eps, wd)]
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = lib.fused_adamw_launch(p.data_ptr(), g.data_ptr(),
                                      m.data_ptr(), v.data_ptr(), p.numel(),
                                      *f32, _DTYPE_CODE[p.dtype], stream)
    if code != 0:
        raise RuntimeError(f"fused AdamW launch failed: "
                           f"{lib.fused_adamw_error_string(code).decode()}"
                           f" ({code})")
    fused_adamw.launches += 1
    return p, m, v


fused_adamw.launches = 0
