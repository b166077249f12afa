"""GQA flash attention forward: the CUDA port of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas`` (body
``_flash_kernel``).

Two kernels, both on Hopper's tensor cores, each built at first use by
:mod:`repro_torch.kernels.build` and bound through ``ctypes`` (their
source notes give the design and the bound)::

    flash_attention(q (B, Hq, S, hd), k, v (B, Hkv, S, hd), *, causal,
                    window, scale, kv_len) -> (B, Hq, S, hd)

- ``sm90``: ``repro_torch/csrc/flash_attention_sm90.cu``, bfloat16
  operands at hd <= 256 (wgmma fed by TMA through mbarrier rings, with
  ``csrc/flash_sm90.cuh``), built for hd 64, 128 and 256: any other hd
  up to 256 is zero-padded on the last axis to the next of those (hd
  80 -> 128);
- ``f32``: ``repro_torch/csrc/flash_attention.cu``, float32 operands
  of any hd, and bfloat16 ones above hd 256, read as float32 and the
  result cast back (the reference computes in float32 for both). Its
  products run in split TF32 on mma.sync (``csrc/flash_tf32.cuh``):
  each operand split into two TF32 halves and three TF32 products
  summed in float32, which keeps float32 accuracy (one TF32 product
  would not meet the float32 tolerances). hd is zero-padded to a
  multiple of 8, and above 256 the output columns are split over
  blocks that each recompute the scores (:func:`f32_geometry`).

The zero columns add exact zeros to every q.k and every product with
V, and the scale is the real hd's, so the output sliced back is the
unpadded one. :func:`head_route` gives the route and the width from the
head dim and the dtype. q, k and v alike, Hq a multiple of Hkv; the
kernels mask their own ragged edge, so S need not be a multiple of any
tile. A tensor on a CUDA device launches its route's kernel or raises
(counted on ``flash_attention.launches``, per source on
``flash_attention.routes`` and per mask, ``causal`` or
``bidirectional`` (``causal=False``), on ``flash_attention.modes``); a
tensor on the CPU, of any hd >= 1, goes
to the plain torch version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, with the same
masks. There is no fallback from the card to the host or from one route
to the other.

The gradient. When q, k or v requires grad, ``flash_attention`` runs
through an autograd Function: the forward also keeps each row's float32
log-sum-exp (B, Hq, S), and the backward is a kernel too (no TPU
counterpart: the reference has no backward kernel), again one per
route, ``csrc/flash_attention_bwd_sm90.cu`` and
``csrc/flash_attention_bwd.cu``::

    flash_attention_bwd(q, k, v, out, dout, lse, *, causal, window,
                        scale, kv_len) -> (dq, dk, dv)

three deterministic launches on either route (dq, then partial dk and
dv over a split of each kv head's query heads, then their sum), padded
as the forward is, counted on ``flash_attention_bwd.launches`` (and
its ``routes`` and ``modes``), with
its plain version :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`
for CPU tensors. :func:`launch_geometry` gives the bfloat16 kernels'
grids.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

SOURCE = CSRC_DIR / "flash_attention.cu"              # route f32
BWD_SOURCE = CSRC_DIR / "flash_attention_bwd.cu"      # route f32
SM90_SOURCE = CSRC_DIR / "flash_attention_sm90.cu"    # route sm90
BWD_SM90_SOURCE = CSRC_DIR / "flash_attention_bwd_sm90.cu"
HEAD_DIMS = (64, 128, 256)   # the sm90 kernels' widths
DTYPES = (torch.float32, torch.bfloat16)
FWD_ROWS = 128        # query rows per bf16 forward block (2 warpgroups)
BWD_ROWS = 64         # query rows per dq block, keys per dk/dv block
F32_DEPTH = 8         # the f32 route pads hd to a multiple of the MMA depth
F32_MAX_COLS = 256    # output columns one f32 block accumulates at most
F32_KEY_BLOCK = 64    # keys per f32 dk/dv block
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Grids of the bfloat16 kernels for one shape: ``fwd_grid`` (q
    tiles of ``FWD_ROWS``, Hq, B), ``dq_grid`` (q tiles of ``BWD_ROWS``,
    Hq, B), ``dkdv_grid`` (key blocks of ``BWD_ROWS``, split, B * Hkv),
    where ``split`` blocks share each kv head's query heads, and
    ``kv_tiles``, the 64-key tiles that hold a key below kv_len."""
    fwd_grid: Tuple[int, int, int]
    dq_grid: Tuple[int, int, int]
    dkdv_grid: Tuple[int, int, int]
    split: int
    kv_tiles: int


def launch_geometry(b: int, hq: int, hkv: int, s: int,
                    kv_len: Optional[int] = None,
                    sms: int = H100_SMS) -> LaunchGeometry:
    """The bfloat16 kernels' grids. The dk/dv pass has one block per
    (key block, part of the group, batch row x kv head); ``split`` is the
    smallest divisor of the group Hq / Hkv that gives at least ``sms``
    blocks, or the whole group where none does."""
    kv_len = s if kv_len is None else kv_len
    group = hq // hkv
    key_blocks = -(-s // BWD_ROWS)
    base = key_blocks * b * hkv
    split = next((d for d in range(1, group + 1)
                  if group % d == 0 and base * d >= sms), group)
    return LaunchGeometry(fwd_grid=(-(-s // FWD_ROWS), hq, b),
                          dq_grid=(key_blocks, hq, b),
                          dkdv_grid=(key_blocks, split, b * hkv),
                          split=split, kv_tiles=-(-kv_len // BWD_ROWS))


@dataclasses.dataclass(frozen=True)
class F32Geometry:
    """How the f32 route splits one shape: the output columns of a head
    over ``col_blocks`` blocks of ``cols`` (a multiple of 8, at most
    ``F32_MAX_COLS``), and each kv head's query heads over ``split``
    dk/dv blocks."""
    col_blocks: int
    cols: int
    split: int


def f32_geometry(b: int, hq: int, hkv: int, s: int, width: int,
                 sms: int = H100_SMS) -> F32Geometry:
    """The f32 kernels' column blocks and group split. The dk/dv pass
    has one block per (64 keys, column block, part of the group, batch
    row x kv head), one an SM; ``split`` is the divisor d of the group
    Hq / Hkv with the fewest waves of work, ceil(blocks(d) / sms) / d,
    and the largest d of those that tie: the blocks launch longest first,
    so more and shorter blocks even out the causal mask's uneven work."""
    col_blocks = -(-width // F32_MAX_COLS)
    cols = -(-width // (col_blocks * F32_DEPTH)) * F32_DEPTH
    group = hq // hkv
    base = -(-s // F32_KEY_BLOCK) * b * hkv * col_blocks
    split = min((d for d in range(1, group + 1) if group % d == 0),
                key=lambda d: (-(-base * d // sms) / d, -d))
    return F32Geometry(col_blocks=col_blocks, cols=cols, split=split)


def _bind(source, name, n_ptr_head, n_int, n_tail) -> ctypes.CDLL:
    """Build ``source`` and declare ``{name}_launch`` as ``n_ptr_head``
    pointers, ``n_int`` ints, a float, ``n_tail`` ints and the stream,
    returning an int; and ``{name}_error_string``."""
    lib = ctypes.CDLL(str(build_library(source)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ptr] * n_ptr_head + [i32] * n_int + [ctypes.c_float] + \
        [i32] * n_tail + [ptr]
    fn.restype = i32
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(SOURCE, "flash_attention", 5, 8, 2)


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return _bind(BWD_SOURCE, "flash_attention_bwd", 12, 8, 3)


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    return _bind(SM90_SOURCE, "flash_attention_sm90", 5, 9, 3)


@functools.cache
def _bwd_sm90_library() -> ctypes.CDLL:
    return _bind(BWD_SM90_SOURCE, "flash_attention_bwd_sm90", 12, 9, 7)


def _raise_on(code: int, lib: ctypes.CDLL, name: str) -> None:
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({code})")


def _count(fn, source, causal: bool, heads: tuple, launches: int = 1) -> None:
    fn.launches += launches
    fn.routes[source.stem] = fn.routes.get(source.stem, 0) + launches
    mode = "causal" if causal else "bidirectional"
    fn.modes[mode] = fn.modes.get(mode, 0) + launches
    key = "%dx%d" % heads             # q heads x kv heads of the launch
    fn.heads[key] = fn.heads.get(key, 0) + launches


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_aligned(*tensors) -> None:
    """The bf16 kernels read their operands through TMA, which needs
    16-byte aligned bases."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the bfloat16 flash kernels need 16-byte "
                             "aligned operands")


def head_route(hd: int, dtype: torch.dtype) -> Tuple[str, int]:
    """(route, width) of an hd-wide call with ``dtype`` operands on the
    card: ``("sm90", the least of HEAD_DIMS that holds hd)`` for
    bfloat16 up to hd 256, else ``("f32", hd rounded up to a multiple of
    8)``, for float32 at any hd and bfloat16 above 256."""
    if dtype == torch.bfloat16 and hd <= HEAD_DIMS[-1]:
        return "sm90", next(w for w in HEAD_DIMS if hd <= w)
    return "f32", -(-hd // F32_DEPTH) * F32_DEPTH


def _pad_head(width: int, *tensors):
    """``tensors`` zero-padded on the last axis to ``width`` (the same
    tensors where that is their own)."""
    return tuple(t if t.shape[-1] == width else
                 torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def _f32_operands(width: int, *tensors):
    """The f32 route's operands: float32, zero-padded to ``width``, and
    16-byte aligned for cp.async (a view off alignment is copied)."""
    out = []
    for t in _pad_head(width, *(t.float() for t in tensors)):
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return tuple(out)


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
    if q.dtype not in DTYPES:
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
    if hd < 1:
        raise ValueError(f"head dim must be >= 1, got {hd}")
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
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.numel() == 0:
        return torch.empty_like(q), lse
    dtype = q.dtype
    route, width = head_route(hd, dtype)
    q, k, v = (_pad_head(width, q, k, v) if route == "sm90"
               else _f32_operands(width, q, k, v))
    out = torch.empty_like(q)
    kv = s if kv_len is None else kv_len
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            _check_aligned(q, k, v, out)
            geo = launch_geometry(b, hq, k.shape[1], s, kv, _sms(q.device))
            source, name, lib = SM90_SOURCE, "flash_attention_sm90", \
                _sm90_library()
            code = lib.flash_attention_sm90_launch(
                *operands, b, hq, k.shape[1], s, width, int(causal),
                window or 0, kv, geo.kv_tiles, scale, *geo.fwd_grid, stream)
        else:
            geo = f32_geometry(b, hq, k.shape[1], s, width, _sms(q.device))
            source, name, lib = SOURCE, "flash_attention", _library()
            code = lib.flash_attention_launch(
                *operands, b, hq, k.shape[1], s, width, int(causal),
                window or 0, kv, scale, geo.col_blocks, geo.cols, stream)
    _raise_on(code, lib, name)
    _count(flash_attention, source, causal, (hq, k.shape[1]))
    if width != hd:
        out = out[..., :hd].contiguous()
    return out.to(dtype), lse


flash_attention.launches = 0
flash_attention.routes = {}     # launches per kernel source (stem)
flash_attention.modes = {}      # launches per mask: causal, bidirectional
flash_attention.heads = {}      # launches per "Hq x Hkv" of their operands


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
    if q.numel() == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dtype = q.dtype
    route, width = head_route(hd, dtype)
    q, k, v, out, dout = (_pad_head(width, q, k, v, out, dout)
                          if route == "sm90" else
                          _f32_operands(width, q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hkv = k.shape[1]
    kv = s if kv_len is None else kv_len
    dsum = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                dq.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90":
            _check_aligned(q, k, v, out, dout, dq, dk, dv)
            geo = launch_geometry(b, hq, hkv, s, kv, _sms(q.device))
        else:
            geo = f32_geometry(b, hq, hkv, s, width, _sms(q.device))
        dk_part, dv_part = (torch.empty((geo.split, b, hkv, s, width),
                                        dtype=torch.float32, device=q.device)
                            for _ in range(2))
        parts = (dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, hq, hkv, s, width, int(causal),
                 window or 0, kv)
        if route == "sm90":
            source, name, lib = BWD_SM90_SOURCE, "flash_attention_bwd_sm90", \
                _bwd_sm90_library()
            code = lib.flash_attention_bwd_sm90_launch(
                *operands, *parts, geo.kv_tiles, scale, geo.split,
                *geo.dq_grid, *geo.dkdv_grid, stream)
        else:
            source, name, lib = BWD_SOURCE, "flash_attention_bwd", \
                _bwd_library()
            code = lib.flash_attention_bwd_launch(
                *operands, *parts, scale, geo.col_blocks, geo.cols,
                geo.split, stream)
    _raise_on(code, lib, name)
    _count(flash_attention_bwd, source, causal, (hq, hkv), 3)  # dq, dk/dv, sum
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {}
flash_attention_bwd.modes = {}
flash_attention_bwd.heads = {}


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
