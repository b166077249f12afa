"""The RG-LRU scan h_t = a_t * h_{t-1} + u_t: the CUDA port of the TPU
kernel ``repro/kernels/rglru.py:rglru_scan_pallas`` (body
``_rglru_kernel``, in-tile scan ``_tile_scan``).

One source, ``repro_torch/csrc/rglru.cu`` (its note gives the design and
the bound), built at first use by :mod:`repro_torch.kernels.build` and
bound through ``ctypes``::

    rglru_scan(a (B, T, D), u (B, T, D)) -> h (B, T, D),  h_{-1} = 0

float32 or bfloat16 (both alike, the output too), float32 math. Any T
and D: the kernel masks its own ragged edge. A tensor on a CUDA device
launches the kernel (counted on ``rglru_scan.launches``, and per copy
route on ``rglru_scan.routes``); a tensor on the CPU goes to the plain
torch version, :func:`repro_torch.kernels.ref.rglru_scan_ref`, which
does the same arithmetic in the same order, so the two agree bit for
bit. There is no fallback from the card to the host. A carried-in state
is the caller's to fold into ``u[:, 0]`` (``models.rglru.rglru_scan``
does).

Each block walks a group of ``GROUP`` channels, one thread a channel,
and streams its operands through a ring of shared memory that one of two
routes fills (:func:`launch_plan` picks the route and the ring's depth
from the shape): ``"tma"`` (tensor-map copies) where a row of D elements is a
multiple of 16 bytes and every operand is 16-byte aligned, every model
shape, whose outputs leave through the same maps; ``"cp_async"`` (4-byte
asynchronous copies, outputs stored a step at a time) for the other
widths.
Neither gives way to the other.

The gradient. When a or u requires grad, ``rglru_scan`` runs through
an autograd Function whose backward is the second entry of the same
source, the adjoint walk (no TPU counterpart: the reference has no
backward kernel)::

    rglru_scan_bwd(a, h, dh) -> (da, du)

counted on ``rglru_scan_bwd.launches`` and ``rglru_scan_bwd.routes``,
with its plain version :func:`repro_torch.kernels.ref.rglru_scan_bwd_ref`
for CPU tensors (bit for bit the same arithmetic).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import torch

from repro_torch.kernels.build import CSRC_DIR, build_library
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

SOURCE = CSRC_DIR / "rglru.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tma", "cp_async")        # the route codes 0 and 1 of the kernel
GROUP = 32                          # channels a block (threads): kGroup
TILE_STEPS = 64                     # time steps of a ring stage (kTileSteps)
MIN_STAGES, MAX_STAGES = 2, 8       # kMinStages, kMaxStages
SMEM_PER_SM = 228 * 1024            # H100: shared memory of one SM
SMEM_PER_BLOCK = 227 * 1024         # the most one block may take
SMEM_RESERVED = 1024                # the system's share of each block
RING_ALIGN = 128                    # the ring's slack for its alignment
# loads in flight an SM aims at: its share of 3.35 TB/s (25 GB/s) over
# ~2 us of loaded memory latency
INFLIGHT_PER_SM = 48 * 1024
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: ``route`` (``"tma"`` or ``"cp_async"``),
    ``stages`` in the ring, ``blocks`` of ``GROUP`` channels in the grid
    and the ring's ``smem_bytes`` a block."""
    route: str
    stages: int
    blocks: int
    smem_bytes: int


def copy_route(d: int, elem_bytes: int, ptrs=()) -> str:
    """``"tma"`` where a row of ``d`` elements is a multiple of 16 bytes
    and every address in ``ptrs`` is 16-byte aligned (a tensor map's
    rules), else ``"cp_async"``."""
    if (d * elem_bytes) % 16 == 0 and all(p % 16 == 0 for p in ptrs):
        return "tma"
    return "cp_async"


def ring_bytes(operands: int, elem_bytes: int, route: str,
               stages: int) -> int:
    """The shared memory of one block (the kernel's
    ``rglru_smem_bytes``): ``stages`` tiles of ``TILE_STEPS`` steps x
    ``GROUP`` channels of each operand, an element a word on the TMA
    route and 4 bytes on the cp.async one; on the TMA route, two staging
    tiles of each output (``operands - 1``) besides."""
    tile = TILE_STEPS * GROUP
    if route != "tma":
        return stages * operands * tile * 4 + RING_ALIGN
    return (stages * operands + 2 * (operands - 1)) * tile * elem_bytes \
        + RING_ALIGN


def launch_plan(b: int, t: int, d: int, elem_bytes: int, operands: int,
                route: str, sms: int = H100_SMS) -> LaunchPlan:
    """The launch of one walk over (b, t, d) with ``operands`` inputs (2
    for the scan, 3 for the adjoint). The grid has ceil(d / GROUP) x b
    blocks; the ring keeps about ``INFLIGHT_PER_SM`` of loads in flight
    on each SM (stages - 1 tiles a block, with every block of the grid
    resident at once), within 2 to 8 stages, the shared memory of an SM
    and the tiles the walk has: a small grid gets deeper rings, a large
    one shallower (deeper rings at recurrentgemma-2b's serving shape
    measured slower)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route}")
    blocks = -(-d // GROUP) * b
    per_sm = max(1, -(-blocks // sms))
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // per_sm - SMEM_RESERVED)
    fixed = ring_bytes(operands, elem_bytes, route, 0)
    per_stage = ring_bytes(operands, elem_bytes, route, 1) - fixed
    stages = max(MIN_STAGES,
                 min(1 + INFLIGHT_PER_SM // (per_sm * per_stage),
                     (budget - fixed) // per_stage, MAX_STAGES,
                     -(-t // TILE_STEPS)))
    return LaunchPlan(route=route, stages=stages, blocks=blocks,
                      smem_bytes=ring_bytes(operands, elem_bytes, route,
                                            stages))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_launch.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.rglru_scan_launch.restype = i32
    lib.rglru_scan_bwd_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.rglru_scan_bwd_launch.restype = i32
    lib.rglru_smem_bytes.argtypes = [i32] * 4
    lib.rglru_smem_bytes.restype = i32
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


def plan_for(inputs, outputs=()) -> LaunchPlan:
    """The :func:`launch_plan` of a walk over CUDA ``inputs`` (a, u for
    the scan; a, h, dh for the adjoint) into ``outputs``: the route from
    their width and alignment, the ring from the card's SM count."""
    b, t, d = inputs[0].shape
    size = inputs[0].element_size()
    sms = torch.cuda.get_device_properties(
        inputs[0].device).multi_processor_count
    route = copy_route(d, size, [x.data_ptr() for x in (*inputs, *outputs)])
    return launch_plan(b, t, d, size, len(inputs), route, sms)


def _launch(fn, inputs):
    """One launch of the scan (``fn`` = :func:`rglru_scan`, inputs a, u ->
    (h,)) or the adjoint (:func:`rglru_scan_bwd`, a, h, dh -> (da, du)) on
    the card, counted on ``fn``."""
    a = inputs[0]
    outs = tuple(torch.empty_like(a) for _ in range(len(inputs) - 1))
    if a.numel() == 0:
        return outs
    plan = plan_for(inputs, outs)
    b, t, d = a.shape
    lib = _library()
    entry = lib.rglru_scan_launch if fn is rglru_scan \
        else lib.rglru_scan_bwd_launch
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = entry(*(x.data_ptr() for x in inputs + outs), b, t, d,
                     _DTYPE_CODE[a.dtype], ROUTES.index(plan.route),
                     plan.stages, stream)
    if code != 0:
        what = "scan" if fn is rglru_scan else "adjoint"
        raise RuntimeError(f"RG-LRU {what} launch failed ({plan}): "
                           f"{lib.rglru_error_string(code).decode()} ({code})")
    fn.launches += 1
    fn.routes[plan.route] = fn.routes.get(plan.route, 0) + 1
    return outs


def _forward(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return rglru_scan_ref(a, u)
    return _launch(rglru_scan, (a, u))[0]


rglru_scan.launches = 0
rglru_scan.routes = {}          # launches per copy route


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The scan's adjoint: a, h (the forward's output) and dh, all (B, T,
    D) of one dtype -> (da, du) in that dtype."""
    _check(a, h)
    _check(a, dh)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    return _launch(rglru_scan_bwd, (a, h, dh))


rglru_scan_bwd.launches = 0
rglru_scan_bwd.routes = {}


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
