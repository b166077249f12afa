"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, on any device, in
torch ops. The CPU tests run them, ``chip_smoke.py`` holds each kernel
against them on the card, and a kernel wrapper hands them every tensor
that lies on the CPU.
"""
from __future__ import annotations

import torch


def tpd_ref(placements, attrs, leaf_load, kids, level_starts,
            penalty: float = 0.0) -> torch.Tensor:
    """Batched TPD (paper eqs. 6-7) in torch ops; the operands of
    ``kernels.tpd.batch_tpd_cuda``.

    placements (P, D) int32; attrs (3, C) f32 = [mdatasize, pspeed,
    memcap]; leaf_load (P, L) f32 trainer loads per leaf aggregator;
    kids (D, W) int32 child slots, -1 padded, and level_starts, depth + 1
    host ints, from ``kernels.tpd.tpd_kernel_inputs`` (level ``l`` is the
    slot range ``level_starts[l]:level_starts[l + 1]``; the last level
    holds the L leaves) -> (P,) f32 TPDs.

    Additions run in a fixed order: the child sum over the W kid
    columns left to right, and the level maxima deepest level first.
    For W < 8 that is numpy's order too, so the result equals the
    reference's float32 numpy evaluator bit for bit.
    """
    p = placements.long()
    bounds = [int(b) for b in level_starts]
    leaf_start = bounds[-2]
    mds, pspeed, memcap = attrs.float().unbind(0)
    k = kids[:leaf_start].long()
    kid_mds = torch.where(k >= 0, mds[p[:, k.clamp_min(0)]], 0.0)
    child = kid_mds[..., 0]                          # (P, D - L)
    for w in range(1, kid_mds.shape[-1]):
        child = child + kid_mds[..., w]
    load = mds[p] + torch.cat([child, leaf_load.float()], dim=1)
    delay = load / pspeed[p]
    if penalty > 0:
        cap = memcap[p]
        over = torch.clamp_min(load - cap, 0.0)
        delay = delay * (1.0 + penalty * over / torch.clamp_min(cap, 1e-9))
    total = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    for lv in range(len(bounds) - 2, -1, -1):        # deepest level first
        total = total + delay[:, bounds[lv]:bounds[lv + 1]].amax(dim=1)
    return total
