"""Plain PyTorch versions of the port's kernels (TPD and FedAvg).

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


# ---------------------------------------------------------------------------
# weighted FedAvg: out[g] = sum_k w[g, k] * x[g, k], float32 accumulation,
# the terms added in k order (each product rounded before its add), the
# result in the input dtype
# ---------------------------------------------------------------------------
def fedavg_rows_ref(pool, rows, w, out=None) -> torch.Tensor:
    """Row-indexed FedAvg, the operands of ``kernels.fedavg.fedavg_rows``.

    pool (R, N) f32 or bf16; rows (G, K) int32 row ids into the pool, -1
    where a cluster has fewer than K members; w (G, K) f32 -> (G, N) in
    the pool's dtype (written into ``out`` when given). A -1 entry adds
    nothing, whatever its weight.
    """
    rows = torch.as_tensor(rows).to(pool.device).long()
    w = torch.as_tensor(w).to(pool.device, torch.float32)
    acc = torch.zeros((rows.shape[0], pool.shape[1]), dtype=torch.float32,
                      device=pool.device)
    for k in range(rows.shape[1]):
        r = rows[:, k]
        term = pool[r.clamp_min(0)].float() * w[:, k:k + 1]
        acc = torch.where((r >= 0)[:, None], acc + term, acc)
    if out is None:
        return acc.to(pool.dtype)
    return out.copy_(acc)


def fedavg_batched_ref(stacked, w) -> torch.Tensor:
    """stacked (G, K, N), w (G, K) -> (G, N): one weighted sum per
    cluster (``kernels.fedavg.fedavg_batched``'s operands)."""
    w = w.float()
    acc = torch.zeros((stacked.shape[0], stacked.shape[2]),
                      dtype=torch.float32, device=stacked.device)
    for k in range(stacked.shape[1]):
        acc = acc + stacked[:, k].float() * w[:, k:k + 1]
    return acc.to(stacked.dtype)


def fedavg_ref(stacked, w) -> torch.Tensor:
    """stacked (K, N), w (K,) -> (N,) = sum_k w_k * stacked_k
    (``kernels.fedavg.fedavg``'s operands)."""
    w = w.float()
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for k in range(stacked.shape[0]):
        acc = acc + stacked[k].float() * w[k]
    return acc.to(stacked.dtype)
