"""Mixture-of-Experts FFN on one device: the single-device part of
``repro.models.moe``.

Routing is token-choice top-k: float32 router logits, a softmax over the
E experts, each token's k largest probs renormalised (floor 1e-9) and
scattered into dense (T, E) gates, and the Switch load-balance loss E *
sum_e (share of tokens routed to e) * (mean prob of e). Then each expert
keeps its top-``capacity`` tokens by gate weight (Switch-style
dropping), runs the SiLU-gated FFN on them as batched products in the
promoted dtype (float32 under the reference's float32 params), weights
each output by its gate and combines them back to (T, D).

Capacity is ``ceil(T * k * capacity_factor / E)`` over the whole batch,
pads included, so a request's tokens depend on the others in its batch,
as in the reference: batched serving is not serial serving for this
family.

Top-k order. ``jax.lax.top_k`` puts the lower index first among equal
values and ``torch.topk`` does not. Ties are real inputs: a zero router,
the first position of prompts that share a first token, an expert with
fewer than ``capacity`` routed tokens filling its slots with zero-gate
ties. :func:`top_k` is a stable descending sort cut to k, which keeps
the reference's order on both devices.

The combine. The reference scatter-adds every (expert, slot) output into
its token. A float ``index_add_`` over repeated indices adds in the order
the card's atomics land, so reruns would part in their last bits. The
port gathers instead: an inverse map gives each token, for each expert
it routed to, the slot that expert kept it in (or a zero row where the
expert dropped it), and the token's k rows are summed in one reduction
of fixed order, so reruns are bit-equal. Its backward is a gather too:
each slot belongs to one token. A slot that holds a token its
gate did not route there (capacity filled by zero-gate ties, or a pad
under the mask) carries a zero gate: its output is zero in the
reference's sum and in its gradients, so the gather leaves it out. One
``index_add_`` per expert (unique indices, ascending experts) would be
deterministic too, but adds E launches a layer to a decode step the host
already bounds.

:func:`moe_spec` is the reference's rule for the expert leaves. The
expert-parallel paths (the ``shard_map`` island over the model axis and
the 2-D ``ep2d`` serving layout) come with ROADMAP.md queue 1 item
12b-1c: a mesh policy with a model, fsdp, seq or ep2d axis raises (a
pod/data replica policy runs the one-device path).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype, device) -> dict:
    """The router (float32 whatever ``dtype``), then the experts' gate,
    up (E, D, F) and down (E, F, D) projections, fan-in D or F."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    return {
        "router": dense_init(generator, (d_model, e),
                             torch.float32).to(device),
        "w_gate": dense_init(generator, (e, d_model, f), dtype).to(device),
        "w_up": dense_init(generator, (e, d_model, f), dtype).to(device),
        "w_down": dense_init(generator, (e, f, d_model), dtype).to(device),
    }


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last dim, largest
    first and the lower index first among equal values, as
    ``jax.lax.top_k`` orders them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(x2d: torch.Tensor, router: torch.Tensor, k: int):
    """Token-choice routing of x2d (T, D), the reference's ``_route``: the
    sparse (T, E) gates and the Switch auxiliary loss, and each token's k
    experts (T, k)."""
    logits = torch.matmul(x2d.float(), router)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    gates = torch.zeros_like(probs).scatter(-1, top_i, top_w)
    density = (gates > 0).float().mean(0)
    aux = probs.shape[-1] * torch.sum(density * probs.mean(0))
    return gates, aux, top_i


def expert_ffn(xe: torch.Tensor, gw: torch.Tensor, w_gate, w_up, w_down):
    """The gated expert FFN on gathered tokens xe (E, C, D), each output
    weighted by its gate gw (E, C): three batched products in the
    promoted dtype of ``xe`` and the weights."""
    dt = torch.promote_types(xe.dtype, w_gate.dtype)
    xe = xe.to(dt)
    h = F.silu(torch.bmm(xe, w_gate.to(dt)))
    h = h * torch.bmm(xe, w_up.to(dt))
    return torch.bmm(h, w_down.to(dt)) * gw[..., None].to(dt)


class _Combine(torch.autograd.Function):
    """out[t] = sum_j table[rows[t, j]], the table being ye's slots and a
    zero row that every dropped choice points at. Each slot belongs to one
    token, so the gradient of ye is a gather of the output's gradient
    (masked to the slots some token sums); autograd's own backward of the
    gather would accumulate into the zero row once per dropped choice, a
    run of duplicate indices the card adds one after another."""

    @staticmethod
    def forward(ctx, ye, gi, rows):
        e, c, d = ye.shape
        table = torch.cat([ye.reshape(e * c, d), ye.new_zeros(1, d)])
        ctx.save_for_backward(gi, rows)
        return table[rows].sum(dim=1)

    @staticmethod
    def backward(ctx, grad):
        gi, rows = ctx.saved_tensors
        e, c = gi.shape
        # a fill, not ``used[rows] = 1.0``: that copies a host scalar to
        # the card, which waits for the card's queue
        used = grad.new_zeros(e * c + 1).index_fill_(0, rows.reshape(-1), 1.0)
        return grad[gi] * used[:e * c].view(e, c, 1), None, None


def combine(ye: torch.Tensor, gi: torch.Tensor, choices: torch.Tensor,
            t: int) -> torch.Tensor:
    """(T, D): each token's sum of the outputs ye (E, C, D) of the slots
    gi (E, C) its experts ``choices`` (T, k) kept it in, by a gather and
    one reduction (no atomics: the same bits on every run)."""
    e, c, _ = ye.shape
    dev = ye.device
    slot = torch.full((e, t), e * c, dtype=torch.long, device=dev)
    slot.scatter_(1, gi, torch.arange(e * c, device=dev).view(e, c))
    rows = slot[choices, torch.arange(t, device=dev)[:, None]]   # (T, k)
    return _Combine.apply(ye, gi, rows)


def _expert_compute(x2d: torch.Tensor, gates: torch.Tensor,
                    choices: torch.Tensor, w_gate, w_up, w_down,
                    capacity: int) -> torch.Tensor:
    """The reference's capacity-gather expert FFN over x2d (T, D) and
    gates (T, E): each expert's top-``capacity`` tokens by gate, the
    gated FFN, and the combine back to (T, D); ``choices`` (T, k) are
    the experts each token routed to (:func:`route`)."""
    t = x2d.shape[0]
    gw, gi = top_k(gates.t(), min(capacity, t))                  # (E, C)
    ye = expert_ffn(x2d[gi], gw, w_gate, w_up, w_down)           # (E, C, D)
    return combine(ye, gi, choices, t)


def capacity_of(t: int, cfg: MoEConfig,
                policy: ShardingPolicy = UNSHARDED) -> int:
    """Expert capacity for ``t`` tokens: ceil(t k cf / E), at least 1."""
    t_eff = max(t // max(policy.batch_size_divisor, 1), 1)
    return max(1, math.ceil(t_eff * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            policy: ShardingPolicy = UNSHARDED,
            mask: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss (float32)).

    ``mask`` (S,) bool marks real (non-pad) positions: pads get zero
    gates after routing, so they take no expert's capacity (they still
    count in the aux loss and in T, as in the reference)."""
    if policy.mesh is not None and not policy.replicas_only:
        raise NotImplementedError(
            "the expert-parallel moe paths come with ROADMAP.md queue 1 "
            "item 12b-1c")
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, aux, choices = route(x2d, params["router"], cfg.top_k)
    if mask is not None:
        m2d = mask[None, :].expand(b, s).reshape(b * s)
        gates = gates * m2d[:, None].to(gates.dtype)
    out = _expert_compute(x2d, gates, choices, params["w_gate"],
                          params["w_up"], params["w_down"],
                          capacity_of(b * s, cfg, policy))
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_spec(path: str, shape, policy: ShardingPolicy,
             stacked: bool = True) -> Optional[P]:
    """PartitionSpec of a moe param leaf (None if not one): the experts
    E over the model axis, D over fsdp (the 2-D ``ep2d`` layout: E over
    its axis, F over the model axis); the router replicated.
    ``stacked``: a leading layer dim."""
    lead = (None,) if stacked else ()
    m, f = policy.model_axis, policy.fsdp_axes
    f = f[0] if f and len(f) == 1 else f
    if path.endswith("router"):
        return P(*lead, None, None)
    if policy.ep2d_axis is not None:
        dax = policy.ep2d_axis
        if path.endswith(("w_gate", "w_up")) and len(shape) == len(lead) + 3:
            return P(*lead, dax, None, m)
        if path.endswith("w_down") and len(shape) == len(lead) + 3:
            return P(*lead, dax, m, None)
    if path.endswith(("w_gate", "w_up")) and len(shape) == len(lead) + 3:
        return P(*lead, m, f, None)
    if path.endswith("w_down") and len(shape) == len(lead) + 3:
        return P(*lead, m, None, f)
    return None
