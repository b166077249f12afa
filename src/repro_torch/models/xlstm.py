"""xLSTM: mLSTM (matrix-memory, chunkwise-parallel) and sLSTM (scalar-
memory, true recurrence) blocks. [arXiv:2405.04517] The port of
``repro.models.xlstm``, function for function.

* mLSTM: exponential input gates (pre-activation soft-capped at 15,
  ``cap * tanh(x / cap)``) and sigmoid forget gates, run in the
  chunkwise-parallel form: the intra-chunk (C x C) products of every
  chunk in one batched product, then the inter-chunk recurrence over the
  matrix state, a Python loop over the chunks (the reference's
  ``lax.scan``). The normalizer is the paper's ``max(|q . n|, 1)``.
* sLSTM keeps the paper's running-max stabilizer (m_t) and is a loop over
  time in torch ops, one block-diagonal (per-head) float32 product
  ``h @ r`` and the gates each step; under autograd the loop has its own
  backward (:class:`_SLSTMScan`). No kernel covers it: the reference
  has no Pallas counterpart (its docstring names the RG-LRU kernel's
  pattern as the analogue).

Params keep the reference's layout: the mLSTM and sLSTM blocks stacked on
a leading dim under ``"mlstm"`` and ``"slstm"``, split with one ``unbind``
per call (see ``models/rglru.py``). The stack runs every mLSTM block,
then every sLSTM block, in the reference's order (its comment calls this
equivalent to interleaving "up to block permutation", which holds in
distribution over random inits, not for given weights). With
``cfg.remat`` the training forward runs each block under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
scan bodies in ``jax.checkpoint``.

Decode state per layer: mLSTM {"C": (B, H, dk, dv), "n": (B, H, dk)};
sLSTM {"h", "c", "n", "m": (B, H, dh)}, stacked over the layers.

Batched == serial (the serving scheduler's promise). BLAS chooses a
kernel, and with it the order of its sums, by a product's shape, so no
product here takes a shape from the batch: the projections go through
``common.matmul`` (one sequence at a time), the chunkwise cell and
decode's ``q . C`` run one sequence at a time, the sLSTM's recurrent
product runs on rows padded to a multiple of ``common.DECODE_ROWS``, and
decode pads the residual stream's rows as the other families do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy
from repro_torch.utils.trees import tree_map, tree_stack, tree_unstack

GATE_CAP = 15.0


def _cap(x):
    return GATE_CAP * torch.tanh(x / GATE_CAP)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_mlstm_block(gen, cfg: ModelConfig, dtype, dev) -> dict:
    d = cfg.d_model
    d_in = int(cfg.xlstm_proj_factor * d)
    h = cfg.n_heads
    return {
        "ln": common.init_rmsnorm(d, dtype, dev),
        "w_up": common.dense_init(gen, (d, 2 * d_in), dtype).to(dev),
        "wq": common.dense_init(gen, (d_in, d_in), dtype).to(dev),
        "wk": common.dense_init(gen, (d_in, d_in), dtype).to(dev),
        "wv": common.dense_init(gen, (d_in, d_in), dtype).to(dev),
        "w_if": common.dense_init(gen, (d_in, 2 * h), dtype,
                                  scale=0.01).to(dev),
        "b_if": torch.cat([
            torch.zeros((h,), dtype=torch.float32),         # input gate bias
            torch.linspace(3.0, 6.0, h, dtype=torch.float32)  # forget gate
        ]).to(dev, dtype),
        "out_norm": common.init_rmsnorm(d_in, dtype, dev),
        "w_down": common.dense_init(gen, (d_in, d), dtype).to(dev),
    }


def _init_slstm_block(gen, cfg: ModelConfig, dtype, dev) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "ln": common.init_rmsnorm(d, dtype, dev),
        "w_in": common.dense_init(gen, (d, 4 * d), dtype).to(dev),  # z,i,f,o
        "r": common.dense_init(gen, (h, dh, 4 * dh), dtype,
                               scale=0.02).to(dev),
        "b": torch.zeros((4 * d,), dtype=dtype, device=dev),
        "out_norm": common.init_rmsnorm(d, dtype, dev),
        "w_out": common.dense_init(gen, (d, d), dtype).to(dev),
    }


def _block_counts(cfg: ModelConfig):
    """(mLSTM blocks, sLSTM blocks)."""
    n_s = cfg.n_layers // cfg.xlstm_slstm_every
    return cfg.n_layers - n_s, n_s


def init_xlstm_params(generator: torch.Generator, cfg: ModelConfig,
                      device="cuda") -> dict:
    """Random params in the reference's layout, drawn from ``generator``
    on its own device and placed on ``device``."""
    dtype = getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)
    n_m, n_s = _block_counts(cfg)
    return {
        "embed": common.init_embedding(generator, cfg.padded_vocab,
                                       cfg.d_model, dtype, dev),
        "mlstm": common.init_stacked(
            lambda: _init_mlstm_block(generator, cfg, dtype, dev), n_m),
        "slstm": common.init_stacked(
            lambda: _init_slstm_block(generator, cfg, dtype, dev), n_s),
        "ln_f": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "lm_head": common.init_unembed(generator, cfg.padded_vocab,
                                       cfg.d_model, dtype, dev),
    }


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------
def _mlstm_qkvif(block: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B,S,D) -> q,k,v (B,S,H,dh); li,lf (B,S,H) f32; z gate
    (B,S,D_in). The projections run in ``x``'s dtype, the gates in
    float32 from that product."""
    d_in = block["wq"].shape[0]
    h = cfg.n_heads
    dh = d_in // h
    dt = x.dtype
    up = common.matmul(x, block["w_up"].to(dt))
    main, z = torch.chunk(up, 2, dim=-1)
    q = common.matmul(main, block["wq"].to(dt))
    k = common.matmul(main, block["wk"].to(dt))
    v = common.matmul(main, block["wv"].to(dt))
    gates = (common.matmul(main, block["w_if"].to(dt)).float()
             + block["b_if"].float())
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)   # (B,S,H)
    li = _cap(i_raw)                               # log input gate
    lf = F.logsigmoid(f_raw)                       # log forget gate
    b, s, _ = x.shape
    shape = (b, s, h, dh)
    # JAX rounds the Python float to q's dtype before dividing (a weak
    # type): at bfloat16, sqrt(128) is 11.3125
    scale = torch.tensor(math.sqrt(dh), dtype=q.dtype)
    return (q.reshape(shape) / scale, k.reshape(shape), v.reshape(shape),
            li, lf, z)


def _chunkwise_one(q, k, v, li, lf, c, C0, n0):
    """One sequence's chunkwise mLSTM. q,k,v (S,H,dh) (any float dtype);
    li,lf (S,H) f32; chunk length ``c`` dividing S; C0 (H,dh,dh), n0
    (H,dh) f32. Returns (y (S,H,dh) f32, C, n)."""
    s, h, dh = q.shape
    n_chunks = s // c

    def to_chunks(x):        # (S, H, ...) -> (N, H, C, ...) float32
        x = x.float().reshape(n_chunks, c, h, *x.shape[2:])
        return x.transpose(1, 2).contiguous()

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)   # (N,H,C,dh)
    lic, lfc = to_chunks(li), to_chunks(lf)                  # (N,H,C)
    bcum = torch.cumsum(lfc, dim=-1)              # (N,H,C) inclusive
    # intra-chunk decayed weights: w[t,j] = exp(b_t - b_j + li_j), j<=t;
    # exp before the mask, as the reference takes it
    logw = bcum[..., :, None] - bcum[..., None, :] + lic[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    w = torch.where(mask, torch.exp(logw), 0.0)                # (N,H,C,C)
    scores = torch.matmul(qc, kc.transpose(-1, -2)) * w
    y_intra = torch.matmul(scores, vc)                         # (N,H,C,dh)
    # q.n_t = sum_j w_tj (q_t . k_j) = row-sum of the weighted scores
    n_intra = torch.sum(scores, dim=-1)                        # (N,H,C)
    # the carried state's contribution, decayed by exp(b_t)
    qe = qc * torch.exp(bcum)[..., None]
    btot = bcum[..., -1]                                       # (N,H)
    decay = torch.exp(btot[..., None] - bcum + lic)            # (N,H,C)
    kd = kc * decay[..., None]
    fade = torch.exp(btot)
    Cm, n = C0, n0
    ys = []
    for t in range(n_chunks):
        y_inter = torch.matmul(qe[t], Cm)                      # (H,C,dh)
        n_inter = torch.matmul(qe[t], n[..., None])[..., 0]    # (H,C)
        y = y_inter + y_intra[t]
        qn = n_inter + n_intra[t]
        ys.append(y / torch.clamp_min(torch.abs(qn), 1.0)[..., None])
        # chunk-end state update
        Cm = Cm * fade[t][:, None, None] + \
            torch.matmul(kd[t].transpose(-1, -2), vc[t])
        n = n * fade[t][:, None] + torch.sum(kd[t], dim=1)
    y = torch.stack(ys).transpose(1, 2).reshape(s, h, dh)
    return y, Cm, n


def mlstm_chunkwise(q, k, v, li, lf, chunk: int, state=None):
    """Chunkwise mLSTM. q,k,v (B,S,H,dh); li,lf (B,S,H) f32.

    Returns (y (B,S,H,dh) in q's dtype, final_state {"C", "n"}). A length
    that the chunk does not divide runs as one S x S chunk, as in the
    reference. Each sequence runs alone (the products' shapes do not
    depend on B)."""
    b, s, h, dh = q.shape
    c = min(chunk, s)
    if s % c != 0:
        c = s
    if state is None:
        C0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
        n0 = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    else:
        C0, n0 = state["C"], state["n"]
    outs = [_chunkwise_one(q[i], k[i], v[i], li[i], lf[i], c, C0[i], n0[i])
            for i in range(b)]
    y = torch.stack([o[0] for o in outs]).to(q.dtype)
    return y, {"C": torch.stack([o[1] for o in outs]),
               "n": torch.stack([o[2] for o in outs])}


def mlstm_step(q, k, v, li, lf, state):
    """Single-token mLSTM (unstabilised, as the reference's). q,k,v
    (B,1,H,dh); li,lf (B,1,H); state {"C", "n"} (any other key is
    ignored). ``q . C`` and ``q . n`` run one sequence at a time."""
    q32 = q[:, 0].float()   # (B,H,dh)
    k32 = k[:, 0].float()
    v32 = v[:, 0].float()
    i_g = torch.exp(li[:, 0])[..., None]   # (B,H,1)
    f_g = torch.exp(lf[:, 0])[..., None]
    ki = k32 * i_g
    C = state["C"] * f_g[..., None] + ki[..., :, None] * v32[..., None, :]
    n = state["n"] * f_g + ki
    y = torch.stack([torch.matmul(q32[i][:, None], C[i])[:, 0]
                     for i in range(q.shape[0])])                # (B,H,dh)
    qn = torch.stack([torch.matmul(q32[i][:, None], n[i][..., None])[:, 0, 0]
                      for i in range(q.shape[0])])               # (B,H)
    y = y / torch.clamp_min(torch.abs(qn), 1.0)[..., None]
    return y[:, None].to(q.dtype), {"C": C, "n": n}


def mlstm_block(block: dict, x: torch.Tensor, cfg: ModelConfig,
                state=None, decode: bool = False):
    """One mLSTM block over the residual stream ``x``. In decode the
    stream may carry pad rows past the state's: the cell runs on the
    state's rows only."""
    xn = common.rmsnorm(block["ln"], x, cfg.norm_eps)
    q, k, v, li, lf, z = _mlstm_qkvif(block, xn, cfg)
    if decode:
        n = state["C"].shape[0]
        y, new_state = mlstm_step(q[:n], k[:n], v[:n], li[:n], lf[:n], state)
        y = common.pad_rows(y, x.shape[0])
    else:
        y, new_state = mlstm_chunkwise(q, k, v, li, lf, cfg.xlstm_chunk, state)
    b, s, h, dh = y.shape
    y = y.reshape(b, s, h * dh)
    y = common.rmsnorm(block["out_norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    out = common.matmul(y, block["w_down"].to(y.dtype))
    return x + out.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# sLSTM cell — sequential scan with running-max stabilizer
# ---------------------------------------------------------------------------
def slstm_cell(wx: torch.Tensor, r: torch.Tensor, state: dict):
    """One sLSTM step. wx: (B,H,4,dh) precomputed input contribution (f32);
    r: (H, dh, 4*dh) recurrent weights; state {"h","c","n","m"}: (B,H,dh).
    """
    h_prev = state["h"]
    # "bhd,hde->bhe": one product a head
    rec = torch.bmm(h_prev.transpose(0, 1), r.float()).transpose(0, 1)
    b_, hh, dh4 = rec.shape
    dh = dh4 // 4
    pre = wx + rec.reshape(b_, hh, 4, dh)
    z_r, i_r, f_r, o_r = pre.unbind(2)
    z = torch.tanh(z_r)
    f_m = f_r + state["m"]
    m_new = torch.maximum(f_m, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(f_m - m_new)
    c = f_g * state["c"] + i_g * z
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_r) * c / torch.clamp_min(n, 1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_init_state(batch: int, h: int, dh: int, device):
    """A zero sLSTM state of ``batch`` rows and ``h`` heads of ``dh`` on
    ``device`` (``m`` at -1e30)."""
    zero = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return {"h": zero, "c": zero, "n": zero,
            "m": torch.full((batch, h, dh), -1e30, dtype=torch.float32,
                            device=device)}


def _scan(wx, r, state, keep: bool):
    """``slstm_cell`` at each step of wx (R,S,H,4,dh). Returns (h
    (R,S,H,dh), the final state, and with ``keep`` the c, n and m of
    every step, each (R,S,H,dh))."""
    hs, cs, ns, ms = [], [], [], []
    for t in range(wx.shape[1]):
        state = slstm_cell(wx[:, t], r, state)
        hs.append(state["h"])
        if keep:
            cs.append(state["c"])
            ns.append(state["n"])
            ms.append(state["m"])
    seq = [torch.stack(x, dim=1) for x in (cs, ns, ms)] if keep else None
    return torch.stack(hs, dim=1), state, seq


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence with its own backward. Autograd's backward of
    the loop takes the recurrent weights' gradient one step at a time, a
    rank-R product a step (R = 8 rows: one of the card's slowest product
    shapes), and runs ~50 kernels a step through the autograd engine.
    Here the backward recomputes every step's gates at once from the
    saved states (one product), walks the steps back in torch ops (the
    carried gradients and one product a step through r), and takes the
    weights' gradient as one product over all steps."""

    @staticmethod
    def forward(ctx, wx, r, h0, c0, n0, m0):
        hs, st, seq = _scan(wx, r, {"h": h0, "c": c0, "n": n0, "m": m0},
                            keep=True)
        ctx.save_for_backward(wx, r, h0, c0, n0, m0, hs, *seq)
        return hs, st["c"], st["n"], st["m"]

    @staticmethod
    def backward(ctx, d_hs, d_c, d_n, d_m):
        wx, r, h0, c0, n0, m0, hs, cs, ns, ms = ctx.saved_tensors
        rows, s, h, _, dh = wx.shape

        def steps(x):            # (R,S,H,...) -> (S,H,R,...) contiguous
            return x.transpose(0, 1).transpose(1, 2).contiguous()

        def before(x0, x):       # every step's previous value
            return torch.cat([x0[:, None], x[:, :-1]], dim=1)

        h_prev = before(h0, hs)
        hp = steps(h_prev)                                   # (S,H,R,dh)
        rec = torch.matmul(hp.transpose(0, 1).reshape(h, s * rows, dh), r)
        pre = steps(wx) + rec.view(h, s, rows, 4, dh).transpose(0, 1)
        z_r, i_r, f_r, o_r = pre.unbind(3)                   # (S,H,R,dh)
        c, n, m = steps(cs), steps(ns), steps(ms)
        f_m = f_r + steps(before(m0, ms))
        z = torch.tanh(z_r)
        i_g = torch.exp(i_r - m)
        f_g = torch.exp(f_m - m)
        o = torch.sigmoid(o_r)
        nn = torch.clamp_min(n, 1e-6)
        # the factors of each step's gradients that do not depend on them
        to_c = o / nn                              # dh -> dc
        to_o = c / nn * o * (1.0 - o)              # dh -> d o_r
        to_n = -(o * c / (nn * nn)) * (n >= 1e-6)  # dh -> dn
        to_z = i_g * (1.0 - z * z)                 # dc -> d z_r
        cf, nf = steps(before(c0, cs)) * f_g, steps(before(n0, ns)) * f_g
        zi = z * i_g
        # torch.maximum's gradient: to the larger side, half each at a tie
        pick_f = (f_m > i_r).float() + 0.5 * (f_m == i_r).float()
        pick_i = 1.0 - pick_f
        del pre, rec, z_r, i_r, f_r, o_r, c, n, z, o, nn
        zero = torch.zeros_like(h0.transpose(0, 1))          # (H,R,dh)

        def carried(g):
            return zero if g is None else g.transpose(0, 1)

        gh = d_hs.transpose(0, 1).transpose(1, 2)            # (S,H,R,dh)
        dc, dn, dm = carried(d_c), carried(d_n), carried(d_m)
        dh_in = zero
        d_pre = torch.empty((s, h, rows, 4, dh), dtype=wx.dtype,
                            device=wx.device)
        r_t = r.transpose(1, 2)
        for t in range(s - 1, -1, -1):
            g = gh[t] + dh_in
            dc = torch.addcmul(dc, g, to_c[t])
            dn = torch.addcmul(dn, g, to_n[t])
            slot = d_pre[t].unbind(2)                        # z, i, f, o
            torch.mul(g, to_o[t], out=slot[3])
            torch.mul(dc, to_z[t], out=slot[0])
            a = torch.addcmul(dc * cf[t], dn, nf[t])        # d f_m via f_g
            b = torch.addcmul(dc * zi[t], dn, i_g[t])       # d i_r via i_g
            dm_new = dm - a - b
            torch.addcmul(a, dm_new, pick_f[t], out=slot[2])
            torch.addcmul(b, dm_new, pick_i[t], out=slot[1])
            dm = slot[2]
            dc = dc * f_g[t]
            dn = dn * f_g[t]
            dh_in = torch.bmm(d_pre[t].view(h, rows, 4 * dh), r_t)
        d_r = torch.matmul(
            hp.transpose(0, 1).reshape(h, s * rows, dh).transpose(1, 2),
            d_pre.transpose(0, 1).reshape(h, s * rows, 4 * dh))
        d_wx = d_pre.transpose(1, 2).transpose(0, 1)         # (R,S,H,4,dh)
        back = [x.transpose(0, 1) for x in (dh_in, dc, dn, dm)]
        return (d_wx, d_r, *back)


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, state: dict):
    """The recurrence over a prompt: ``slstm_cell`` at each step, a loop
    over time (the reference's ``lax.scan``). wx (R,S,H,4,dh) f32, r
    (H,dh,4*dh) f32, state (R,H,dh). Returns (h (R,S,H,dh), state).
    Under autograd it runs as :class:`_SLSTMScan` (the same forward, its
    own backward)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (wx, r, *state.values())):
        hs, c, n, m = _SLSTMScan.apply(wx, r, state["h"], state["c"],
                                       state["n"], state["m"])
        return hs, {"h": hs[:, -1], "c": c, "n": n, "m": m}
    hs, state, _ = _scan(wx, r, state, keep=False)
    return hs, state


def slstm_block(block: dict, x: torch.Tensor, cfg: ModelConfig,
                state=None, decode: bool = False):
    """One sLSTM block over the residual stream ``x``. The recurrence runs
    on rows padded to a multiple of ``common.DECODE_ROWS`` (its product's
    shape then does not depend on B); ``r`` is cast to float32 once."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xn = common.rmsnorm(block["ln"], x, cfg.norm_eps)
    wx = (common.matmul(xn, block["w_in"].to(xn.dtype)).float()
          + block["b"].float())
    rows = common.row_bucket(b)
    wx = common.pad_rows(wx.reshape(b, s, h, 4, dh), rows)
    if state is None:
        state = slstm_init_state(b, h, dh, x.device)
    n = state["h"].shape[0]
    st = tree_map(lambda t: common.pad_rows(t, rows), state)
    r32 = block["r"].float()
    if decode:
        st = slstm_cell(wx[:, 0], r32, st)
        hs = st["h"][:, None]                             # (R,1,H,dh)
    else:
        hs, st = slstm_scan(wx, r32, st)
    new_state = tree_map(lambda t: t[:n], st)
    y = hs[:b].reshape(b, -1, d).to(x.dtype)
    y = common.rmsnorm(block["out_norm"], y, cfg.norm_eps)
    out = common.matmul(y, block["w_out"].to(y.dtype))
    return x + out.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _zero_states(cfg: ModelConfig, batch: int, device) -> dict:
    n_m, n_s = _block_counts(cfg)
    dh_m = int(cfg.xlstm_proj_factor * cfg.d_model) // cfg.n_heads
    dh_s = cfg.d_model // cfg.n_heads
    m_state = {
        "C": torch.zeros((n_m, batch, cfg.n_heads, dh_m, dh_m),
                         dtype=torch.float32, device=device),
        "n": torch.zeros((n_m, batch, cfg.n_heads, dh_m),
                         dtype=torch.float32, device=device),
    }
    s_state = tree_map(
        lambda z: z.expand((n_s,) + tuple(z.shape)).clone(),
        slstm_init_state(batch, cfg.n_heads, dh_s, device))
    return {"mlstm": m_state, "slstm": s_state}


def _forward(params, tokens, cfg: ModelConfig, states=None, decode=False):
    """Run the stack: every mLSTM block, then every sLSTM block (the
    reference's order). Returns (x after ``ln_f``, the final states)."""
    x = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if states is None:
        states = _zero_states(cfg, tokens.shape[0], x.device)
    remat = cfg.remat and not decode and torch.is_grad_enabled()

    def run(block_fn, block, x, st):
        if remat:
            return checkpoint(block_fn, block, x, cfg, st, decode,
                              use_reentrant=False)
        return block_fn(block, x, cfg, st, decode)

    new = {}
    for name, block_fn in (("mlstm", mlstm_block), ("slstm", slstm_block)):
        outs = []
        for block, st in zip(tree_unstack(params[name]),
                             tree_unstack(states[name]), strict=True):
            x, st = run(block_fn, block, x, st)
            outs.append(st)
        new[name] = tree_stack(outs) if outs else states[name]
    x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, new


def build_xlstm_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
                      window=None) -> Model:
    """The ssm model; ``policy`` gives the spec rules (its forward runs
    unsharded or under a replica policy, see
    :func:`repro_torch.models.get_model`) and ``window`` is taken and
    ignored, as the reference's builder does."""

    def loss_fn(params, batch):
        x, _ = _forward(params, batch["tokens"], cfg)
        logits = common.unembed_untied(params["lm_head"], x)
        loss = common.softmax_xent(logits, batch["labels"], cfg.vocab_size)
        return loss, {"xent": loss}

    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        x, states = _forward(params, tokens, cfg)
        logits = common.unembed_untied(
            params["lm_head"],
            common.pad_rows(x[:, -1:], common.row_bucket(b)))[:b]
        return logits, {"states": states, "pos": tokens.shape[1] - 1}

    def decode_fn(params, state, batch):
        b = batch["token"].shape[0]
        token = common.pad_rows(batch["token"], common.row_bucket(b))
        x, states = _forward(params, token, cfg, states=state["states"],
                             decode=True)
        logits = common.unembed_untied(params["lm_head"], x)[:b]
        return logits, {"states": states, "pos": state["pos"] + 1}

    def init_decode_state(batch_size: int, cache_len: int, device="cuda"):
        return {"states": _zero_states(cfg, batch_size,
                                       resolve_device(device)),
                "pos": cache_len - 1}

    def spec_rule(path: str, shape):
        if policy.mesh is None:
            return P()
        m = policy.model_axis
        f = policy.fsdp_axes
        f = f[0] if f and len(f) == 1 else f
        lead = (None,) if path.startswith(("mlstm/", "slstm/")) else ()
        if path.endswith("embed/table"):
            return P(m, None)
        if path.endswith("lm_head/proj"):
            return P(None, m)
        if path.endswith(("w_up", "wq", "wk", "wv", "w_in")):
            return P(*lead, f, m)
        if path.endswith(("w_down", "w_out")):
            return P(*lead, m, f)
        return P(*([None] * len(shape)))

    def state_spec_rule(path: str, shape):
        if policy.mesh is None:
            return P()
        # (L, B, H, ...): the batch over the batch axes, the rest
        # replicated (4 heads)
        if len(shape) >= 3:
            batch = policy.dim("batch", shape[1])
            return P(None, batch, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return Model(
        config=cfg,
        init=lambda generator, device="cuda": init_xlstm_params(
            generator, cfg, device),
        loss_fn=per_client_loss(loss_fn), prefill_fn=prefill_fn,
        decode_fn=decode_fn, init_decode_state=init_decode_state,
        policy=policy, spec_rule=spec_rule, state_spec_rule=state_spec_rule,
    )
