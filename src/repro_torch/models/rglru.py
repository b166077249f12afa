"""RecurrentGemma / Griffin: RG-LRU recurrent blocks + local sliding-window
attention, pattern "2r1a" (two recurrent blocks, then one local-attention
block). [arXiv:2402.19427] The port of ``repro.models.rglru``.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                    (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                    (input gate)
    log a_t = -c * softplus(Lambda) * r_t           (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates are torch ops; the recurrence over a prompt goes through
``kernels.ops.rglru_scan`` (the CUDA scan on the card) and local
attention through ``kernels.ops.flash_attention``; a decode step is the
single-step update and attends to a ring KV cache in torch ops. The
recurrent branch carries a width-4 temporal conv (shifted multiply-adds),
whose decode state is the last 3 inputs.

Params keep the reference's layout: the (r, r, a) triples stacked on a
leading dim under ``"triples"``, the trailing recurrent blocks under
``"tail"``; the reference's ``lax.scan`` over them is a Python loop here.
Each stacked leaf is split with one ``unbind`` per call, not indexed
layer by layer: the backward of ``x[i]`` writes a zero tensor the size of
the whole stacked leaf for every layer, the backward of ``unbind`` one
stack. With ``cfg.remat`` the training forward runs each triple and each
trailing block under ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps its scan bodies in ``jax.checkpoint``: only the residual
stream between them is kept, and the backward recomputes the rest.

Where the port parts from the reference, on purpose. The reference's
decode writes and rotates the new token at ``state["pos"]``, which after
prefill is the position of the last prompt token, and its prefill sizes
the ring cache ``min(window, S)``, so the first decoded token takes the
previous token's position and, for a prompt shorter than the window,
evicts position 0. Here decode writes at ``state["pos"] + 1`` (as the
reference's transformer family does) and prefill sizes the ring cache
to ``local_attn_window`` slots, slot = absolute position mod window.
Prefill logits and recurrent states are the reference's; the ring
caches hold the same keys and values (equal to the reference's whenever
the prompt is at least a window long); and ``prefill(t[:n]) +
decode(t[n])`` equals ``prefill(t[:n + 1])``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib, common
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy
from repro_torch.models.transformer import _sharded
from repro_torch.utils.trees import tree_map, tree_map_with_path, tree_stack, tree_unstack

RGLRU_C = 8.0
CONV_WIDTH = 4


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_recurrent_block(gen, cfg: ModelConfig, dtype, dev) -> dict:
    d = cfg.d_model
    dr = cfg.rglru_dim or d
    lin = torch.linspace(0.9, 0.999, dr, dtype=torch.float32)
    return {
        "ln": common.init_rmsnorm(d, dtype, dev),
        "w_main": common.dense_init(gen, (d, dr), dtype).to(dev),
        "w_gate": common.dense_init(gen, (d, dr), dtype).to(dev),
        "conv_w": common.dense_init(gen, (CONV_WIDTH, dr), dtype,
                                    scale=0.1).to(dev),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_a": common.dense_init(gen, (dr, dr), dtype, scale=0.01).to(dev),
        "b_a": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_x": common.dense_init(gen, (dr, dr), dtype, scale=0.01).to(dev),
        "b_x": torch.zeros((dr,), dtype=dtype, device=dev),
        # Lambda: a (at r = 1) ~ U[0.9, 0.999] (the paper's range):
        # softplus(lam) = -log(a)/c  =>  lam = log(expm1(-log(a)/c))
        "lam": torch.log(torch.expm1(-torch.log(lin) / RGLRU_C)).to(dev),
        "w_down": common.dense_init(gen, (dr, d), dtype).to(dev),
        "ln_mlp": common.init_rmsnorm(d, dtype, dev),
        "mlp": common.init_geglu(gen, d, cfg.d_ff, dtype, dev),
    }


def _init_attn_block(gen, cfg: ModelConfig, dtype, dev) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "ln": common.init_rmsnorm(d, dtype, dev),
        "wq": common.dense_init(gen, (d, cfg.n_heads * hd), dtype).to(dev),
        "wk": common.dense_init(gen, (d, cfg.n_kv_heads * hd), dtype).to(dev),
        "wv": common.dense_init(gen, (d, cfg.n_kv_heads * hd), dtype).to(dev),
        "wo": common.dense_init(gen, (cfg.n_heads * hd, d), dtype).to(dev),
        "ln_mlp": common.init_rmsnorm(d, dtype, dev),
        "mlp": common.init_geglu(gen, d, cfg.d_ff, dtype, dev),
    }


def _pattern_counts(cfg: ModelConfig):
    n_triples = cfg.n_layers // 3
    n_tail = cfg.n_layers - 3 * n_triples  # trailing recurrent blocks
    return n_triples, n_tail


def init_rglru_params(generator: torch.Generator, cfg: ModelConfig,
                      device="cuda", cut=None) -> dict:
    """Random params in the reference's layout, drawn from ``generator``
    on its own device and placed on ``device``. ``cut(path, tensor)``,
    if given, is applied to each leaf as soon as it is drawn (a block's
    leaves unstacked, under their ``triples/...`` or ``tail/...``
    paths), as ``transformer.init_decoder_params`` applies it."""
    dtype = getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)
    n_triples, n_tail = _pattern_counts(cfg)

    def keep(prefix, tree):
        if cut is None:
            return tree
        return tree_map_with_path(lambda path, x: cut(path, x), tree,
                                  prefix=prefix)

    params = {
        "embed": keep("embed/", common.init_embedding(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev)),
        "triples": common.init_stacked(lambda: keep("triples/", {
            "rec1": _init_recurrent_block(generator, cfg, dtype, dev),
            "rec2": _init_recurrent_block(generator, cfg, dtype, dev),
            "attn": _init_attn_block(generator, cfg, dtype, dev),
        }), n_triples),
        "ln_f": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "lm_head": keep("lm_head/", common.init_unembed(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev)),
    }
    if n_tail:
        params["tail"] = common.init_stacked(lambda: keep(
            "tail/", _init_recurrent_block(generator, cfg, dtype, dev)),
            n_tail)
    return params


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def _rglru_gates(block, xr, own=None):
    """xr (B, S, dr) f32 -> (a, gated input), both (B, S, dr) f32. With
    ``own``, the input's channels that ``w_a`` and ``w_x``'s columns
    (and the per-channel leaves) gate: the gates read all of ``xr`` and
    the outputs are ``own``'s channels (a model-axis rank's)."""
    own = xr if own is None else own
    r = torch.sigmoid(common.matmul(xr, block["w_a"].float())
                      + block["b_a"].float())
    i = torch.sigmoid(common.matmul(xr, block["w_x"].float())
                      + block["b_x"].float())
    log_a = -RGLRU_C * F.softplus(block["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i * own)
    return a, gated


def rglru_scan(block, xr, h0=None, own=None):
    """h_t = a_t h_{t-1} + u_t over a prompt through the scan kernel.
    xr (B, S, dr) f32; ``h0`` (B, dr) is folded into the first input;
    ``own`` as :func:`_rglru_gates`'."""
    a, u = _rglru_gates(block, xr, own)
    if h0 is not None:
        # h_1 = a_1 h_0 + u_1
        u = torch.cat([(u[:, 0] + a[:, 0] * h0)[:, None], u[:, 1:]], dim=1)
    return ops.rglru_scan(a, u)


def rglru_step(block, xr, h_prev, own=None):
    """xr (B, 1, dr); h_prev (B, dr); ``own`` as :func:`_rglru_gates`'."""
    a, u = _rglru_gates(block, xr, own)
    h = a[:, 0] * h_prev + u[:, 0]
    return h[:, None], h


def _conv1d(block, xr, conv_state=None):
    """Causal width-4 depthwise conv as shifted multiply-adds. xr
    (B, S, dr); conv_state (B, CONV_WIDTH - 1, dr) holds the previous
    inputs (decode). Returns (out, new_conv_state)."""
    w = block["conv_w"].to(xr.dtype)                    # (W, dr)
    if conv_state is None:
        pad = torch.zeros((xr.shape[0], CONV_WIDTH - 1, xr.shape[2]),
                          dtype=xr.dtype, device=xr.device)
    else:
        pad = conv_state.to(xr.dtype)
    xp = torch.cat([pad, xr], dim=1)                    # (B, S + W - 1, dr)
    s = xr.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i]
    out = out + block["conv_b"].to(xr.dtype)
    return out, xp[:, -(CONV_WIDTH - 1):].clone()


def recurrent_block(block, x, cfg: ModelConfig, state=None, decode=False):
    """Griffin recurrent block + its MLP. state: {"h": (B, dr), "conv":
    (B, W - 1, dr)} or None."""
    dt = getattr(torch, cfg.dtype)
    xn = common.rmsnorm(block["ln"], x, cfg.norm_eps).to(dt)
    main = common.matmul(xn, block["w_main"].to(dt))
    gate = common.gelu(common.matmul(xn, block["w_gate"].to(dt)))
    conv_state = state["conv"] if state is not None else None
    main, new_conv = _conv1d(block, main, conv_state)
    main32 = main.float()
    if decode:
        y, h_new = rglru_step(block, main32, state["h"])
    else:
        h0 = state["h"] if state is not None else None
        y = rglru_scan(block, main32, h0)
        h_new = y[:, -1].clone()
    y = y.to(dt) * gate
    out = common.matmul(y, block["w_down"].to(dt))
    x = x + out.to(x.dtype)
    # block-local MLP
    h = common.geglu(block["mlp"],
                     common.rmsnorm(block["ln_mlp"], x, cfg.norm_eps).to(dt))
    x = x + h.to(x.dtype)
    return x, {"h": h_new, "conv": new_conv.to(dt)}


def local_attn_block(block, x, cfg: ModelConfig, cache=None, pos=None,
                     decode=False):
    """Local-attention block + its MLP. Prefill returns ``(x, (k, v))``,
    the block's rotated keys and values (B, S, Hkv, hd); decode writes
    the token at ``pos`` into ``cache`` and returns ``(x, new_cache)``."""
    dt = getattr(torch, cfg.dtype)
    h, out_state = local_attention(block, x, cfg, cache, pos, decode)
    x = x + h.to(x.dtype)
    h2 = common.geglu(block["mlp"],
                      common.rmsnorm(block["ln_mlp"], x, cfg.norm_eps).to(dt))
    x = x + h2.to(x.dtype)
    return x, out_state


def local_attention(block, x, cfg: ModelConfig, cache=None, pos=None,
                    decode=False):
    """The attention half of :func:`local_attn_block`: (its output in the
    compute dtype, before the residual add; the state as that block's)."""
    dt = getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim
    b, s = x.shape[:2]
    xn = common.rmsnorm(block["ln"], x, cfg.norm_eps).to(dt)
    q = common.matmul(xn, block["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = common.matmul(xn, block["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = common.matmul(xn, block["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    if decode:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, posv, cfg.rope_theta)
        k = common.apply_rope(k, posv, cfg.rope_theta)
        out_state = attn_lib.cache_update(cache, k, v, pos)
        o = attn_lib.decode_attention(q, out_state, pos)
    else:
        positions = torch.arange(s, device=x.device)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        if cfg.local_attn_window < s:
            o = attn_lib.windowed_attention(q, k, v,
                                            window=cfg.local_attn_window)
        else:
            o = attn_lib.causal_attention(q, k, v)
        out_state = (k, v)
    o = o.reshape(b, -1, cfg.n_heads * hd)
    return common.matmul(o, block["wo"].to(dt)), out_state


def _ring_cache(k, v, window: int) -> dict:
    """A ``window``-slot ring cache holding the last min(window, S)
    positions of prefill's (B, S, Hkv, hd) keys and values at slot =
    position mod window; slots no position reached stay zero."""
    b, s = k.shape[:2]
    n = min(window, s)
    slots = torch.arange(s - n, s, device=k.device) % window
    cache = attn_lib.init_cache(b, window, k.shape[2], k.shape[3], k.dtype,
                                k.device)
    cache["k"][:, slots] = k[:, s - n:]
    cache["v"][:, slots] = v[:, s - n:]
    return cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _zero_rec_state(batch, dr, dt, dev, h_width=None):
    return {"h": torch.zeros((batch, h_width or dr), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, dr), dtype=dt,
                                device=dev)}


def zero_state(cfg: ModelConfig, batch_size: int, cache_len: int, dev,
               h_width=None) -> dict:
    """A zero decode state of ``batch_size`` rows and ``cache_len`` ring
    slots; ``h_width`` the RG-LRU states' channels (default all dr, a
    model-axis rank's dr / M)."""
    dr = cfg.rglru_dim or cfg.d_model
    dt = getattr(torch, cfg.dtype)
    n_triples, n_tail = _pattern_counts(cfg)

    def stacked(tree, n):
        return tree_map(lambda z: z.expand((n,) + tuple(z.shape)).clone(),
                        tree)

    rec = lambda: _zero_rec_state(batch_size, dr, dt, dev, h_width)
    state = {"triples": stacked({
        "rec1": rec(), "rec2": rec(),
        "attn": attn_lib.init_cache(batch_size, cache_len, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, dt, dev),
    }, n_triples), "pos": cache_len - 1}
    if n_tail:
        state["tail"] = stacked(rec(), n_tail)
    return state


class Blocks:
    """The blocks as the serving loops call them, on the whole model;
    ``rglru_tp.HybridShards`` has the same methods on a rank's shards."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def recurrent(self, block, x, state=None, decode=False):
        return recurrent_block(block, x, self.cfg, state, decode)

    def attention(self, block, x, cache=None, pos=None, decode=False):
        return local_attn_block(block, x, self.cfg, cache, pos, decode)

    def gather_layer(self, layer, prefix):
        return layer

    def zero_state(self, batch_size, cache_len, dev):
        return zero_state(self.cfg, batch_size, cache_len, dev)


def prefill_layers(blocks, params, x):
    """Prefill's pass of the stream ``x`` (B, S, D) over the blocks:
    (the stream, the decode state; its ``pos`` the last prompt token's
    position, so decode writes at pos + 1)."""
    window = blocks.cfg.local_attn_window
    triple_states = []
    for triple in tree_unstack(params["triples"]):
        triple = blocks.gather_layer(triple, "triples/")
        x, st1 = blocks.recurrent(triple["rec1"], x)
        x, st2 = blocks.recurrent(triple["rec2"], x)
        x, (k, v) = blocks.attention(triple["attn"], x)
        triple_states.append({"rec1": st1, "rec2": st2,
                              "attn": _ring_cache(k, v, window)})
    state = {"triples": tree_stack(triple_states) if triple_states else
             blocks.zero_state(x.shape[0], window, x.device)["triples"],
             "pos": x.shape[1] - 1}
    if "tail" in params:
        tail_states = []
        for block in tree_unstack(params["tail"]):
            x, st = blocks.recurrent(blocks.gather_layer(block, "tail/"), x)
            tail_states.append(st)
        state["tail"] = tree_stack(tail_states)
    return x, state


def decode_layers(blocks, params, state, x):
    """One token's pass of ``x`` (R, 1, D) over the blocks, at
    ``state["pos"] + 1``: (the stream, the new state)."""
    pos = state["pos"] + 1     # the incoming token's position
    triple_states = []
    for triple, st in zip(tree_unstack(params["triples"]),
                          tree_unstack(state["triples"]), strict=True):
        triple = blocks.gather_layer(triple, "triples/")
        x, r1 = blocks.recurrent(triple["rec1"], x, st["rec1"], decode=True)
        x, r2 = blocks.recurrent(triple["rec2"], x, st["rec2"], decode=True)
        x, cache = blocks.attention(triple["attn"], x, cache=st["attn"],
                                    pos=pos, decode=True)
        triple_states.append({"rec1": r1, "rec2": r2, "attn": cache})
    new = {"triples": tree_stack(triple_states) if triple_states
           else state["triples"], "pos": pos}
    if "tail" in params:
        tail_states = []
        for block, st in zip(tree_unstack(params["tail"]),
                             tree_unstack(state["tail"]), strict=True):
            x, r = blocks.recurrent(blocks.gather_layer(block, "tail/"), x,
                                    st, decode=True)
            tail_states.append(r)
        new["tail"] = tree_stack(tail_states)
    return x, new


def pad_state(state: dict, rows: int) -> dict:
    """The decode state's rows padded to ``rows``."""
    return {k: v if k == "pos" else tree_map(
        lambda z: common.pad_rows(z, rows, dim=1), v)
        for k, v in state.items()}


def cut_state(state: dict, b: int) -> dict:
    """The decode state's first ``b`` rows."""
    return {k: v if k == "pos" else tree_map(lambda z: z[:, :b], v)
            for k, v in state.items()}


def build_rglru_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
                      window=None) -> Model:
    """The hybrid model; ``policy`` gives the spec rules; ``window`` is
    taken and ignored, as the reference's ``build_rglru_model`` does (its
    window is the config's). Under a model, seq, fsdp or batch axis its
    functions run on this rank's shards (``rglru_tp``)."""
    dt = getattr(torch, cfg.dtype)
    embed_scale = math.sqrt(cfg.d_model)

    # ---------------- training forward ----------------
    def triple_body(triple, x):
        x, _ = recurrent_block(triple["rec1"], x, cfg)
        x, _ = recurrent_block(triple["rec2"], x, cfg)
        x, _ = local_attn_block(triple["attn"], x, cfg)
        return x

    def tail_body(block, x):
        return recurrent_block(block, x, cfg)[0]

    def run(body, layer, x):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, layer, x, use_reentrant=False)
        return body(layer, x)

    def forward(params, tokens):
        x = common.embed(params["embed"], tokens).to(dt)
        x = common.weak_scale(x, embed_scale)
        for triple in tree_unstack(params["triples"]):
            x = run(triple_body, triple, x)
        for block in tree_unstack(params.get("tail", {})):
            x = run(tail_body, block, x)
        return common.rmsnorm(params["ln_f"], x, cfg.norm_eps)

    def loss_fn(params, batch):
        x = forward(params, batch["tokens"])
        logits = common.unembed_untied(params["lm_head"], x)
        loss = common.softmax_xent(logits, batch["labels"], cfg.vocab_size)
        return loss, {"xent": loss}

    # ---------------- serving ----------------
    blocks = Blocks(cfg)

    def decode_fn(params, state, batch):
        b = batch["token"].shape[0]
        rows = common.row_bucket(b)
        x = common.embed(params["embed"], common.pad_rows(batch["token"],
                                                          rows)).to(dt)
        x = common.weak_scale(x, embed_scale)
        x, new_state = decode_layers(blocks, params, pad_state(state, rows),
                                     x)
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = common.unembed_untied(params["lm_head"], x)
        return logits[:b], cut_state(new_state, b)

    def prefill_fn(params, batch):
        # the reference scales before the cast here (its forward and
        # decode cast first)
        x = (common.embed(params["embed"], batch["tokens"])
             * embed_scale).to(dt)
        x, state = prefill_layers(blocks, params, x)
        x = common.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        b = x.shape[0]
        logits = common.unembed_untied(params["lm_head"],
                                       common.pad_rows(x, common.row_bucket(b)))[:b]
        return logits, state

    def init_decode_state(batch_size: int, cache_len: int, device="cuda"):
        return zero_state(cfg, batch_size,
                          min(cache_len, cfg.local_attn_window),
                          resolve_device(device))

    model = Model(
        config=cfg,
        init=lambda generator, device="cuda": init_rglru_params(
            generator, cfg, device),
        loss_fn=per_client_loss(loss_fn), prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        init_decode_state=init_decode_state,
        policy=policy, spec_rule=make_spec_rule(cfg, policy),
        state_spec_rule=make_state_spec_rule(cfg, policy),
    )
    if not _sharded(policy):
        return model
    from repro_torch.models import rglru_tp
    return rglru_tp.sharded_model(model, cfg, policy)


def make_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """The reference's param rule: the embedding over the vocab rows,
    ``lm_head`` over its columns, ``w_main``, ``w_gate`` and the MLP's
    ``w_up`` column-split and both ``w_down`` row-split, ``w_a`` and
    ``w_x`` over their output channels, the attention's weights
    replicated over the model axis (10 q heads, 1 kv head), fsdp on the
    other dim; the rest replicated."""
    def rule(path: str, shape):
        if policy.mesh is None:
            return P()
        m = policy.model_axis
        f = policy.fsdp_axes
        f = f[0] if f and len(f) == 1 else f
        lead = (None,) if path.startswith(("triples/", "tail/")) else ()
        if path.endswith("embed/table"):
            return P(m, None)
        if path.endswith("lm_head/proj"):
            return P(None, m)
        if path.endswith(("w_main", "w_gate", "mlp/w_up")):
            return P(*lead, f, m)
        if path.endswith(("w_down", "mlp/w_down")):
            return P(*lead, m, f)
        if path.endswith(("w_a", "w_x")):
            return P(*lead, None, m)
        if path.endswith(("wq", "wk", "wv")):
            # 10 q heads / 1 kv head on a 16-way axis: replicate heads
            return P(*lead, f, None)
        if path.endswith("wo"):
            return P(*lead, None, f)
        return P(*([None] * len(shape)))

    return rule


def make_state_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """The reference's decode-state rule: every leaf's batch dim over
    the batch axes, the RG-LRU states' channels over the model axis
    where they divide; the conv states and ring caches replicated over
    it."""
    def rule(path: str, shape):
        if policy.mesh is None:
            return P()
        if len(shape) >= 2:
            batch = policy.dim("batch", shape[1])
            # the RG-LRU channel dim over the model axis where it divides
            if path.endswith("/h") and len(shape) == 3:
                return P(None, batch, policy.dim("model", shape[2]))
            return P(None, batch, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return rule
