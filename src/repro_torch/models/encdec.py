"""Encoder-decoder transformer, the audio family (seamless-m4t-large-v2):
the port of ``repro.models.encdec``.

The modality frontend (mel-spectrogram + conformer feature extractor)
is a STUB, as in the reference: the batch carries precomputed frame
embeddings ``frontend`` (B, frontend_len, d_model). The encoder is a
bidirectional transformer over those frames, with RoPE, on a float32
residual stream; its self-attention is ``models.attention.
bidirectional_attention``, the flash kernel with ``causal=False`` (its
plain version on the CPU). The decoder is a causal transformer over the
text on a stream in the compute dtype, each layer attending to itself
(the flash kernel, causal, or sliding-window under ``window``), then to
the encoder's output (``models.attention.dense_attention``: queries and
keys of two lengths, plain torch ops as in the reference), then a
SwiGLU FFN; it is trained teacher-forced. Precision is the reference's:
bf16 attention products, f32 FFN and ``lm_head`` products
(``common.matmul``), f32 params.

Params keep the reference's layout: ``embed``, the ``encoder`` and
``decoder`` layers stacked on a leading dim, ``ln_enc``, ``ln_f``,
``lm_head``. With ``cfg.remat`` and grad enabled each layer runs under
``torch.utils.checkpoint``, as the reference wraps its scan bodies in
``jax.checkpoint``.

Under a model, seq, fsdp or batch axis of a rank mesh the model's
functions, :func:`encode` and :func:`decode_stack` run on this rank's
shards (``models/encdec_tp.py``).

Decode state: ``{"self": {"k", "v"} (L, B, S + CACHE_MARGIN, Hkv, hd),
"cross": {"k", "v"} (L, B, F, Hkv, hd), "pos": S - 1}``: prefill keeps
the decoder's true self-attention keys and values with
``CACHE_MARGIN`` empty slots for decode, and each layer's cross keys
and values of the encoder output. Decode writes the new token at
``pos + 1`` into the self cache in place, as the dense family's does,
and runs its rows padded to ``common.DECODE_ROWS``; prefill's
last-token logits likewise, so a request's tokens are the bits a batch
of one gives (the serving scheduler's batched == serial property).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib, common
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy
from repro_torch.models.transformer import (
    _attend,
    _init_attn,
    _out_proj,
    _project_qkv,
    _rope,
    _sharded,
)
from repro_torch.utils.trees import tree_map_with_path, tree_unstack

# decode slots appended to a prefill cache (the ring wraps beyond this)
CACHE_MARGIN = 64


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_enc_layer(gen, cfg: ModelConfig, dtype, dev) -> dict:
    return {
        "ln1": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": _init_attn(gen, cfg, dtype, dev),
        "ln2": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "ffn": common.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype, dev) -> dict:
    return {
        "ln1": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "self_attn": _init_attn(gen, cfg, dtype, dev),
        "ln_x": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "cross_attn": _init_attn(gen, cfg, dtype, dev),
        "ln2": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "ffn": common.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev),
    }


def init_encdec_params(generator: torch.Generator, cfg: ModelConfig,
                       device="cuda", cut=None) -> dict:
    """Random params in the reference's layout, drawn from ``generator``
    on its own device and placed on ``device``. ``cut(path, tensor)``,
    if given, is applied to each leaf as soon as it is drawn (a layer's
    leaves unstacked), as ``transformer.init_decoder_params`` applies
    it."""
    dtype = getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)

    def keep(prefix, tree):
        if cut is None:
            return tree
        return tree_map_with_path(lambda path, x: cut(path, x), tree,
                                  prefix=prefix)

    return {
        "embed": keep("embed/", common.init_embedding(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev)),
        "encoder": common.init_stacked(
            lambda: keep("encoder/", _init_enc_layer(generator, cfg, dtype,
                                                     dev)),
            cfg.n_encoder_layers),
        "decoder": common.init_stacked(
            lambda: keep("decoder/", _init_dec_layer(generator, cfg, dtype,
                                                     dev)),
            cfg.n_layers),
        "ln_enc": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "ln_f": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "lm_head": keep("lm_head/", common.init_unembed(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev)),
    }


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------
def _layers(stack: dict, body, x, remat: bool):
    """``x`` through ``body(layer, x)`` for each layer of ``stack``, each
    under ``torch.utils.checkpoint`` when ``remat`` and grad is on."""
    remat = remat and torch.is_grad_enabled()
    for layer in tree_unstack(stack):
        x = checkpoint(body, layer, x, use_reentrant=False) if remat \
            else body(layer, x)
    return x


def _ffn(layer: dict, x, cfg: ModelConfig):
    hn = common.rmsnorm(layer["ln2"], x, cfg.norm_eps).to(
        getattr(torch, cfg.dtype))
    return common.swiglu(layer["ffn"], hn).to(x.dtype)


def encode(params: dict, frontend, cfg: ModelConfig,
           policy: ShardingPolicy = UNSHARDED):
    """frontend (B, F, D) -> encoder output (B, F, D) float32 (the
    params' dtype): bidirectional self-attention over the frames. Under
    a sharded ``policy`` (``encdec_tp.encode``) the params are this
    rank's shards, and the output is every frame of this rank's rows."""
    if _sharded(policy):
        return encdec_tp.encode(params, frontend, cfg, policy)
    x = frontend.to(getattr(torch, cfg.param_dtype))
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device))

    def body(layer, x):
        q, k, v = _project_qkv(
            layer["attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps),
            cfg, rope)
        o = attn_lib.bidirectional_attention(q, k, v)
        x = x + _out_proj(layer["attn"], o, cfg, x)
        return x + _ffn(layer, x, cfg)

    x = _layers(params["encoder"], body, x, cfg.remat)
    return common.rmsnorm(params["ln_enc"], x, cfg.norm_eps)


def _enc_kv(layer: dict, enc_out, cfg: ModelConfig) -> dict:
    """One decoder layer's cross-attention keys and values of the
    encoder output, each (B, F, Hkv, hd) in the compute dtype."""
    dt = getattr(torch, cfg.dtype)
    b, f, _ = enc_out.shape
    e = enc_out.to(dt)
    return {n: common.matmul(e, layer["cross_attn"][w].to(dt)).reshape(
                b, f, cfg.n_kv_heads, cfg.resolved_head_dim)
            for n, w in (("k", "wk"), ("v", "wv"))}


def _cross_attention(layer_attn: dict, xc, enc_kv: dict, cfg: ModelConfig):
    """Queries of the normed stream ``xc`` (B, S, D) over the encoder's
    keys and values; the block's output in the compute dtype."""
    dt = getattr(torch, cfg.dtype)
    b, s = xc.shape[:2]
    q = common.matmul(xc.to(dt), layer_attn["wq"].to(dt)).reshape(
        b, s, cfg.n_heads, cfg.resolved_head_dim)
    o = attn_lib.dense_attention(q, enc_kv["k"], enc_kv["v"])
    return _out_proj(layer_attn, o, cfg, q)


def decode_stack(params: dict, tokens, enc_out, cfg: ModelConfig,
                 window: Optional[int], with_cache: bool = False,
                 policy: ShardingPolicy = UNSHARDED):
    """Teacher-forced decoder forward over ``tokens`` (B, S): the final
    normed stream (B, S, D). With ``with_cache`` (prefill) also the
    self-attention caches, each layer's true keys and values followed
    by ``CACHE_MARGIN`` empty slots, and each layer's cross keys and
    values: ``(x, {"k", "v"}, {"k", "v"})``, stacked on the layers.
    Under a sharded ``policy`` (``encdec_tp.decode_stack``) the params
    are this rank's shards, ``enc_out`` :func:`encode`'s output, and
    ``x`` the stream in its layout (this rank's positions under
    sequence parallelism), the caches this rank's heads."""
    if _sharded(policy):
        return encdec_tp.decode_stack(params, tokens, enc_out, cfg, window,
                                      with_cache, policy)
    dt = getattr(torch, cfg.dtype)
    x = common.embed(params["embed"], tokens).to(dt)
    b, s = tokens.shape
    rope = _rope(cfg, torch.arange(s, device=x.device))
    self_c = cross = None
    if with_cache:
        n, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        self_c = {k: torch.zeros((n, b, s + CACHE_MARGIN, hkv, hd),
                                 dtype=dt, device=x.device)
                  for k in ("k", "v")}
        cross = {k: torch.empty((n, b, enc_out.shape[1], hkv, hd), dtype=dt,
                                device=x.device) for k in ("k", "v")}

    def body(layer, x, i=None):
        h, k, v = _attend(
            layer["self_attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps),
            cfg, rope, window)
        x = x + h
        kv = _enc_kv(layer, enc_out, cfg)
        if i is not None:
            self_c["k"][i, :, :s] = k
            self_c["v"][i, :, :s] = v
            for n in ("k", "v"):
                cross[n][i] = kv[n]
        x = x + _cross_attention(
            layer["cross_attn"], common.rmsnorm(layer["ln_x"], x,
                                                cfg.norm_eps),
            kv, cfg).to(x.dtype)
        return x + _ffn(layer, x, cfg)

    if with_cache:
        for i, layer in enumerate(tree_unstack(params["decoder"])):
            x = body(layer, x, i)
    else:
        x = _layers(params["decoder"], body, x, cfg.remat)
    x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return (x, self_c, cross) if with_cache else x


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, window: Optional[int]):
    """(params, batch) -> (loss, metrics) for one client."""

    def loss_fn(params, batch):
        enc_out = encode(params, batch["frontend"], cfg)
        x = decode_stack(params, batch["tokens"], enc_out, cfg, window)
        logits = common.unembed_untied(params["lm_head"], x)
        loss = common.softmax_xent(logits, batch["labels"], cfg.vocab_size)
        return loss, {"xent": loss}

    return loss_fn


def make_prefill_fn(cfg: ModelConfig, window: Optional[int]):
    """The encoder over the frontend and the decoder over the prompt:
    the last token's logits (B, 1, V_pad) and the decode state."""

    def prefill_fn(params, batch):
        enc_out = encode(params, batch["frontend"], cfg)
        x, self_c, cross = decode_stack(params, batch["tokens"], enc_out,
                                        cfg, window, with_cache=True)
        b, s = batch["tokens"].shape
        logits = common.unembed_untied(params["lm_head"], common.pad_rows(
            x[:, -1:], common.row_bucket(b)))[:b]
        return logits, {"self": self_c, "cross": cross, "pos": s - 1}

    return prefill_fn


class DecodeOps:
    """A decode step's sublayers on the whole model, as
    :func:`decode_layers` calls them; ``encdec_tp.EncDecShards`` has the
    same methods on a rank's shards."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def gather_layer(self, layer: dict, prefix: str) -> dict:
        return layer

    def step_qkv(self, layer_attn: dict, xn, rope):
        return _project_qkv(layer_attn, xn, self.cfg, rope)

    def step_out(self, layer_attn: dict, o, x):
        return _out_proj(layer_attn, o, self.cfg, x)

    def step_cross(self, layer_attn: dict, xn, kv: dict, x):
        return _cross_attention(layer_attn, xn, kv, self.cfg).to(x.dtype)

    def step_ffn(self, layer: dict, x):
        return _ffn(layer, x, self.cfg)


def decode_layers(ops, params: dict, state: dict, x, b: int):
    """One token's pass of ``x`` (R, 1, D), its first ``b`` rows real,
    through the decoder (``ops``: :class:`DecodeOps` or a rank's
    ``EncDecShards``): the self-attention caches written at
    ``state["pos"] + 1`` in place (a state is decoded from once, as the
    dense family's), the cross keys and values read. Returns (the
    stream, the new state)."""
    cfg = ops.cfg
    rows = x.shape[0]
    self_c, cross = state["self"], state["cross"]
    pos = state["pos"] + 1   # the incoming token's position
    slot = pos % self_c["k"].shape[2]
    rope = _rope(cfg, torch.full((1,), pos, dtype=torch.int32,
                                 device=x.device))
    kv32 = {n: torch.zeros((rows,) + self_c[n].shape[2:],
                           dtype=torch.float32, device=x.device)
            for n in ("k", "v")}
    for i, layer in enumerate(tree_unstack(params["decoder"])):
        layer = ops.gather_layer(layer, "decoder/")
        q, k, v = ops.step_qkv(
            layer["self_attn"],
            common.rmsnorm(layer["ln1"], x, cfg.norm_eps), rope)
        self_c["k"][i, :, slot] = k[:b, 0]
        self_c["v"][i, :, slot] = v[:b, 0]
        for n in ("k", "v"):
            kv32[n][:b] = self_c[n][i]
        o = attn_lib.decode_attention(q, kv32, pos)
        x = x + ops.step_out(layer["self_attn"], o, x)
        enc_kv = {n: common.pad_rows(cross[n][i], rows) for n in ("k", "v")}
        x = x + ops.step_cross(
            layer["cross_attn"],
            common.rmsnorm(layer["ln_x"], x, cfg.norm_eps), enc_kv, x)
        x = x + ops.step_ffn(layer, x)
    return x, {"self": self_c, "cross": cross, "pos": pos}


def make_decode_fn(cfg: ModelConfig):
    """One token through the decoder (:func:`decode_layers`), its rows
    padded to ``common.DECODE_ROWS``."""
    dt = getattr(torch, cfg.dtype)
    ops = DecodeOps(cfg)

    def decode_fn(params, state, batch):
        b = batch["token"].shape[0]
        x = common.embed(params["embed"], common.pad_rows(
            batch["token"], common.row_bucket(b))).to(dt)      # (R, 1, D)
        x, state = decode_layers(ops, params, state, x, b)
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = common.unembed_untied(params["lm_head"], x)[:b]
        return logits, state

    return decode_fn


def make_init_decode_state(cfg: ModelConfig):
    def init_state(batch_size: int, cache_len: int, device="cuda"):
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        tail = (cfg.n_kv_heads, cfg.resolved_head_dim)
        self_shape = (cfg.n_layers, batch_size, cache_len) + tail
        cross_shape = (cfg.n_layers, batch_size, cfg.frontend_len) + tail
        return {"self": {k: torch.zeros(self_shape, dtype=dt, device=dev)
                         for k in ("k", "v")},
                "cross": {k: torch.zeros(cross_shape, dtype=dt, device=dev)
                          for k in ("k", "v")},
                "pos": cache_len - 1}
    return init_state


def build_encdec_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
                       window: Optional[int] = None) -> Model:
    """The encoder-decoder; ``window`` bounds the decoder's prefill
    self-attention; ``policy`` gives the spec rules. Under a model, seq,
    fsdp or batch axis its functions run on this rank's shards
    (``encdec_tp``)."""
    model = Model(
        config=cfg,
        init=lambda generator, device="cuda": init_encdec_params(
            generator, cfg, device),
        loss_fn=per_client_loss(make_loss_fn(cfg, window)),
        prefill_fn=make_prefill_fn(cfg, window),
        decode_fn=make_decode_fn(cfg),
        init_decode_state=make_init_decode_state(cfg),
        policy=policy,
        spec_rule=make_spec_rule(cfg, policy),
        state_spec_rule=make_state_spec_rule(cfg, policy),
    )
    if not _sharded(policy):
        return model
    return encdec_tp.sharded_model(model, cfg, policy, window)


def make_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """The reference's param rule: embedding and head over the vocab,
    q/k/v column-split and ``wo`` row-split where the heads divide,
    the FFN column- then row-split, fsdp on the other dim."""
    def rule(path: str, shape):
        if policy.mesh is None:
            return P()
        m = policy.model_axis
        f = policy.fsdp_axes
        f = f[0] if f and len(f) == 1 else f
        mh = m if cfg.n_heads % max(policy.model_size, 1) == 0 else None
        lead = (None,) if path.startswith(("encoder/", "decoder/")) else ()
        if path.endswith("embed/table"):
            return P(m, None)
        if path.endswith("lm_head/proj"):
            return P(None, m)
        if path.endswith(("wq", "wk", "wv")):
            return P(*lead, f, mh)
        if path.endswith("wo"):
            return P(*lead, mh, f)
        if path.endswith(("w_gate", "w_up")):
            return P(*lead, f, m)
        if path.endswith("w_down"):
            return P(*lead, m, f)
        return P(*([None] * len(shape)))

    return rule


def make_state_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """The reference's decode-state rule: the self and cross caches
    (L, B, T, Hkv, hd) over the batch axes and, where they divide, the
    kv heads."""
    def rule(path: str, shape):
        if policy.mesh is None:
            return P()
        if path.endswith(("/k", "/v")) and len(shape) == 5:
            return P(None, policy.dim("batch", shape[1]), None,
                     policy.dim("model", shape[3]), None)
        return P(*([None] * len(shape)))

    return rule


# the sharded model builds on the names above
from repro_torch.models import encdec_tp  # noqa: E402
