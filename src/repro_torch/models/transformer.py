"""Decoder-only transformer, the dense family (stablelm-1.6b, stablelm-3b,
granite-8b, minitron-8b), the moe family (granite-moe-1b-a400m,
qwen3-moe-235b-a22b) and the vlm family (llava-next-mistral-7b): the
port of ``repro.models.transformer``.

Each block is pre-norm: RMSNorm, self-attention with RoPE and GQA
(``n_kv_heads`` kv heads shared by groups of query heads), a residual
add, RMSNorm, a SwiGLU FFN (the moe family: ``models.moe.moe_ffn``), a
residual add. The residual stream runs in ``cfg.dtype``; the attention
products run in that dtype, and the FFN, expert and ``lm_head``
products in the promoted dtype of activations and float32 params
(float32), as the reference's ``jnp.einsum`` promotes. Every dense
product goes through ``common.matmul``, which multiplies a prompt one
sequence at a time so a sequence's bits do not depend on its wave.

The moe family carries the reference's ``aux`` from a float32 zero
through the layers: each layer adds its Switch loss, and the training
loss adds ``router_aux_weight * aux / n_layers`` (``metrics["moe_aux"]``).
Prefill and the loss mask the prompt's pads out of routing; decode
routes only its real rows (T = B, as in the reference). Expert capacity
spans the whole batch, so a moe request's tokens depend on its wave
(``models/moe.py``).

Params keep the reference's layout: the layers stacked on a leading
``n_layers`` dim under ``"layers"``, so a reference tree crosses over
unchanged (``core.state.params_from_numpy``). The reference's
``lax.scan`` over them is a Python loop over one ``unbind`` of the
stack; with ``cfg.remat`` the training forward runs each layer under
``torch.utils.checkpoint``, as the reference wraps its scan body in
``jax.checkpoint``.

Prefill attention goes through ``models.attention`` (the flash kernel
on the card, its plain version on the CPU): causal, or sliding-window
when ``window`` is shorter than the (padded) prompt. Decode writes the
new token's keys and values at ``state["pos"] + 1`` into a ring cache,
in place, and attends to every written slot, as the reference's does
(its decode applies no window). Prefill pads the prompt as the
reference does (:func:`_pad_len`), keeps the pads' keys and values in
the cache, adds ``PREFILL_CACHE_MARGIN`` empty slots for decode, and
sets ``pos`` to the last real token's position, so the cache shapes and
``pos`` are the reference's. Decode runs its rows padded to
``common.DECODE_ROWS`` (the caches keep B rows; attention reads each
layer's padded to the step's rows) and prefill's last-token logits
likewise, so a dense request's tokens are the bits a batch of one gives
(the serving scheduler's batched == serial property).

The vlm family (llava-next-mistral-7b) is this decoder with a stub
vision frontend: the batch's ``frontend`` embeddings go before the
text (:func:`embed_inputs`), the loss reads the text positions only,
and prefill's ``pos`` and last-token logits count the prefix, so decode
continues after it.

Every model function takes the reference's ``policy`` in the
reference's place. :func:`make_spec_rule` and
:func:`make_state_spec_rule` are the reference's rules. Under a policy
with a model axis on a rank mesh (``sharding.make_policy``) the dense
and vlm decoders run tensor-parallel, with sequence parallelism when
``seq_axis`` is set: ``models/transformer_tp.py``, on each rank's shards
of the params and of the KV cache.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib, common
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.moe import init_moe, moe_ffn, moe_spec
from repro_torch.models.sharding import UNSHARDED, P, ShardingPolicy
from repro_torch.utils.trees import tree_map_with_path, tree_unstack

# decode slots appended to a prefill cache (the ring wraps beyond this)
PREFILL_CACHE_MARGIN = 64


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_attn(gen, cfg: ModelConfig, dtype, dev) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "wq": common.dense_init(gen, (d, cfg.n_heads * hd), dtype).to(dev),
        "wk": common.dense_init(gen, (d, cfg.n_kv_heads * hd), dtype).to(dev),
        "wv": common.dense_init(gen, (d, cfg.n_kv_heads * hd), dtype).to(dev),
        "wo": common.dense_init(gen, (cfg.n_heads * hd, d), dtype).to(dev),
    }


def _init_layer(gen, cfg: ModelConfig, dtype, dev) -> dict:
    layer = {
        "ln1": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "ln2": common.init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": _init_attn(gen, cfg, dtype, dev),
    }
    if cfg.moe is not None:
        layer["moe"] = init_moe(gen, cfg.d_model, cfg.moe, dtype, dev)
    else:
        layer["ffn"] = common.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype,
                                          dev)
    return layer


def init_decoder_params(generator: torch.Generator, cfg: ModelConfig,
                        device="cuda", cut=None) -> dict:
    """Random params in the reference's layout, drawn from ``generator``
    on its own device and placed on ``device``. ``cut(path, tensor)``,
    if given, is applied to each leaf as soon as it is drawn (a layer's
    leaves unstacked, under their ``layers/...`` paths): a rank keeps its
    shard of the one seeded init, never holding more than one layer
    whole."""
    dtype = getattr(torch, cfg.param_dtype)
    dev = resolve_device(device)

    def keep(prefix, tree):
        if cut is None:
            return tree
        return tree_map_with_path(lambda path, x: cut(path, x), tree,
                                  prefix=prefix)

    params = {
        "embed": keep("embed/", common.init_embedding(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev)),
        "layers": common.init_stacked(
            lambda: keep("layers/", _init_layer(generator, cfg, dtype, dev)),
            cfg.n_layers),
        "ln_f": common.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep("lm_head/", common.init_unembed(
            generator, cfg.padded_vocab, cfg.d_model, dtype, dev))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _rope(cfg: ModelConfig, positions):
    """RoPE's tables at ``positions``, shared by every layer."""
    return common.rope_tables(positions, cfg.resolved_head_dim,
                              cfg.rope_theta, positions.device)


def _project_qkv(layer_attn: dict, xn, cfg: ModelConfig, rope):
    """Rotated q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) of the normed
    stream ``xn``, in the compute dtype; ``rope`` from :func:`_rope`."""
    b, s = xn.shape[:2]
    hd = cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    xc = xn.to(dt)
    q = common.matmul(xc, layer_attn["wq"].to(dt)).reshape(
        b, s, cfg.n_heads, hd)
    k = common.matmul(xc, layer_attn["wk"].to(dt)).reshape(
        b, s, cfg.n_kv_heads, hd)
    v = common.matmul(xc, layer_attn["wv"].to(dt)).reshape(
        b, s, cfg.n_kv_heads, hd)
    return common.rotate(q, rope), common.rotate(k, rope), v


def _out_proj(layer_attn: dict, o, cfg: ModelConfig, like):
    b, s = o.shape[:2]
    dt = getattr(torch, cfg.dtype)
    o = o.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return common.matmul(o, layer_attn["wo"].to(dt)).to(like.dtype)


def _attend(layer_attn: dict, x, cfg: ModelConfig, rope,
            window: Optional[int]):
    """Self-attention over the full (already-embedded, normed) sequence;
    returns the block's output and its rotated keys and values."""
    s = x.shape[1]
    q, k, v = _project_qkv(layer_attn, x, cfg, rope)
    if window is not None and window < s:
        o = attn_lib.windowed_attention(q, k, v, window=window)
    else:
        o = attn_lib.causal_attention(q, k, v)
    return _out_proj(layer_attn, o, cfg, x), k, v


def attention_block(layer_attn: dict, x, cfg: ModelConfig,
                    policy: ShardingPolicy, positions,
                    window: Optional[int]):
    """Self-attention of the normed stream ``x`` at ``positions`` (S,):
    the block's output, in ``x``'s dtype (under a model axis, this
    rank's part of it in the stream's layout)."""
    if _sharded(policy):
        return transformer_tp.attention_block(
            layer_attn, x, cfg, policy, positions, window)
    return _attend(layer_attn, x, cfg, _rope(cfg, positions), window)[0]


def _ffn(layer: dict, x, cfg: ModelConfig, mask=None):
    """The layer's FFN on the normed stream: (out, the layer's moe aux
    loss, None for the dense family); ``mask`` (S,) marks the real
    positions routing sees."""
    hn = common.rmsnorm(layer["ln2"], x, cfg.norm_eps).to(
        getattr(torch, cfg.dtype))
    if cfg.moe is not None:
        return moe_ffn(layer["moe"], hn, cfg.moe, mask=mask)
    return common.swiglu(layer["ffn"], hn), None


def _real_mask(s: int, n_real: int, device):
    """The (S,) mask of the first ``n_real`` positions (None: all real)."""
    if n_real >= s:
        return None
    return torch.arange(s, device=device) < n_real


def _block(layer: dict, x, cfg: ModelConfig, rope, window: Optional[int],
           mask=None):
    """One layer over the residual stream ``x``; returns the new stream,
    the layer's keys and values (the cache prefill keeps) and its moe
    aux loss (None for the dense family)."""
    h, k, v = _attend(
        layer["attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps), cfg,
        rope, window)
    x = x + h
    f, aux = _ffn(layer, x, cfg, mask)
    return x + f.to(x.dtype), k, v, aux


def make_block_fn(cfg: ModelConfig, policy: ShardingPolicy,
                  window: Optional[int], n_real: Optional[int] = None):
    """``block((x, aux), layer) -> ((x, aux), None)``, the reference's
    scan body: one layer over the stream ``x`` (B, S, D), its moe aux
    loss added to ``aux``; positions past ``n_real`` are pads, masked
    out of routing. Under a model axis see ``transformer_tp``."""
    if _sharded(policy):
        return transformer_tp.make_block_fn(cfg, policy, window, n_real)

    def block(carry, layer):
        x, aux = carry
        s = x.shape[1]
        rope = _rope(cfg, torch.arange(s, device=x.device))
        mask = _real_mask(s, s if n_real is None else n_real, x.device)
        x, _, _, aux_l = _block(layer, x, cfg, rope, window, mask)
        return (x, aux if aux_l is None else aux + aux_l), None

    return block


def _sharded(policy: ShardingPolicy) -> bool:
    """Whether ``policy`` runs the decoder on per-rank shards (a model,
    seq or fsdp axis)."""
    return policy.mesh is not None and not policy.replicas_only


def decoder_forward(params: dict, embeds, cfg: ModelConfig,
                    policy: ShardingPolicy, window: Optional[int],
                    n_real: Optional[int] = None):
    """The layer stack over input embeddings, then the final norm.
    Returns (x, aux): aux sums the layers' moe losses from a float32 zero
    (it stays 0 for the dense family); the positions past ``n_real`` are
    pads, masked out of routing."""
    if _sharded(policy):
        return transformer_tp.decoder_forward(params, embeds, cfg, policy,
                                              window, n_real)
    s = embeds.shape[1]
    rope = _rope(cfg, torch.arange(s, device=embeds.device))
    mask = _real_mask(s, s if n_real is None else n_real, embeds.device)

    def body(layer, x):
        x, _, _, aux = _block(layer, x, cfg, rope, window, mask)
        return x if aux is None else (x, aux)

    x = embeds
    aux = torch.zeros((), dtype=torch.float32, device=embeds.device)
    for layer in tree_unstack(params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(body, layer, x, use_reentrant=False)
        else:
            out = body(layer, x)
        if cfg.moe is not None:
            x, aux_l = out
            aux = aux + aux_l
        else:
            x = out
    return common.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def logits_fn(params: dict, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return common.unembed(params["embed"], x)
    return common.unembed_untied(params["lm_head"], x)


def _pad_len(n: int) -> int:
    """The reference's padded prompt length: a multiple of 256 from 256
    tokens (its exact-FLOP causal halving), else the next even length."""
    if n >= 256:
        return ((n + 255) // 256) * 256
    return n + (n % 2)


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token embedding, after the vlm family's stub frontend (the batch's
    ``frontend`` (B, P, D), cast to the embedding's dtype and put before
    the tokens), zero-padded to :func:`_pad_len` of the whole, in the
    compute dtype. Returns (embeds, n_prefix, n_pad): positions
    [n_prefix, n_prefix + S_text) carry the text (n_prefix is P for the
    vlm family, else 0)."""
    x = common.embed(params["embed"], batch["tokens"])
    n_prefix = 0
    if cfg.family == "vlm":
        front = batch["frontend"].to(x.dtype)
        x = torch.cat([front, x], dim=1)
        n_prefix = front.shape[1]
    n_pad = _pad_len(x.shape[1]) - x.shape[1]
    if n_pad:
        x = F.pad(x, (0, 0, 0, n_pad))
    return x.to(getattr(torch, cfg.dtype)), n_prefix, n_pad


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, policy: ShardingPolicy,
                 window: Optional[int]):
    """(params, batch) -> (loss, metrics) for one client."""
    if _sharded(policy):
        return transformer_tp.make_loss_fn(cfg, policy, window)

    def loss_fn(params, batch):
        x, n_prefix, n_pad = embed_inputs(params, batch, cfg)
        x, aux = decoder_forward(params, x, cfg, policy, window,
                                 n_real=x.shape[1] - n_pad)
        s_text = batch["tokens"].shape[1]
        logits = logits_fn(params, x[:, n_prefix:n_prefix + s_text], cfg)
        loss = common.softmax_xent(logits, batch["labels"], cfg.vocab_size)
        metrics = {"xent": loss}
        if cfg.moe is not None:
            aux = aux / cfg.n_layers
            metrics["moe_aux"] = aux
            loss = loss + cfg.moe.router_aux_weight * aux
        return loss, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
def make_decode_fn(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED):
    """One token through the stack with per-layer KV caches.

    state = {"cache": {"k", "v": (L, B, T, Hkv, hd)}, "pos": int}, pos
    the last written token's position; batch = {"token": (B, 1) int32}.
    The token's keys and values are written into the given state's
    caches in place, and the returned state holds those caches with
    ``pos`` advanced: a state is decoded from once (the serving
    scheduler's use), not kept to decode from again. The moe family
    routes the B real rows only (T = B, as the reference's decode): the
    pad rows take no expert's capacity and get a zero FFN output.
    """
    if _sharded(policy):
        return transformer_tp.make_decode_fn(cfg, policy)
    dt = getattr(torch, cfg.dtype)

    def decode_fn(params, state, batch):
        b = batch["token"].shape[0]
        rows = common.row_bucket(b)
        cache = state["cache"]
        pos = state["pos"] + 1   # the incoming token's position
        slot = pos % cache["k"].shape[2]
        x = common.embed(params["embed"], common.pad_rows(
            batch["token"], rows)).to(dt)                     # (R, 1, D)
        rope = _rope(cfg, torch.full((1,), pos, dtype=torch.int32,
                                     device=x.device))
        # attention's float32 operands at the step's rows, one layer's
        # cache at a time (the rows past b stay zero)
        kv32 = {n: torch.zeros((rows,) + cache[n].shape[2:],
                               dtype=torch.float32, device=x.device)
                for n in ("k", "v")}
        for i, layer in enumerate(tree_unstack(params["layers"])):
            q, k, v = _project_qkv(
                layer["attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps),
                cfg, rope)
            cache["k"][i, :, slot] = k[:b, 0]
            cache["v"][i, :, slot] = v[:b, 0]
            for n in ("k", "v"):
                kv32[n][:b] = cache[n][i]
            o = attn_lib.decode_attention(q, kv32, pos)
            x = x + _out_proj(layer["attn"], o, cfg, x)
            if cfg.moe is not None:
                f, _ = _ffn(layer, x[:b], cfg)
                f = common.pad_rows(f, rows)
            else:
                f, _ = _ffn(layer, x, cfg)
            x = x + f.to(x.dtype)
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits_fn(params, x, cfg)[:b], {"cache": cache, "pos": pos}

    return decode_fn


def make_init_decode_state(cfg: ModelConfig):
    def init_state(batch_size: int, cache_len: int, device="cuda"):
        shape = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        return {"cache": {k: torch.zeros(shape, dtype=dt, device=dev)
                          for k in ("k", "v")},
                "pos": cache_len - 1}
    return init_state


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def make_prefill_fn(cfg: ModelConfig, policy: ShardingPolicy,
                    window: Optional[int]):
    """The full-prompt forward that also fills the KV cache: returns the
    last real token's logits (B, 1, V_pad) and the decode state. The
    prompt's pads are masked out of moe routing."""
    if _sharded(policy):
        return transformer_tp.make_prefill_fn(cfg, policy, window)

    def prefill_fn(params, batch):
        x, _, n_pad = embed_inputs(params, batch, cfg)
        b, s = x.shape[:2]
        mask = _real_mask(s, s - n_pad, x.device)
        shape = (cfg.n_layers, b, s + PREFILL_CACHE_MARGIN, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache = {k: torch.zeros(shape, dtype=x.dtype, device=x.device)
                 for k in ("k", "v")}
        rope = _rope(cfg, torch.arange(s, device=x.device))
        for i, layer in enumerate(tree_unstack(params["layers"])):
            x, k, v, _ = _block(layer, x, cfg, rope, window, mask)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        last = x[:, s - n_pad - 1:s - n_pad]
        logits = logits_fn(params, common.pad_rows(
            last, common.row_bucket(b)), cfg)[:b]
        return logits, {"cache": cache, "pos": s - n_pad - 1}

    return prefill_fn


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
def make_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """(path, global shape) -> PartitionSpec of a param leaf: the
    embedding split over the vocab, ``lm_head`` over its columns, q and
    (when its kv heads divide) k and v column-split by heads, ``wo`` and
    ``w_down`` row-split, ``w_gate`` and ``w_up`` column-split, the
    experts by ``moe_spec``, fsdp on the other dim; the rest replicated."""
    m_ok_q = cfg.n_heads % max(policy.model_size, 1) == 0
    m_ok_kv = cfg.n_kv_heads % max(policy.model_size, 1) == 0
    m = policy.model_axis
    f = policy.fsdp_axes
    f = f[0] if f and len(f) == 1 else f

    def rule(path: str, shape) -> P:
        if policy.mesh is None:
            return P()
        stacked = path.startswith(("layers/", "triples/", "tail/"))
        lead = (None,) if stacked else ()
        if cfg.moe is not None:
            ms = moe_spec(path, shape, policy, stacked=stacked)
            if ms is not None:
                return ms
        if path.endswith("embed/table"):
            return P(m, f)
        if path.endswith("lm_head/proj"):
            return P(f, m)
        if path.endswith("attn/wq"):
            return P(*lead, f, m if m_ok_q else None)
        if path.endswith(("attn/wk", "attn/wv")):
            return P(*lead, f, m if m_ok_kv else None)
        if path.endswith("attn/wo"):
            return P(*lead, m if m_ok_q else None, f)
        if path.endswith(("ffn/w_gate", "ffn/w_up")):
            return P(*lead, f, m)
        if path.endswith("ffn/w_down"):
            return P(*lead, m, f)
        return P(*([None] * len(shape)))     # norms and the small

    return rule


def make_state_spec_rule(cfg: ModelConfig, policy: ShardingPolicy):
    """(path, global shape) -> PartitionSpec of a decode-state leaf: the
    KV cache (L, B, T, Hkv, hd) with the batch over the batch axes and
    the model axis on the kv heads when they divide, else on the cache
    length T (decode combines the shards' softmax terms, the flash-
    decode schedule), else on hd; the rest replicated."""
    m_ok_kv = cfg.n_kv_heads % max(policy.model_size, 1) == 0
    m_ok_hd = cfg.resolved_head_dim % max(policy.model_size, 1) == 0
    m = policy.model_axis

    def rule(path: str, shape) -> P:
        if policy.mesh is None:
            return P()
        if path.endswith(("/k", "/v")) and len(shape) == 5:
            batch = policy.dim("batch", shape[1])
            if m_ok_kv:
                return P(None, batch, None, m, None)
            if m is not None and shape[2] % max(policy.model_size, 1) == 0:
                return P(None, batch, m, None, None)
            if m_ok_hd:
                return P(None, batch, None, None, m)
            return P(None, batch, None, None, None)
        return P(*([None] * len(shape)))

    return rule


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------
def build_decoder_model(cfg: ModelConfig, policy: ShardingPolicy = UNSHARDED,
                        window: Optional[int] = None) -> Model:
    """The dense, moe or vlm decoder; ``window`` (else ``cfg.sliding_window``)
    bounds prefill attention. Under a model axis (the dense and vlm
    families, see :func:`repro_torch.models.get_model`) its functions
    run on this rank's shards (``transformer_tp``)."""
    window = window if window is not None else cfg.sliding_window
    model = Model(
        config=cfg,
        init=lambda generator, device="cuda": init_decoder_params(
            generator, cfg, device),
        loss_fn=per_client_loss(make_loss_fn(cfg, UNSHARDED, window)),
        prefill_fn=make_prefill_fn(cfg, UNSHARDED, window),
        decode_fn=make_decode_fn(cfg, UNSHARDED),
        init_decode_state=make_init_decode_state(cfg),
        policy=policy,
        spec_rule=make_spec_rule(cfg, policy),
        state_spec_rule=make_state_spec_rule(cfg, policy),
    )
    if not _sharded(policy):
        return model
    return transformer_tp.sharded_model(model, cfg, policy, window)


# the sharded decoder builds on the names above
from repro_torch.models import transformer_tp  # noqa: E402
