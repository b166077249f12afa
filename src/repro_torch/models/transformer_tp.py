"""The dense and vlm decoders over a model axis: tensor parallelism
(Megatron-LM's column- and row-parallel products) and, with the
policy's ``seq_axis``, sequence parallelism, on each rank's shards.

The port of the reference's sharded decoder, which GSPMD partitions by
``make_spec_rule``, ``make_state_spec_rule`` and the ``shard_hint``
calls of ``repro.models.transformer``. Here each rank holds its shards
(``Model.param_pspecs``) and places the collectives itself, through the
autograd pairs of :mod:`repro_torch.models.tensor_parallel`:

* **Embedding** (table split over the vocab): a rank looks up the ids
  in its rows, zero elsewhere, and the ranks sum (exact: one nonzero a
  position). The vlm frontend goes before the text after the sum.
* **Attention**: q, k and v column-split by heads, ``wo`` row-split.
  When ``n_kv_heads`` does not divide, ``wk`` and ``wv`` are replicated
  and a rank projects the kv heads its q heads read (GQA), the weights'
  gradients summed over the ranks. Each rank runs the flash kernel on
  its own heads. When ``n_heads`` does not divide, attention is
  replicated, as the reference's rule leaves it.
* **FFN**: ``w_gate`` and ``w_up`` column-split, ``w_down`` row-split.
* Each row-parallel product's partial sums are summed over the ranks in
  float32 (the FFN's are float32 anyway; attention's bf16 partials are
  widened, so only the sum is rounded to bf16).
* **Sequence parallelism**: between blocks the residual stream and both
  norms hold S / M positions; one all-gather at each matmul entry, one
  reduce-scatter at each residual add (the reference's ``force=True``
  hints and its ``("batch", "seq", None)`` ones). It applies where S
  divides by the axis; decode's S of 1 never splits. The norms' scales
  then see only their rank's positions, so their gradients are summed
  over the ranks (the replicated-parameter trap of sequence
  parallelism).
* **Head and loss** (``lm_head`` split over its columns, or the tied
  table's rows): the cross-entropy over the vocab is a distributed
  log-sum-exp (the ranks' max, then sums of the exponentials and of the
  target logit), the padded vocab masked by global index. Prefill and
  decode gather the last token's logits to every rank.
* **KV cache** (``make_state_spec_rule``): split over the kv heads when
  they divide, and decode attends on the rank's own heads. Else over
  the cache length: q, k and v are replicated, the new token is written
  by the rank that owns its ring slot, and decode combines the ranks'
  max, sums and weighted values (the flash-decode schedule); else over
  hd (the ranks' partial scores summed, the output gathered); else
  replicated.

* **Batch axes** (the policy's ``batch_axes``, a ``(data, model)`` or
  ``(pod, data, model)`` mesh): the functions take the global batch and
  each rank keeps its rows, split row-major over the batch axes as the
  reference's ``_batch_specs`` lays them out (tokens, labels, the vlm
  frontend); where the batch does not divide, every rank keeps it
  whole (``dim("batch", size)``). The loss is the global batch's mean:
  each rank's share (its rows' mean over the ranks' count) summed over
  the batch axes, whose backward hands each rank its own share, so a
  leaf's gradient sums over the batch ranks exactly once. Prefill and
  decode gather the logits' rows to every rank; the KV cache keeps the
  rank's rows (``make_state_spec_rule``).
* **fsdp** (``fsdp_axes``, ZeRO): a leaf whose spec splits a dim over
  the fsdp axes (the embedding ``P(m, f)``, ``lm_head`` ``P(f, m)`` and
  every layer weight) is all-gathered over them where it is read, the
  last axis first (``gather_params``' order), a layer's inside its
  ``checkpoint`` body so that remat gathers it again and no gathered
  layer outlives its use; the gather's backward reduce-scatters the
  float32 gradient, the first axis first. A leaf replicated over batch
  axes (the norms; every leaf without fsdp) has its gradient summed
  over them (``copy`` of the whole stacked leaf at the top of the loss,
  one all-reduce a leaf). Decode runs with fsdp on or off.

Runs the dense and vlm families; the pieces every family shares
(batch rows, fsdp gathers, the vocab split, the stream's entry and
exit) are ``tensor_parallel.RankShards``'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib, common
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.models.tensor_parallel import RankShards, lazy, local_shape, local_slice
from repro_torch.models.transformer import (
    PREFILL_CACHE_MARGIN,
    _pad_len,
    _rope,
    init_decoder_params,
    make_spec_rule,
    make_state_spec_rule,
)
from repro_torch.utils.trees import tree_unstack


class DecoderShards(RankShards):
    """The decoder ``cfg`` on this rank of ``policy``'s mesh: its heads,
    its vocab rows, its batch rows, its fsdp shards and the layout of
    its cache."""

    STACKED = ("layers/",)

    def __init__(self, cfg: ModelConfig, policy: ShardingPolicy):
        super().__init__(cfg, policy, make_spec_rule(cfg, policy),
                         init_decoder_params(None, cfg, "meta"))
        tp = self.tp
        m = tp.size
        self.require(("d_ff", cfg.d_ff))
        self.state_rule = make_state_spec_rule(cfg, policy)
        self.heads_split = cfg.n_heads % m == 0
        self.kv_split = cfg.n_kv_heads % m == 0
        self.hq = cfg.n_heads // m if self.heads_split else cfg.n_heads
        self.q_lo = tp.index * self.hq if self.heads_split else 0
        group = cfg.n_heads // cfg.n_kv_heads
        kv_of_q = [h // group for h in range(self.q_lo, self.q_lo + self.hq)]
        uniq = sorted(set(kv_of_q))
        reps = self.hq // len(uniq)
        if self.hq % len(uniq) == 0 and kv_of_q == [
                u for u in uniq for _ in range(reps)]:
            self.kv_sel = uniq         # GQA groups intact
        else:
            self.kv_sel = kv_of_q      # a kv head per q head

    # ---- layouts ------------------------------------------------------
    def cache_spec(self, cache_len: int):
        """The spec of a (L, B, T, Hkv, hd) cache of this rank's rows
        (its batch dim not split again)."""
        cfg = self.cfg
        return self.state_rule("cache/k", (cfg.n_layers, 1, cache_len,
                                           cfg.n_kv_heads,
                                           cfg.resolved_head_dim))

    def cache_layout(self, local) -> tuple:
        """(mode, global length T) of a cache whose local shape is
        ``local`` (L, B, T_l, Hkv_l, hd_l). Ambiguous only where hd does
        not divide and neither does T_l: there a length-split cache and
        a replicated one look alike, and this raises."""
        m, hd, t_l = self.tp.size, self.cfg.resolved_head_dim, local[2]
        if self.kv_split:
            return "heads", t_l
        if local[4] < hd:
            return "hd", t_l
        if hd % m and t_l % m:
            raise ValueError(f"a cache of local length {t_l} with hd {hd} "
                             f"on a model axis of {m} is either split over "
                             f"its length or replicated")
        return "length", t_l * m

    # ---- embedding ------------------------------------------------------
    def embed_inputs(self, params: dict, batch: dict):
        """``transformer.embed_inputs`` with the split table: (embeds
        (B, S, D) on every rank, n_prefix, n_pad)."""
        x = self.embed(params, batch["tokens"])
        n_prefix = 0
        if self.cfg.family == "vlm":
            front = batch["frontend"].to(x.dtype)
            x = torch.cat([front, x], dim=1)
            n_prefix = front.shape[1]
        n_pad = _pad_len(x.shape[1]) - x.shape[1]
        if n_pad:
            x = F.pad(x, (0, 0, 0, n_pad))
        return x.to(self.dt), n_prefix, n_pad

    # ---- one layer --------------------------------------------------------
    def qkv(self, layer_attn: dict, xc, rope):
        """This rank's rotated q (B, S, hq, hd) and the k, v its heads
        read, and the rotated k, v of every kv head where ``wk`` and
        ``wv`` are replicated (else None): (q, k, v, k_all, v_all)."""
        cfg, dt = self.cfg, self.dt
        b, s = xc.shape[:2]
        hd = cfg.resolved_head_dim
        q = common.matmul(xc, layer_attn["wq"].to(dt)).reshape(
            b, s, self.hq, hd)
        q = common.rotate(q, rope)
        if self.kv_split:
            hkv = cfg.n_kv_heads // self.tp.size
            k, v = (common.matmul(xc, layer_attn[w].to(dt)).reshape(
                b, s, hkv, hd) for w in ("wk", "wv"))
            return q, common.rotate(k, rope), v, None, None
        wk, wv = layer_attn["wk"], layer_attn["wv"]
        if self.heads_split and torch.is_grad_enabled() and wk.requires_grad:
            wk, wv = self.tp.copy(wk), self.tp.copy(wv)
        k_all, v_all = (common.matmul(xc, w.to(dt)).reshape(
            b, s, cfg.n_kv_heads, hd) for w in (wk, wv))
        k_all = common.rotate(k_all, rope)
        sel = torch.tensor(self.kv_sel, device=xc.device)
        return (q, k_all.index_select(2, sel), v_all.index_select(2, sel),
                k_all, v_all)

    def attention(self, layer_attn: dict, xn, rope, window, seq_on: bool):
        """The attention block on the normed stream ``xn`` (this rank's
        positions under ``seq_on``): (its output in the stream's layout,
        q, k, v, k_all, v_all as :meth:`qkv`)."""
        dt = self.dt
        if self.heads_split:
            xc = self.enter(xn, seq_on).to(dt)
        else:      # replicated attention: the stream gathered, not summed
            xc = (self.tp.gather_rep(xn) if seq_on else xn).to(dt)
        s = xc.shape[1]
        q, k, v, k_all, v_all = self.qkv(layer_attn, xc, rope)
        if window is not None and window < s:
            o = attn_lib.windowed_attention(q, k, v, window=window)
        else:
            o = attn_lib.causal_attention(q, k, v)
        partial = common.matmul(o.reshape(o.shape[0], s, -1),
                                layer_attn["wo"].to(dt))
        if self.heads_split:
            h = self.leave(partial, seq_on, xn.dtype)
        else:
            h = partial.to(xn.dtype)
            h = self.tp.split_seq(h) if seq_on else h
        return h, q, k, v, k_all, v_all

    def ffn(self, layer: dict, x, seq_on: bool):
        hn = self.norm(layer["ln2"], x, seq_on).to(self.dt)
        h = self.enter(hn, seq_on)
        p = layer["ffn"]
        gate = F.silu(common.matmul(h, p["w_gate"]))
        partial = common.matmul(gate * common.matmul(h, p["w_up"]),
                                p["w_down"])
        return self.leave(partial, seq_on, x.dtype)

    def block(self, layer: dict, x, rope, window, seq_on: bool):
        """One layer over the stream ``x`` (this rank's positions under
        ``seq_on``); (the new stream, the attention's k, v, k_all,
        v_all)."""
        xn = self.norm(layer["ln1"], x, seq_on)
        h, _, k, v, k_all, v_all = self.attention(layer["attn"], xn, rope,
                                                  window, seq_on)
        x = x + h
        return x + self.ffn(layer, x, seq_on), k, v, k_all, v_all

    def stack(self, params: dict, embeds, window):
        """The layers over the full ``embeds`` (split along S first under
        sequence parallelism), then the final norm: (x in the stream's
        layout, seq_on)."""
        s = embeds.shape[1]
        seq_on = self.tp.seq_on(s)
        rope = _rope(self.cfg, torch.arange(s, device=embeds.device))
        x = self.tp.split_seq(embeds) if seq_on else embeds

        def body(layer, x):
            return self.block(self.gather_layer(layer), x, rope, window,
                              seq_on)[0]

        for layer in tree_unstack(params["layers"]):
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(body, layer, x, use_reentrant=False)
            else:
                x = body(layer, x)
        return self.norm(params["ln_f"], x, seq_on), seq_on


# ---------------------------------------------------------------------------
# the reference-shaped functions
# ---------------------------------------------------------------------------
def _shards(cfg: ModelConfig, policy: ShardingPolicy):
    """A getter of the :class:`DecoderShards`, built at its first call."""
    return lazy(lambda: DecoderShards(cfg, policy))


def attention_block(layer_attn: dict, x, cfg: ModelConfig,
                    policy: ShardingPolicy, positions, window):
    """The attention block on this rank: ``x`` the normed stream in its
    layout (S / M positions under sequence parallelism), ``positions``
    the global (S,)."""
    sh = DecoderShards(cfg, policy)
    s = positions.shape[0]
    layer_attn = sh.gather_layer({"attn": layer_attn})["attn"]
    return sh.attention(layer_attn, x, _rope(cfg, positions), window,
                        sh.tp.seq_on(s))[0]


def make_block_fn(cfg: ModelConfig, policy: ShardingPolicy,
                  window: Optional[int], n_real: Optional[int] = None):
    """``block((x, aux), layer, seq_len=None) -> ((x, aux), None)`` on
    this rank; ``seq_len`` is the global length when ``x`` holds this
    rank's S / M positions (default: ``x`` holds them all). The dense
    and vlm families carry no aux loss, so ``n_real`` masks nothing."""
    shards = _shards(cfg, policy)

    def block(carry, layer, seq_len: Optional[int] = None):
        sh = shards()
        x, aux = carry
        s = x.shape[1] if seq_len is None else seq_len
        seq_on = seq_len is not None and sh.tp.seq_on(s)
        rope = _rope(cfg, torch.arange(s, device=x.device))
        return (sh.block(sh.gather_layer(layer), x, rope, window,
                         seq_on)[0], aux), None

    return block


def decoder_forward(params: dict, embeds, cfg: ModelConfig,
                    policy: ShardingPolicy, window, n_real=None):
    """The stack and the final norm over the full ``embeds`` (this rank's
    rows): (x, aux), ``x`` in the stream's layout (this rank's S / M
    positions under sequence parallelism), aux a float32 zero."""
    sh = DecoderShards(cfg, policy)
    x, _ = sh.stack(sh.enter_params(params), embeds, window)
    return x, torch.zeros((), dtype=torch.float32, device=embeds.device)


def make_loss_fn(cfg: ModelConfig, policy: ShardingPolicy, window):
    """(params, batch) -> (loss, metrics), the same on every rank; the
    gradients of a rank's shards are its parts of the full gradients."""
    shards = _shards(cfg, policy)

    def loss_fn(params, batch):
        sh = shards()
        params = sh.enter_params(params)
        batch = sh.local_batch(batch)
        embeds, n_prefix, _ = sh.embed_inputs(params, batch)
        x, seq_on = sh.stack(params, embeds, window)
        s_text = batch["tokens"].shape[1]
        xf = sh.enter(x, seq_on)[:, n_prefix:n_prefix + s_text]
        loss = sh.batch_mean(sh.xent(sh.logits(params, xf), batch["labels"]))
        return loss, {"xent": loss}

    return loss_fn


def make_prefill_fn(cfg: ModelConfig, policy: ShardingPolicy, window):
    """Prefill on this rank: the last real token's logits (B, 1, V_pad)
    of the global batch on every rank, and a decode state holding this
    rank's part of the cache (``make_state_spec_rule``'s layout: its
    rows, its heads or length)."""
    shards = _shards(cfg, policy)

    def prefill_fn(params, batch):
        sh = shards()
        tp = sh.tp
        n_rows = batch["tokens"].shape[0]
        x, _, n_pad = sh.embed_inputs(params, sh.local_batch(batch))
        b, s = x.shape[:2]
        t = s + PREFILL_CACHE_MARGIN
        spec = sh.cache_spec(t)
        cache = _zero_cache(sh, b, t, x.device)
        seq_on = tp.seq_on(s)
        rope = _rope(cfg, torch.arange(s, device=x.device))
        if seq_on:
            x = tp.slice_(x, 1)
        for i, layer in enumerate(tree_unstack(params["layers"])):
            x, k, v, k_all, v_all = sh.block(sh.gather_layer(layer), x, rope,
                                             window, seq_on)
            if k_all is None:                  # heads: this rank's own
                cache["k"][i, :, :s] = k
                cache["v"][i, :, :s] = v
                continue
            for n, full in (("k", k_all), ("v", v_all)):
                padded = F.pad(full, (0, 0, 0, 0, 0, t - s))
                cache[n][i] = local_slice(padded, spec[1:], tp.mesh)
        x = sh.norm(params["ln_f"], x, seq_on)
        p = s - n_pad - 1                      # the last real position
        last = sh.last_position(x, p, seq_on)
        logits = sh.gathered_logits(params, common.pad_rows(
            last, common.row_bucket(b)))[:b]
        return sh.gather_rows(logits, n_rows), {"cache": cache, "pos": p}

    return prefill_fn


def _zero_cache(sh: DecoderShards, batch: int, cache_len: int, device):
    """A zero cache (L, B, T, Hkv, hd) in this rank's layout."""
    cfg = sh.cfg
    shape = local_shape((cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                         cfg.resolved_head_dim), sh.cache_spec(cache_len),
                        sh.policy.mesh)
    return {k: torch.zeros(shape, dtype=sh.dt, device=device)
            for k in ("k", "v")}


def _decode_attention(sh: DecoderShards, q, kv: dict, pos: int, mode: str,
                      cache_len: int):
    """Single-token attention of the replicated ``q`` (R, 1, Hq, hd)
    over this rank's part ``kv`` (float32, R rows) of a cache split over
    its length ("length") or its hd ("hd"): the ranks' softmax terms
    combined. Returns (R, 1, Hq, hd) on every rank."""
    tp, cfg = sh.tp, sh.cfg
    r, _, hq, hd = q.shape
    n_kv = cfg.n_kv_heads
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(r, n_kv, hq // n_kv, hd)
    if mode == "hd":
        part = tp.part(hd)
        scores = torch.matmul(qg[..., part], kv["k"].permute(0, 2, 3, 1))
        scores = tp.sum_(scores) * scale                  # (R, Hkv, G, T)
        valid = torch.arange(cache_len, device=q.device) < min(pos + 1,
                                                              cache_len)
        p = torch.softmax(torch.where(valid, scores, attn_lib.NEG_INF), -1)
        o = tp.gather(torch.matmul(p, kv["v"].transpose(1, 2)), -1)
        return o.reshape(r, 1, hq, hd).to(q.dtype)
    t_l = kv["k"].shape[1]
    scores = torch.matmul(qg, kv["k"].permute(0, 2, 3, 1)) * scale
    slots = tp.index * t_l + torch.arange(t_l, device=q.device)
    scores = torch.where(slots < min(pos + 1, cache_len), scores,
                         attn_lib.NEG_INF)
    top = tp.max_(scores.amax(-1, keepdim=True))
    p = torch.exp(scores - top)
    total = tp.sum_(p.sum(-1, keepdim=True))
    o = tp.sum_(torch.matmul(p, kv["v"].transpose(1, 2))) / total
    return o.reshape(r, 1, hq, hd).to(q.dtype)


def make_decode_fn(cfg: ModelConfig, policy: ShardingPolicy):
    """One token through the stack on this rank: its rows of the global
    batch, the cache in this rank's layout written in place (the ring
    slot ``pos + 1`` by the rank that holds it), the logits (B, 1, V_pad)
    of the global batch on every rank; rows padded to
    ``common.DECODE_ROWS`` as the unsharded decode."""
    shards = _shards(cfg, policy)
    hd = cfg.resolved_head_dim

    def decode_fn(params, state, batch):
        sh = shards()
        tp, dt = sh.tp, sh.dt
        n_rows = batch["token"].shape[0]
        batch = sh.local_batch(batch)
        b = batch["token"].shape[0]
        rows = common.row_bucket(b)
        cache = state["cache"]
        pos = state["pos"] + 1
        mode, t = sh.cache_layout(tuple(cache["k"].shape))
        slot = pos % t
        x = sh.embed(params, common.pad_rows(batch["token"], rows)).to(dt)
        rope = _rope(cfg, torch.full((1,), pos, dtype=torch.int32,
                                     device=x.device))
        kv32 = {n: torch.zeros((rows,) + cache[n].shape[2:],
                               dtype=torch.float32, device=x.device)
                for n in ("k", "v")}
        for i, layer in enumerate(tree_unstack(params["layers"])):
            layer = sh.gather_layer(layer)
            xc = common.rmsnorm(layer["ln1"], x, cfg.norm_eps).to(dt)
            q, k, v, k_all, v_all = sh.qkv(layer["attn"], xc, rope)
            if mode == "heads":
                cache["k"][i, :, slot] = k[:b, 0]
                cache["v"][i, :, slot] = v[:b, 0]
            elif mode == "length":
                t_l = cache["k"].shape[2]
                if slot // t_l == tp.index:
                    cache["k"][i, :, slot % t_l] = k_all[:b, 0]
                    cache["v"][i, :, slot % t_l] = v_all[:b, 0]
            elif mode == "hd":
                part = tp.part(hd)
                cache["k"][i, :, slot] = k_all[:b, 0, :, part]
                cache["v"][i, :, slot] = v_all[:b, 0, :, part]
            else:
                cache["k"][i, :, slot] = k_all[:b, 0]
                cache["v"][i, :, slot] = v_all[:b, 0]
            for n in ("k", "v"):
                kv32[n][:b] = cache[n][i]
            if mode == "heads":
                o = attn_lib.decode_attention(q, kv32, pos)
            else:
                q_all = tp.gather(q, 2) if sh.heads_split else q
                if mode == "replicated":
                    o = attn_lib.decode_attention(q_all, kv32, pos)
                else:
                    o = _decode_attention(sh, q_all, kv32, pos, mode, t)
                if sh.heads_split:
                    o = o[:, :, sh.q_lo:sh.q_lo + sh.hq]
            partial = common.matmul(o.reshape(rows, 1, -1),
                                    layer["attn"]["wo"].to(dt))
            x = x + (tp.sum_(partial) if sh.heads_split
                     else partial).to(x.dtype)
            x = x + sh.ffn(layer, x, False)
        x = common.rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = sh.gathered_logits(params, x)[:b]
        return sh.gather_rows(logits, n_rows), {"cache": cache, "pos": pos}

    return decode_fn


def sharded_model(model: Model, cfg: ModelConfig, policy: ShardingPolicy,
                  window) -> Model:
    """``model`` (the unsharded decoder) on this rank: its init draws the
    one seeded init and keeps this rank's shards, its functions run on
    them, and ``unsharded`` keeps the global model."""
    shards = _shards(cfg, policy)

    def init_state(batch_size: int, cache_len: int, device="cuda"):
        sh = shards()
        rows = sh.rows(batch_size)
        return {"cache": _zero_cache(sh, rows.stop - rows.start, cache_len,
                                       resolve_device(device)),
                "pos": cache_len - 1}

    return dataclasses.replace(
        model,
        init=lambda generator, device="cuda": init_decoder_params(
            generator, cfg, device, cut=shards().cut),
        loss_fn=per_client_loss(make_loss_fn(cfg, policy, window)),
        prefill_fn=make_prefill_fn(cfg, policy, window),
        decode_fn=make_decode_fn(cfg, policy),
        init_decode_state=init_state,
        unsharded=model)
