"""The audio family (seamless-m4t-large-v2) over a rank mesh: tensor
parallelism over the model axis, sequence parallelism with the policy's
``seq_axis``, batch axes and fsdp, on each rank's shards.

The port of the reference's encoder-decoder under GSPMD: its
``spec_rule`` and ``state_spec_rule`` (``models/encdec.py``) lay out
the params and the decode state, its ``shard_hint`` calls the sequence
split. Each rank holds its shards and places the collectives itself,
through :mod:`repro_torch.models.tensor_parallel`:

* **Attention**: where the heads divide by the axis (the rule's
  ``m_ok``), ``wq``, ``wk`` and ``wv`` are column-split by heads and
  ``wo`` row-split, and each rank attends on its own heads: the
  encoder's bidirectional flash kernel (``causal=False``), the
  decoder's causal (or windowed) one, and cross-attention of its heads'
  queries over its heads' keys and values of the encoder output
  (``_enc_kv`` column-split). Otherwise the four are replicated and
  every rank attends on every head (its gradients whole, not summed
  over the axis), while the FFN still splits. The kv heads split with
  the q heads (the rule gates both on ``n_heads``), so they must divide
  too.
* **FFN**: ``w_gate`` and ``w_up`` column-split, ``w_down`` row-split;
  each row-parallel product's partial sums added in float32.
* The encoder keeps its float32 residual stream; the decoder's is the
  compute dtype.
* **Sequence parallelism**, per sublayer as the reference's hints mark
  it in both stacks: between sublayers the stream holds this rank's
  positions (the encoder's frames, the decoder's text positions); each
  sublayer's normed input is gathered (the cross-attention's ``xc``
  too) and its output reduce-scattered. The norms then see only the
  rank's positions, so their scales' gradients are summed over the
  ranks. The encoder's output is gathered once for every decoder
  layer's keys and values.
* **Decode state** (``state_spec_rule``): the self and cross caches
  split over the kv heads where they divide, each rank's rows.
* **Vocab, batch axes and fsdp** (``RankShards``): the embedding table
  split over its rows and ``lm_head`` over the padded vocab's columns;
  the gathered logits keep the padded columns exactly as the unsharded
  run has them (the schedulers' argmax spans them). A rank keeps its
  rows of the tokens, labels and the stub ``frontend``; a leaf split
  over the fsdp axes is gathered where it is read.

Prefill runs one sequence at a time and decode pads each rank's rows to
``common.DECODE_ROWS``, as the unsharded model (batched == serial); a
decode step is the unsharded model's loop (``encdec.decode_layers``)
over this rank's sublayers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib, common, encdec
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.models.tensor_parallel import RankShards, lazy, local_shape
from repro_torch.models.transformer import _rope
from repro_torch.utils.trees import tree_unstack


class EncDecShards(RankShards):
    """The encoder-decoder ``cfg`` on this rank of ``policy``'s mesh: its
    heads, its FFN columns, its vocab rows, its batch rows and its fsdp
    shards."""

    STACKED = ("encoder/", "decoder/")

    def __init__(self, cfg: ModelConfig, policy: ShardingPolicy):
        super().__init__(cfg, policy, encdec.make_spec_rule(cfg, policy),
                         encdec.init_encdec_params(None, cfg, "meta"))
        m = self.tp.size
        self.require(("d_ff", cfg.d_ff))
        self.heads_split = cfg.n_heads % m == 0
        if self.heads_split:
            self.require(("kv heads", cfg.n_kv_heads))
        self.hq = cfg.n_heads // m if self.heads_split else cfg.n_heads
        self.hkv = cfg.n_kv_heads // m if self.heads_split \
            else cfg.n_kv_heads
        self.state_rule = encdec.make_state_spec_rule(cfg, policy)

    # ---- attention -------------------------------------------------------
    def heads_in(self, x, seq_on: bool):
        """An attention input on every rank: entered where the heads
        split (its heads' products' gradients are parts); gathered along
        S, or kept, where attention is replicated (its gradient whole)."""
        if self.heads_split:
            return self.enter(x, seq_on)
        return self.tp.gather_rep(x) if seq_on else x

    def heads_out(self, partial, seq_on: bool, dtype):
        """``wo``'s product in the stream's layout: summed over the ranks
        where the heads split, else this rank's positions of it."""
        if self.heads_split:
            return self.leave(partial, seq_on, dtype)
        h = partial.to(dtype)
        return self.tp.split_seq(h) if seq_on else h

    def project(self, layer_attn: dict, xc, names, heads):
        dt, hd = self.dt, self.cfg.resolved_head_dim
        b, s = xc.shape[:2]
        return [common.matmul(xc, layer_attn[w].to(dt)).reshape(b, s, h, hd)
                for w, h in zip(names, heads, strict=True)]

    def self_attention(self, layer_attn: dict, xn, rope, seq_on: bool, core):
        """Self-attention of the normed stream ``xn`` (its layout):
        (the output in the stream's layout, this rank's rotated k and v
        (B, S, Hkv_l, hd))."""
        xc = self.heads_in(xn.to(self.dt), seq_on)
        q, k, v = self.project(layer_attn, xc, ("wq", "wk", "wv"),
                               (self.hq, self.hkv, self.hkv))
        q, k = common.rotate(q, rope), common.rotate(k, rope)
        o = core(q, k, v)
        partial = common.matmul(o.reshape(o.shape[0], o.shape[1], -1),
                                layer_attn["wo"].to(self.dt))
        return self.heads_out(partial, seq_on, xn.dtype), k, v

    def enc_kv(self, layer: dict, enc) -> dict:
        """``encdec._enc_kv`` of this rank's heads; ``enc`` the encoder
        output as :meth:`encode` enters it."""
        k, v = self.project(layer["cross_attn"], enc.to(self.dt),
                            ("wk", "wv"), (self.hkv, self.hkv))
        return {"k": k, "v": v}

    def cross_attention(self, layer_attn: dict, xn, kv: dict, seq_on: bool):
        xc = self.heads_in(xn.to(self.dt), seq_on)
        q, = self.project(layer_attn, xc, ("wq",), (self.hq,))
        o = attn_lib.dense_attention(q, kv["k"], kv["v"])
        partial = common.matmul(o.reshape(o.shape[0], o.shape[1], -1),
                                layer_attn["wo"].to(self.dt))
        return self.heads_out(partial, seq_on, xn.dtype)

    def ffn(self, layer: dict, x, seq_on: bool):
        hn = self.norm(layer["ln2"], x, seq_on).to(self.dt)
        partial = common.swiglu(layer["ffn"], self.enter(hn, seq_on))
        return self.leave(partial, seq_on, x.dtype)

    # ---- a decode step's sublayers (encdec.decode_layers) -----------------
    def step_qkv(self, layer_attn: dict, xn, rope):
        q, k, v = self.project(layer_attn, xn.to(self.dt), ("wq", "wk", "wv"),
                               (self.hq, self.hkv, self.hkv))
        return common.rotate(q, rope), common.rotate(k, rope), v

    def step_out(self, layer_attn: dict, o, x):
        return self.heads_out(common.matmul(
            o.reshape(o.shape[0], 1, -1), layer_attn["wo"].to(self.dt)),
            False, x.dtype)

    def step_cross(self, layer_attn: dict, xn, kv: dict, x):
        return self.cross_attention(layer_attn, xn, kv, False)

    def step_ffn(self, layer: dict, x):
        return self.ffn(layer, x, False)

    # ---- the stacks --------------------------------------------------------
    def encode(self, params: dict, frontend):
        """The encoder over this rank's rows of ``frontend``: its output,
        every frame, entered for the decoder's keys and values."""
        cfg = self.cfg
        x = frontend.to(getattr(torch, cfg.param_dtype))
        f = x.shape[1]
        seq_on = self.tp.seq_on(f)
        rope = _rope(cfg, torch.arange(f, device=x.device))
        x = self.tp.split_seq(x) if seq_on else x

        def body(layer, x):
            layer = self.gather_layer(layer, "encoder/")
            h, _, _ = self.self_attention(
                layer["attn"], self.norm(layer["ln1"], x, seq_on), rope,
                seq_on, attn_lib.bidirectional_attention)
            x = x + h
            return x + self.ffn(layer, x, seq_on)

        x = _layers(params["encoder"], body, x, cfg.remat)
        return self.heads_in(self.norm(params["ln_enc"], x, seq_on), seq_on)

    def decoder(self, params: dict, tokens, enc, window: Optional[int],
                with_cache: bool = False):
        """The teacher-forced decoder over this rank's ``tokens``: (the
        final normed stream in its layout, seq_on), and with
        ``with_cache`` the self and cross caches of this rank's heads."""
        cfg, dt = self.cfg, self.dt
        x = self.embed(params, tokens).to(dt)
        b, s = tokens.shape
        seq_on = self.tp.seq_on(s)
        rope = _rope(cfg, torch.arange(s, device=x.device))
        x = self.tp.split_seq(x) if seq_on else x

        def core(q, k, v):
            if window is not None and window < s:
                return attn_lib.windowed_attention(q, k, v, window=window)
            return attn_lib.causal_attention(q, k, v)

        caches = None
        if with_cache:
            hd = cfg.resolved_head_dim
            caches = ({n: torch.zeros((cfg.n_layers, b, s + encdec.CACHE_MARGIN,
                                       self.hkv, hd), dtype=dt,
                                      device=x.device) for n in ("k", "v")},
                      {n: torch.empty((cfg.n_layers, b, enc.shape[1],
                                       self.hkv, hd), dtype=dt,
                                      device=x.device) for n in ("k", "v")})

        def body(layer, x, i=None):
            layer = self.gather_layer(layer, "decoder/")
            h, k, v = self.self_attention(
                layer["self_attn"], self.norm(layer["ln1"], x, seq_on), rope,
                seq_on, core)
            x = x + h
            kv = self.enc_kv(layer, enc)
            if i is not None:
                self_c, cross = caches
                self_c["k"][i, :, :s] = k
                self_c["v"][i, :, :s] = v
                for n in ("k", "v"):
                    cross[n][i] = kv[n]
            x = x + self.cross_attention(
                layer["cross_attn"], self.norm(layer["ln_x"], x, seq_on), kv,
                seq_on)
            return x + self.ffn(layer, x, seq_on)

        if with_cache:
            for i, layer in enumerate(tree_unstack(params["decoder"])):
                x = body(layer, x, i)
        else:
            x = _layers(params["decoder"], body, x, cfg.remat)
        x = self.norm(params["ln_f"], x, seq_on)
        return (x, seq_on) + (caches if with_cache else ())

    def zero_state(self, batch_size: int, cache_len: int, dev) -> dict:
        """A zero decode state of this rank's ``batch_size`` rows."""
        cfg = self.cfg
        tail = (cfg.n_kv_heads, cfg.resolved_head_dim)
        out = {}
        for name, t in (("self", cache_len), ("cross", cfg.frontend_len)):
            shape = (cfg.n_layers, batch_size, t) + tail
            local = local_shape(shape, self.cache_spec(name, shape),
                                self.policy.mesh)
            out[name] = {n: torch.zeros(local, dtype=self.dt, device=dev)
                         for n in ("k", "v")}
        out["pos"] = cache_len - 1
        return out

    def cache_spec(self, name: str, shape):
        """The spec of a cache of this rank's rows (its batch dim not
        split again)."""
        return self.state_rule(f"{name}/k", (shape[0], 1) + tuple(shape[2:]))


def _layers(stack: dict, body, x, remat: bool):
    remat = remat and torch.is_grad_enabled()
    for layer in tree_unstack(stack):
        x = checkpoint(body, layer, x, use_reentrant=False) if remat \
            else body(layer, x)
    return x


# ---------------------------------------------------------------------------
# the reference-shaped functions
# ---------------------------------------------------------------------------
def encode(params: dict, frontend, cfg: ModelConfig, policy: ShardingPolicy):
    """``encdec.encode`` on this rank: its shards, its rows; the output
    every frame of them on every model rank."""
    sh = EncDecShards(cfg, policy)
    return sh.encode(sh.enter_params(params), frontend)


def decode_stack(params: dict, tokens, enc_out, cfg: ModelConfig,
                 window: Optional[int], with_cache: bool,
                 policy: ShardingPolicy):
    """``encdec.decode_stack`` on this rank (``enc_out`` as
    :func:`encode` gives it): the stream in its layout, and with
    ``with_cache`` the caches of this rank's heads."""
    sh = EncDecShards(cfg, policy)
    x, _, *caches = sh.decoder(sh.enter_params(params), tokens, enc_out,
                               window, with_cache)
    return (x, *caches) if with_cache else x


def make_loss_fn(shards, window):
    def loss_fn(params, batch):
        sh = shards()
        params = sh.enter_params(params)
        batch = sh.local_batch(batch)
        enc = sh.encode(params, batch["frontend"])
        x, seq_on = sh.decoder(params, batch["tokens"], enc, window)
        logits = sh.logits(params, sh.enter(x, seq_on))
        loss = sh.batch_mean(sh.xent(logits, batch["labels"]))
        return loss, {"xent": loss}

    return loss_fn


def make_prefill_fn(shards, window):
    """Prefill on this rank: the last token's logits (B, 1, V_pad) of the
    global batch on every rank, and the decode state of its rows and
    heads."""

    def prefill_fn(params, batch):
        sh = shards()
        n_rows = batch["tokens"].shape[0]
        batch = sh.local_batch(batch)
        enc = sh.encode(params, batch["frontend"])
        x, seq_on, self_c, cross = sh.decoder(params, batch["tokens"], enc,
                                              window, with_cache=True)
        b, s = batch["tokens"].shape
        last = sh.last_position(x, s - 1, seq_on)
        logits = sh.gathered_logits(params, common.pad_rows(
            last, common.row_bucket(b)))[:b]
        return sh.gather_rows(logits, n_rows), {"self": self_c,
                                                "cross": cross, "pos": s - 1}

    return prefill_fn


def make_decode_fn(shards):
    """One token on this rank (``encdec.decode_layers``): its rows padded
    to ``common.DECODE_ROWS``, the self cache of its heads written at
    ``pos + 1`` in place, the logits (B, 1, V_pad) of the global batch on
    every rank."""

    def decode_fn(params, state, batch):
        sh = shards()
        n_rows = batch["token"].shape[0]
        token = sh.local_batch(batch)["token"]
        b = token.shape[0]
        x = sh.embed(params, common.pad_rows(
            token, common.row_bucket(b))).to(sh.dt)
        x, state = encdec.decode_layers(sh, params, state, x, b)
        x = common.rmsnorm(params["ln_f"], x, sh.cfg.norm_eps)
        logits = sh.gathered_logits(params, x)[:b]
        return sh.gather_rows(logits, n_rows), state

    return decode_fn


def sharded_model(model: Model, cfg: ModelConfig, policy: ShardingPolicy,
                  window) -> Model:
    """``model`` (the unsharded encoder-decoder) on this rank: its init
    draws the one seeded init and keeps this rank's shards, its
    functions run on them, and ``unsharded`` keeps the global model."""
    shards = lazy(lambda: EncDecShards(cfg, policy))

    def init_state(batch_size: int, cache_len: int, device="cuda"):
        sh = shards()
        rows = sh.rows(batch_size)
        return sh.zero_state(rows.stop - rows.start, cache_len,
                             resolve_device(device))

    return dataclasses.replace(
        model,
        init=lambda generator, device="cuda": encdec.init_encdec_params(
            generator, cfg, device, cut=shards().cut),
        loss_fn=per_client_loss(make_loss_fn(shards, window)),
        prefill_fn=make_prefill_fn(shards, window),
        decode_fn=make_decode_fn(shards),
        init_decode_state=init_state,
        unsharded=model)
