"""The hybrid family (recurrentgemma-2b) over a rank mesh: tensor
parallelism over the model axis, sequence parallelism with the policy's
``seq_axis``, batch axes and fsdp, on each rank's shards.

The port of the reference's ``build_rglru_model`` under GSPMD, whose
``spec_rule`` and ``state_spec_rule`` (``models/rglru.py``) lay out the
params and the decode state and whose ``shard_hint`` calls mark the
sequence split. Each rank holds its shards and places the collectives
itself, through :mod:`repro_torch.models.tensor_parallel`:

* **Recurrent block**: ``w_main`` and ``w_gate`` column-split over the
  RG-LRU channels dr. The gates ``w_a`` and ``w_x`` are dense (dr x
  dr) products split over their output channels, so they read the whole
  conv output: ``w_main``'s output is all-gathered over the model axis
  (backward: the float32 reduce-scatter) and every rank runs the
  width-4 conv on all dr channels, which keeps the conv state whole, as
  the state rule replicates it. Then each rank takes its own channels'
  gates, and the RG-LRU scan (the CUDA kernel on the card) runs on its
  dr / M channels, contiguous tensors of its own; the state ``h`` is
  split over them, as the rule says. ``w_down`` is row-parallel, its
  partial sums added in float32. ``conv_w`` and ``conv_b`` are
  replicated and each rank's gradient of them is its part (the conv
  output's gradient is split by the gates' columns), so they are summed
  over the ranks; ``lam``, ``b_a`` and ``b_x`` are replicated and read
  at the rank's channels, their gradients summed over the ranks too, so
  every rank holds the whole gradient.
* **GeGLU MLP** (every block's): ``w_gate`` and ``w_up`` column-split,
  ``w_down`` row-split.
* **Local attention block**: the rule keeps ``wq``, ``wk`` and ``wv``
  at ``P(f, None)`` and ``wo`` at ``P(None, f)``, so every model rank
  runs all the heads itself (the flash kernel, windowed) on the whole
  stream, and its weights' gradients are whole on every rank, not
  summed over the model axis.
* **Sequence parallelism** (training): between blocks the residual
  stream holds this rank's S / M positions; it is gathered once at each
  triple's entry and at each tail block's entry and split at the exit,
  as the reference's ``force=True`` hints mark it, and runs whole inside
  (the recurrence reads every position). The final norm then sees only
  the rank's positions, so ``ln_f``'s gradient is summed over the ranks
  (the norm-scale trap of sequence parallelism). Prefill and decode
  keep the stream whole, as the reference's prefill sets no hint.
* **Vocab**: the embedding table split over its rows, ``lm_head`` over
  its columns (``RankShards``), ``x * sqrt(d_model)`` after the ranks'
  sum. Prefill and decode gather the logits to every rank.
* **Batch axes and fsdp** as the dense decoder's (``RankShards``): a
  rank keeps its rows of every batch array and of the decode state, and
  a leaf split over the fsdp axes is gathered where it is read.

Prefill and decode run the unsharded model's block loops
(``rglru.prefill_layers`` and ``rglru.decode_layers``) on this rank's
blocks, so they follow the port's unsharded hybrid, not the
reference's: decode writes the new token at ``pos + 1`` into a ring of
``local_attn_window`` slots (``models/rglru.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, rglru
from repro_torch.models.api import Model, per_client_loss
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.models.tensor_parallel import RankShards, lazy
from repro_torch.utils.trees import tree_unstack

_PER_CHANNEL = ("lam", "b_a", "b_x")


class HybridShards(RankShards):
    """The hybrid ``cfg`` on this rank of ``policy``'s mesh: its RG-LRU
    channels, its MLP columns, its vocab rows, its batch rows and its
    fsdp shards."""

    STACKED = ("triples/", "tail/")

    def __init__(self, cfg: ModelConfig, policy: ShardingPolicy):
        super().__init__(cfg, policy, rglru.make_spec_rule(cfg, policy),
                         rglru.init_rglru_params(None, cfg, "meta"))
        dr = cfg.rglru_dim or cfg.d_model
        self.require(("d_ff", cfg.d_ff), ("rglru_dim", dr))
        self.dr = dr // self.tp.size
        self.own = slice(self.tp.index * self.dr,
                         (self.tp.index + 1) * self.dr)
        self.embed_scale = math.sqrt(cfg.d_model)

    def summed(self, x):
        """A replicated leaf whose gradient each rank holds in part,
        passed through ``copy`` (backward: the sum over the ranks)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return self.tp.copy(x)
        return x

    # ---- blocks ----------------------------------------------------------
    def geglu(self, mlp: dict, x, ln: dict):
        """The block's MLP residual branch on the whole stream ``x``."""
        hn = common.rmsnorm(ln, x, self.cfg.norm_eps).to(self.dt)
        partial = common.geglu(mlp, self.enter(hn, False))
        return self.leave(partial, False, x.dtype)

    def recurrent(self, block: dict, x, state=None, decode=False):
        """``rglru.recurrent_block`` on this rank (``x`` the whole
        stream): (x, {"h": its channels' state, "conv": all channels'})."""
        cfg, dt, tp = self.cfg, self.dt, self.tp
        xn = common.rmsnorm(block["ln"], x, cfg.norm_eps).to(dt)
        xc = self.enter(xn, False)
        main = tp.gather_seq(common.matmul(xc, block["w_main"].to(dt)), 2)
        gate = common.gelu(common.matmul(xc, block["w_gate"].to(dt)))
        conv = {k: self.summed(block[k]) for k in ("conv_w", "conv_b")}
        main, new_conv = rglru._conv1d(
            conv, main, state["conv"] if state is not None else None)
        main32 = main.float()
        gates = {"w_a": block["w_a"], "w_x": block["w_x"],
                 **{k: self.summed(block[k])[self.own] for k in _PER_CHANNEL}}
        own = main32[..., self.own]
        if decode:
            y, h_new = rglru.rglru_step(gates, main32, state["h"], own)
        else:
            h0 = state["h"] if state is not None else None
            y = rglru.rglru_scan(gates, main32, h0, own)
            h_new = y[:, -1].clone()
        y = y.to(dt) * gate
        out = self.leave(common.matmul(y, block["w_down"].to(dt)), False,
                         x.dtype)
        x = x + out
        x = x + self.geglu(block["mlp"], x, block["ln_mlp"])
        return x, {"h": h_new, "conv": new_conv.to(dt)}

    def attention(self, block: dict, x, cache=None, pos=None, decode=False):
        """``rglru.local_attn_block`` on this rank: the attention on every
        head (replicated), the MLP column- and row-split."""
        h, out_state = rglru.local_attention(block, x, self.cfg, cache, pos,
                                             decode)
        x = x + h.to(x.dtype)
        return x + self.geglu(block["mlp"], x, block["ln_mlp"]), out_state

    def triple_body(self, triple: dict, x, seq_on: bool):
        triple = self.gather_layer(triple, "triples/")
        x = self.tp.gather_rep(x) if seq_on else x
        x = self.recurrent(triple["rec1"], x)[0]
        x = self.recurrent(triple["rec2"], x)[0]
        x = self.attention(triple["attn"], x)[0]
        return self.tp.split_seq(x) if seq_on else x

    def tail_body(self, block: dict, x, seq_on: bool):
        block = self.gather_layer(block, "tail/")
        x = self.tp.gather_rep(x) if seq_on else x
        x = self.recurrent(block, x)[0]
        return self.tp.split_seq(x) if seq_on else x

    def forward(self, params: dict, tokens):
        """The training forward over this rank's rows: (the final normed
        stream in its layout, seq_on)."""
        cfg = self.cfg
        x = self.embed(params, tokens).to(self.dt)
        x = common.weak_scale(x, self.embed_scale)
        seq_on = self.tp.seq_on(x.shape[1])
        x = self.tp.split_seq(x) if seq_on else x
        remat = cfg.remat and torch.is_grad_enabled()
        for body, stack in ((self.triple_body, params["triples"]),
                            (self.tail_body, params.get("tail", {}))):
            for layer in tree_unstack(stack):
                x = checkpoint(body, layer, x, seq_on, use_reentrant=False) \
                    if remat else body(layer, x, seq_on)
        return self.norm(params["ln_f"], x, seq_on), seq_on

    def zero_state(self, batch_size: int, cache_len: int, dev) -> dict:
        """A zero decode state of this rank's ``batch_size`` rows."""
        return rglru.zero_state(self.cfg, batch_size, cache_len, dev,
                                h_width=self.dr)


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------
def make_loss_fn(shards):
    """(params, batch) -> (loss, metrics), the same on every rank."""

    def loss_fn(params, batch):
        sh = shards()
        params = sh.enter_params(params)
        batch = sh.local_batch(batch)
        x, seq_on = sh.forward(params, batch["tokens"])
        logits = sh.logits(params, sh.enter(x, seq_on))
        loss = sh.batch_mean(sh.xent(logits, batch["labels"]))
        return loss, {"xent": loss}

    return loss_fn


def make_prefill_fn(shards):
    """Prefill on this rank: the last token's logits (B, 1, V_pad) of the
    global batch on every rank, and the decode state of its rows (its
    channels' RG-LRU states, the whole conv states and ring caches)."""

    def prefill_fn(params, batch):
        sh = shards()
        n_rows = batch["tokens"].shape[0]
        tokens = sh.local_batch(batch)["tokens"]
        # the reference scales before the cast here (its forward and
        # decode cast first)
        x = (sh.embed(params, tokens) * sh.embed_scale).to(sh.dt)
        x, state = rglru.prefill_layers(sh, params, x)
        x = common.rmsnorm(params["ln_f"], x[:, -1:], sh.cfg.norm_eps)
        b = x.shape[0]
        logits = sh.gathered_logits(params, common.pad_rows(
            x, common.row_bucket(b)))[:b]
        return sh.gather_rows(logits, n_rows), state

    return prefill_fn


def make_decode_fn(shards):
    """One token on this rank: its rows of the global batch padded to
    ``common.DECODE_ROWS`` (the state's too, as the unsharded decode),
    the logits (B, 1, V_pad) of the global batch on every rank."""

    def decode_fn(params, state, batch):
        sh = shards()
        n_rows = batch["token"].shape[0]
        token = sh.local_batch(batch)["token"]
        b = token.shape[0]
        rows = common.row_bucket(b)
        x = sh.embed(params, common.pad_rows(token, rows)).to(sh.dt)
        x = common.weak_scale(x, sh.embed_scale)
        x, new = rglru.decode_layers(sh, params, rglru.pad_state(state, rows),
                                     x)
        x = common.rmsnorm(params["ln_f"], x, sh.cfg.norm_eps)
        logits = sh.gathered_logits(params, x)[:b]
        return sh.gather_rows(logits, n_rows), rglru.cut_state(new, b)

    return decode_fn


def sharded_model(model: Model, cfg: ModelConfig,
                  policy: ShardingPolicy) -> Model:
    """``model`` (the unsharded hybrid) on this rank: its init draws the
    one seeded init and keeps this rank's shards, its functions run on
    them, and ``unsharded`` keeps the global model."""
    shards = lazy(lambda: HybridShards(cfg, policy))

    def init_state(batch_size: int, cache_len: int, device="cuda"):
        sh = shards()
        rows = sh.rows(batch_size)
        return sh.zero_state(rows.stop - rows.start,
                             min(cache_len, cfg.local_attn_window),
                             resolve_device(device))

    return dataclasses.replace(
        model,
        init=lambda generator, device="cuda": rglru.init_rglru_params(
            generator, cfg, device, cut=shards().cut),
        loss_fn=per_client_loss(make_loss_fn(shards)),
        prefill_fn=make_prefill_fn(shards),
        decode_fn=make_decode_fn(shards),
        init_decode_state=init_state,
        unsharded=model)
