"""Bucketed wave scheduler: batched serving over ``prefill_fn``/``decode_fn``
(the port of ``repro.serving.scheduler``).

The decode step carries ONE shared position per batch, so the scheduler
batches *waves*: requests are bucketed by prompt length, a wave of up to
``max_batch`` equal-length prompts is prefilled together, decoded
lock-step until every member finishes (EOS or its token budget), then
the next wave launches. Finished slots keep riding the batch with their
outputs masked — the static-batching trade-off, measured by the
reported occupancy.

Correctness property (tests/test_torch_hybrid.py, and ``chip_smoke.py``
at full width on the card): every request's output is what a
batch-size-1 serial decode of that request produces — batching is a
throughput decision, never a semantic one. Not for the moe family: its
expert capacity spans the whole batch, so a request's tokens depend on
its wave, in the reference as in the port
(tests/test_torch_moe.py).

The vlm and audio families take stub frontend embeddings beside the
tokens: ``frontend`` (frontend_len, frontend_dim), given once, goes to
every request of every wave, broadcast over the wave as float32 on the
params' device, as the reference's ``_batch_inputs`` does.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.utils.trees import tree_leaves


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the scheduler:
    output: Optional[np.ndarray] = None   # (n_generated,) int32
    wave: int = -1
    latency_steps: int = 0


@dataclass
class WaveStats:
    wave: int
    batch: int
    prompt_len: int
    steps: int
    occupancy: float      # live-slot fraction over the wave's decode steps
    wall_s: float
    ttft_s: float         # prefill until the first tokens are on the host


class WaveScheduler:
    """Greedy-decoding wave scheduler for any port ``Model`` with a
    prefill/decode pair; runs where ``params`` lie."""

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 frontend=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.device = tree_leaves(params)[0].device
        # stub embeddings for vlm/audio, uploaded once
        self.frontend = None if frontend is None else torch.as_tensor(
            frontend, dtype=torch.float32).to(self.device)
        self._queue: List[Request] = []
        self.stats: List[WaveStats] = []

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    # ------------------------------------------------------------------
    def _buckets(self) -> Dict[int, List[Request]]:
        out: Dict[int, List[Request]] = defaultdict(list)
        for r in self._queue:
            out[len(r.tokens)].append(r)
        return out

    def _batch_inputs(self, wave: List[Request]) -> dict:
        toks = torch.as_tensor(np.stack([r.tokens for r in wave]),
                               dtype=torch.int32).to(self.device)
        batch = {"tokens": toks}
        family = self.model.config.family
        if family in ("vlm", "audio"):
            if self.frontend is None:
                raise ValueError(f"{family} serving needs frontend "
                                 f"embeddings")
            batch["frontend"] = self.frontend.expand(
                (len(wave),) + tuple(self.frontend.shape)).contiguous()
        return batch

    def _next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _run_wave(self, wave: List[Request], wave_idx: int) -> None:
        t0 = time.perf_counter()
        b = len(wave)
        max_new = max(r.max_new_tokens for r in wave)
        logits, state = self.model.prefill_fn(self.params,
                                              self._batch_inputs(wave))
        tok = self._next_tokens(logits)

        outputs: List[List[int]] = [[] for _ in wave]
        done = np.zeros(b, bool)
        live_steps = 0
        steps = 0
        ttft = 0.0
        for step in range(max_new):
            tok_np = tok.cpu().numpy()
            if step == 0:
                ttft = time.perf_counter() - t0
            for i, r in enumerate(wave):
                if done[i]:
                    continue
                outputs[i].append(int(tok_np[i]))
                r.latency_steps = step + 1
                if len(outputs[i]) >= r.max_new_tokens or \
                        (r.eos_id is not None and tok_np[i] == r.eos_id):
                    done[i] = True
            live_steps += int((~done).sum())
            steps = step + 1
            if done.all():
                break
            logits, state = self.model.decode_fn(self.params, state,
                                                 {"token": tok[:, None]})
            tok = self._next_tokens(logits)

        for i, r in enumerate(wave):
            r.output = np.asarray(outputs[i], np.int32)
            r.wave = wave_idx
        self.stats.append(WaveStats(
            wave=wave_idx, batch=b, prompt_len=len(wave[0].tokens),
            steps=steps, occupancy=live_steps / max(steps * b, 1),
            wall_s=time.perf_counter() - t0, ttft_s=ttft))

    # ------------------------------------------------------------------
    def run(self) -> List[Request]:
        """Serve everything in the queue; returns completed requests."""
        served: List[Request] = []
        wave_idx = 0
        for _plen, reqs in sorted(self._buckets().items()):
            for i in range(0, len(reqs), self.max_batch):
                wave = reqs[i: i + self.max_batch]
                self._run_wave(wave, wave_idx)
                served.extend(wave)
                wave_idx += 1
        self._queue.clear()
        return served

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        if not self.stats:
            return {}
        tok = sum(s.steps * s.batch for s in self.stats)
        wall = sum(s.wall_s for s in self.stats)
        return {
            "waves": len(self.stats),
            "decode_slot_steps": tok,
            "mean_occupancy": float(np.mean(
                [s.occupancy for s in self.stats])),
            "wall_s": wall,
            "slot_tokens_per_s": tok / max(wall, 1e-9),
        }
