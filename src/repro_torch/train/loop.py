"""Checkpointed training loop: the driver around ``make_train_step``
(``repro.train.loop``).

What the reference's loop does, the port's does:
  * one step function (``models.api.make_train_step``: backward into a
    flat grad buffer, one fused AdamW launch, everything in place),
  * periodic eval on a held-out batch,
  * atomic checkpoints (params + optimizer state + step) every
    ``save_every`` steps, the oldest pruned past ``keep_checkpoints``,
  * crash-safe resume: ``TrainLoop(...).run()`` continues from the
    newest checkpoint if one exists, bit for bit the uninterrupted run
    (tests/test_torch_train.py),
  * a metrics log (list of dicts; JSON-serializable).

It runs on ``cuda`` unless the caller passes ``device="cpu"``. Params
come from ``model.init(torch.Generator(device).manual_seed(seed +
_PARAM_STREAM), device)`` and are packed at once into one flat buffer
(``models.api.flat_params``), so the full-width model is never held
twice. To start from other params or optimizer state (a parity test
carrying a reference run's initial params across), set ``loop.params``
to any tree of the model's layout and ``loop.opt_state =
loop.optimizer.init(loop.params)`` before ``run()``; the first step
packs the new params.

Over a rank mesh (a model whose policy shards params: a model, seq or
fsdp axis on a ``launch.mesh.RankMesh``), every rank runs the loop:
``model.init`` keeps the rank's shards of the one seeded init,
``batch_fn`` gives the global batch and the model's functions keep the
rank's rows of it, and the step runs on the rank's flat buffer (the
clip reads the global norm). Checkpoints hold the global tree, as the
reference's do: params and moments are gathered
(``tensor_parallel.gather_params``) and rank 0 writes, so a sharded
checkpoint restores unsharded and an unsharded one restores sharded
(each rank cuts its shards of the stored tree).
"""
from __future__ import annotations

import json
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.store import latest_step, leaves_with_paths, restore_checkpoint, save_checkpoint
from repro_torch.device import resolve_device
from repro_torch.models.api import Model, flat_params, make_train_step
from repro_torch.models.tensor_parallel import gather_params, local_slice
from repro_torch.utils.trees import tree_map, tree_map_with_path

# the params' generator is seeded with the loop's seed plus this stream:
# seed s draws what model.init(torch.Generator(device).manual_seed(s))
# draws, as the reference's loop draws from jax.random.key(s)
_PARAM_STREAM = 0


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    eval_every: int = 20
    save_every: int = 50
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class TrainLoop:
    """Drives ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    over a ``batch_fn(step) -> batch`` data source (numpy arrays or
    tensors; moved to the loop's device)."""

    def __init__(self, model: Model, optimizer, batch_fn: Callable,
                 cfg: TrainLoopConfig, *,
                 eval_batch_fn: Optional[Callable] = None, seed: int = 0,
                 device="cuda"):
        self.model = model
        self.optimizer = optimizer
        self.batch_fn = batch_fn
        self.eval_batch_fn = eval_batch_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, optimizer)
        policy = model.policy
        # the rank mesh and the params' specs, where each rank holds
        # shards of the params (else None: every leaf whole)
        self.mesh = None if policy.mesh is None or policy.replicas_only \
            else policy.mesh
        self.specs = model.param_pspecs() if self.mesh is not None else None

        gen = torch.Generator(self.device).manual_seed(seed + _PARAM_STREAM)
        self.params = flat_params(model.init(gen, self.device))
        self.opt_state = optimizer.init(self.params)
        self.start_step = 0
        self.metrics_log: List[Dict[str, Any]] = []

        if cfg.checkpoint_dir and latest_step(cfg.checkpoint_dir) is not None:
            self._resume()

    # ------------------------------------------------------------------
    @staticmethod
    def _each_tree(state: dict, fn) -> dict:
        """``state`` ({"params", "opt"}) with ``fn`` applied to the params
        and to each moment tree (laid out as the params; sgd's empty
        ones kept)."""
        one = lambda t: fn(t) if leaves_with_paths(t) else t
        opt = state["opt"]
        return {"params": one(state["params"]),
                "opt": opt._replace(mu=one(opt.mu), nu=one(opt.nu))}

    def _state(self) -> dict:
        """The checkpoint's tree: params and optimizer state, global
        (gathered to every rank over a rank mesh)."""
        state = {"params": self.params, "opt": self.opt_state}
        if self.mesh is None:
            return state
        return self._each_tree(
            state, lambda t: gather_params(t, self.specs, self.mesh))

    def _resume(self) -> None:
        """Load the newest checkpoint into the loop's own buffers (the
        params and moments stay flat); over a rank mesh each rank takes
        its shards of the stored global tree."""
        like = {"params": self.params, "opt": self.opt_state}
        template = like
        if self.mesh is not None:
            # global shapes on the host, no storage (an expanded scalar):
            # the stored tree is read to the host, then cut
            shapes = self.model.param_shapes()
            template = self._each_tree(like, lambda t: tree_map(
                lambda x, m: torch.empty((), dtype=x.dtype).expand(m.shape),
                t, shapes))
        tree, extra = restore_checkpoint(self.cfg.checkpoint_dir, template)
        if self.mesh is not None:
            tree = self._each_tree(tree, lambda t: tree_map_with_path(
                lambda path, x, spec: local_slice(x, spec, self.mesh), t,
                self.specs))
        with torch.no_grad():
            for (_, dst), (_, src) in zip(leaves_with_paths(like),
                                          leaves_with_paths(tree),
                                          strict=True):
                dst.copy_(src)
        self.start_step = int(extra.get("step", 0))
        self.metrics_log = extra.get("metrics_log", [])

    def _save(self, step: int) -> None:
        if not self.cfg.checkpoint_dir:
            return
        state = self._state()
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(
                self.cfg.checkpoint_dir, step, state,
                extra={"step": step, "metrics_log": self.metrics_log})
            self._prune()
        if self.mesh is not None:
            torch.distributed.barrier()

    def _prune(self) -> None:
        d = Path(self.cfg.checkpoint_dir)
        steps = sorted(int(p.name.split("_")[1]) for p in d.iterdir()
                       if p.name.startswith("step_"))
        for s in steps[: -self.cfg.keep_checkpoints]:
            shutil.rmtree(d / f"step_{s:08d}", ignore_errors=True)

    def _eval(self, step: int) -> float:
        with torch.no_grad():
            loss, _ = self.model.loss_fn(
                self.params, _to_device(self.eval_batch_fn(step), self.device))
        return float(loss)

    # ------------------------------------------------------------------
    def run(self, verbose: bool = False) -> dict:
        t0 = time.perf_counter()
        for step in range(self.start_step, self.cfg.total_steps):
            batch = _to_device(self.batch_fn(step), self.device)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if (step + 1) % self.cfg.log_every == 0 or \
                    step + 1 == self.cfg.total_steps:
                rec = {"step": step + 1,
                       **{k: float(v) for k, v in metrics.items()}}
                if self.eval_batch_fn and (step + 1) % self.cfg.eval_every == 0:
                    rec["eval_loss"] = self._eval(step)
                self.metrics_log.append(rec)
                if verbose:
                    print(json.dumps(rec))
            if (step + 1) % self.cfg.save_every == 0 or \
                    step + 1 == self.cfg.total_steps:
                self._save(step + 1)
        return {
            "steps": self.cfg.total_steps,
            "wall_s": time.perf_counter() - t0,
            "final": self.metrics_log[-1] if self.metrics_log else {},
            "metrics_log": self.metrics_log,
        }
