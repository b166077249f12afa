"""What ``test_torch_hybrid_tp.py`` and ``test_torch_encdec_tp.py`` share:
a family's cases over rank meshes of gloo ranks, held to the port's
unsharded path at float32 and to the reference's own sharded run at
bf16.

* Params: the reference's init (``jax.random``, numpy), carried into
  the port (``params_from_numpy``) and cut by ``shard_params``.
* :func:`run_worlds` runs every case's ``family_case`` task (and any
  extra tasks) once, one world a mesh size; :func:`unsharded` runs the
  port's unsharded loss, gradients, prefill, teacher-forced decode
  steps and decode states of the same inputs in this process, on one
  intra-op thread as each rank runs.
* :func:`start_reference` starts the reference's bf16 loss, gradients
  and logits, unsharded and on forged ``Auto`` meshes of 8 host devices
  (a subprocess, as ``test_torch_fsdp.py`` runs it) while the ranks run;
  :func:`reference_runs` collects them and :func:`assert_in_band` holds
  the port's bf16 runs to them.
* :func:`unsharded_clip` and :func:`unsharded_loop` give the unsharded
  clip (global norm, one clipped SGD step, three clipped AdamW steps)
  and ``TrainLoop`` run (a checkpoint a step) that ``clip_case`` and
  ``loop_case`` are held to; :func:`host_round` the federated host path
  ``fl_tp_round`` is held to.
"""
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.fl.distributed import FLTrainStep
from repro_torch.launch.world import run_world
from repro_torch.models import get_model
from repro_torch.models.api import flat_params, make_train_step
from repro_torch.optim import adamw, sgd
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.utils.trees import tree_flatten, tree_global_norm, tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).parent))
import _torch_world  # noqa: E402  (the ranks' tasks)

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_RTOL = 1e-6
SGD_UPDATE_REL = 1e-3
ADAMW_UPDATE_REL = 2e-3
LOOP_UPDATE_REL = 1e-3
FL_TOL = dict(rtol=3e-4, atol=3e-5)      # test_torch_fl_tp.py's
BAND_MARGIN = 2.0
LOSS_BAND = 4.34e-4                      # test_torch_tensor_parallel.py's
# the clip bites at 0.1; SGD's step at 0.1 moves each weight by hundreds
# of its float32 spacings (at 1e-3 by a few, where the step's own
# rounding outweighs the gradient's error)
CLIP, CLIP_LR, CLIP_SGD_LR = 0.1, 1e-3, 0.1
FL_LR = 0.05


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def config(arch, over):
    return get_config(arch).reduced().replace(**over)


def ref_params(arch, over, seed):
    """The reference's init of the reduced ``arch`` with ``over``, numpy
    (float32 params whatever the compute dtype or remat)."""
    over = {k: v for k, v in over.items() if k not in ("dtype", "remat")}
    return _ref_params(arch, tuple(sorted(over.items())), seed)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, over, seed):
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import get_model as ref_get_model
    cfg = ref_get_config(arch).reduced().replace(**dict(over))
    params = ref_get_model(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.asarray(x), params)


def token_batch(cfg, rng, rows, seq):
    toks = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frontend"] = rng.standard_normal(
            (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _inputs(arch, over, seed, rows, seq, prompt_len, steps):
    return _make_inputs(arch, dict(over), seed, rows, seq, prompt_len,
                           steps)


def inputs(arch, over, seed, rows, seq, prompt_len, steps):
    """(params, batch, prompt, steps) of a case, numpy, from seeds (made
    once a distinct case)."""
    return _inputs(arch, tuple(sorted(over.items())), seed, rows, seq,
                   prompt_len, steps)


def _make_inputs(arch, over, seed, rows, seq, prompt_len, steps):
    cfg = config(arch, over)
    params = ref_params(arch, over, seed)
    rng = np.random.default_rng((seed, rows, seq, prompt_len))
    batch = token_batch(cfg, rng, rows, seq)
    prompt = {"tokens": rng.integers(0, cfg.vocab_size,
                                     (rows, prompt_len)).astype(np.int32)}
    if "frontend" in batch:
        prompt["frontend"] = rng.standard_normal(
            batch["frontend"].shape).astype(np.float32)
    dec = rng.integers(0, cfg.vocab_size, (rows, steps)).astype(np.int32)
    return params, batch, prompt, dec


def _state_np(state):
    """A numpy copy of a decode state (decode writes its caches in
    place)."""
    return params_to_numpy(tree_map(torch.clone, {
        k: v for k, v in state.items() if k != "pos"}))


def unsharded(arch, over, params, batch, prompt, steps):
    """The port's unsharded loss, grads, logits (prefill, then each
    decode step) and decode states (after prefill, after the steps)."""
    model = get_model(config(arch, over))
    p = params_from_numpy(params, "cpu")
    leaves, rebuild = tree_flatten(p)
    live = [x.detach().requires_grad_() for x in leaves]
    with one_thread():
        loss, _ = model.loss_fn(rebuild(live), {k: torch.tensor(v)
                                                for k, v in batch.items()})
        grads = params_to_numpy(rebuild(list(torch.autograd.grad(loss,
                                                                 live))))
        with torch.no_grad():
            logits, state = model.prefill_fn(p, {k: torch.tensor(v) for k, v
                                                 in prompt.items()})
            out, states = [logits.numpy()], [_state_np(state)]
            for j in range(steps.shape[1]):
                logits, state = model.decode_fn(
                    p, state, {"token": torch.tensor(steps[:, j:j + 1])})
                out.append(logits.numpy())
            states.append(_state_np(state))
    return {"loss": float(loss.detach()), "grads": grads, "logits": out,
            "states": states}


def run_worlds(arch, cases, case_inputs, extra=()):
    """Every case's ``family_case`` on its mesh (``cases``: name ->
    (overrides, dims, seq, fsdp, dtypes)), and ``extra`` tasks ((key,
    world, (task name, kwargs))), one world a size: {(name, dtype) or
    key: [result a rank]}."""
    out = {}
    sizes = sorted({int(np.prod(c[1])) for c in cases.values()}
                   | {w for _, w, _ in extra}, reverse=True)
    for world in sizes:
        keys, tasks = [], []
        for name, (over, dims, seq, fsdp, dtypes) in cases.items():
            if int(np.prod(dims)) != world:
                continue
            for dtype in dtypes:
                params, batch, prompt, steps = case_inputs(name, dtype)
                keys.append((name, dtype))
                tasks.append(("family_case", dict(
                    dims=dims, axes=("data", "model"),
                    cfg=(arch, dict(over, dtype=dtype)), seq=seq, fsdp=fsdp,
                    params=params, batch=batch, prompt=prompt,
                    steps=steps)))
        for key, w, task in extra:
            if w == world:
                keys.append(key)
                tasks.append(task)
        per_rank = run_world(_torch_world.run_tasks, world, (tasks,),
                             timeout=WORLD_TIMEOUT_S)
        for j, key in enumerate(keys):
            out[key] = [r[j] for r in per_rank]
    return out


# ---------------------------------------------------------------------------
# bf16: the reference's own sharded runs
# ---------------------------------------------------------------------------
REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_config
    from repro.models import get_model
    from repro.models.sharding import make_policy

    inp = np.load(sys.argv[1], allow_pickle=True)
    cases = json.loads(str(inp["cases"]))
    out = {}

    def run(model, p, batch, prompt, steps):
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss_fn(p, b)[0]))(p, batch)
        logits, st = jax.jit(model.prefill_fn)(p, prompt)
        outs = [np.asarray(logits, np.float32)]
        dec = jax.jit(model.decode_fn)
        for j in range(steps.shape[1]):
            logits, st = dec(p, st, {"token": jnp.asarray(steps[:, j:j + 1])})
            outs.append(np.asarray(logits, np.float32))
        leaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(g)]
        return float(loss), leaves, outs

    def save(tag, res):
        loss, grads, logits = res
        out[f"{tag}_loss"] = loss
        for j, g in enumerate(grads):
            out[f"{tag}_g{j}"] = g
        for j, l in enumerate(logits):
            out[f"{tag}_logits{j}"] = l

    for i, (arch, over, dims, seq, fsdp, un) in enumerate(cases):
        cfg = get_config(arch).reduced().replace(**over)
        params = inp[f"params{i}"].item()
        batch = {k: jnp.asarray(v) for k, v in inp[f"batch{i}"].item().items()}
        prompt = {k: jnp.asarray(v)
                  for k, v in inp[f"prompt{i}"].item().items()}
        steps = inp[f"steps{i}"]
        if un == i:        # the first case of these inputs
            save(f"un{i}", run(get_model(cfg),
                               jax.tree.map(jnp.asarray, params), batch,
                               prompt, steps))
        mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        model = get_model(cfg, make_policy(mesh, fsdp=fsdp, seq_shard=seq))
        p = jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
            params, model.param_pspecs(),
            is_leaf=lambda x: isinstance(x, np.ndarray))
        save(f"sh{i}", run(model, p, batch, prompt, steps))
    np.savez(sys.argv[2], **out)
""")


def start_reference(tmp, arch, cases, case_inputs, names, decode=True):
    """Start the reference's bf16 runs in a subprocess (the test's ranks
    run meanwhile); :func:`reference_runs` waits for them. Each named
    case's loss, grads and logits (prefill, and the decode steps with
    ``decode``) on its forged mesh (``sh{i}_...``, i the name's index in
    ``names``) and unsharded (``un{j}_...``, j the first case of the
    same overrides; see :func:`unsharded_of`)."""
    spec, arr = [], {}
    for i, name in enumerate(names):
        over, dims, seq, fsdp, _ = cases[name]
        spec.append((arch, dict(over, dtype="bfloat16"), dims, seq, fsdp,
                     unsharded_of(cases, names, i)))
        (arr[f"params{i}"], arr[f"batch{i}"], arr[f"prompt{i}"],
         steps) = case_inputs(name, "bfloat16")
        arr[f"steps{i}"] = steps if decode else steps[:, :0]
    np.savez(tmp / "in.npz", cases=json.dumps(spec), **arr)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, tmp / "out.npz"


def reference_runs(started):
    """The results of :func:`start_reference`'s runs: {key: array}."""
    proc, out = started
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


def unsharded_of(cases, names, i):
    """The index in ``names`` of the first case with ``names[i]``'s
    overrides (whose reference run is the unsharded one of them all)."""
    over = cases[names[i]][0]
    return next(j for j, n in enumerate(names) if cases[n][0] == over)


def assert_in_band(port, port_un, ref, i, u, n_logits):
    """The port's bf16 sharded run ``port`` against the reference's
    sharded run ``sh{i}`` (``un{u}`` its unsharded one) and the port's
    own unsharded bf16 run ``port_un``, for the loss, each gradient leaf
    and the first ``n_logits`` logits:

    * sharding moves the port (``port`` against ``port_un``) at most
      BAND_MARGIN times as far as it moves the reference (``sh{i}``
      against ``un{u}``; the loss's gap at least LOSS_BAND);
    * ``port`` lies within BAND_MARGIN times that gap of ``sh{i}``, or
      of the two packages' unsharded gap (``port_un`` against
      ``un{u}``) where that is the larger: the port's bf16 rounding
      differs from the reference's by about as much as sharding moves
      either."""
    def check(got, got_un, sh, un, dist, floor=0.0):
        ref_gap = max(dist(sh, un), floor)
        assert dist(got, got_un) <= BAND_MARGIN * ref_gap, (
            dist(got, got_un), ref_gap)
        band = max(ref_gap, dist(got_un, un))
        assert dist(got, sh) <= BAND_MARGIN * band, (dist(got, sh), band)

    check(port["loss"], port_un["loss"], ref[f"sh{i}_loss"],
          ref[f"un{u}_loss"], lambda a, b: abs(float(a) - float(b)),
          LOSS_BAND)
    for j, (g, g_un) in enumerate(zip(tree_leaves(port["grads"]),
                                      tree_leaves(port_un["grads"]),
                                      strict=True)):
        check(g, g_un, ref[f"sh{i}_g{j}"], ref[f"un{u}_g{j}"], rel)
    for j in range(n_logits):
        check(port["logits"][j], port_un["logits"][j],
              ref[f"sh{i}_logits{j}"], ref[f"un{u}_logits{j}"],
              lambda a, b: float(np.abs(a - b).max()))


# ---------------------------------------------------------------------------
# the clip, TrainLoop and the federated host path, unsharded
# ---------------------------------------------------------------------------
def train_batches(cfg, n, rows, seq, seed):
    rng = np.random.default_rng((seed, 99))
    return [token_batch(cfg, rng, rows, seq) for _ in range(n)]


def unsharded_clip(cfg, params, batches):
    """The unsharded gradient's norm, one ``sgd(CLIP_SGD_LR,
    grad_clip=CLIP)`` step and len(batches) ``adamw(CLIP_LR,
    grad_clip=CLIP)`` steps."""
    model = get_model(cfg)
    ts = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    with one_thread():
        leaves, rebuild = tree_flatten(params_from_numpy(params, "cpu"))
        live = [x.detach().requires_grad_() for x in leaves]
        loss, _ = model.loss_fn(rebuild(live), ts[0])
        out = {"norm": float(tree_global_norm(list(torch.autograd.grad(
            loss, live))))}
        p = flat_params(params_from_numpy(params, "cpu"))
        opt = sgd(CLIP_SGD_LR, grad_clip=CLIP)
        p, _, _ = make_train_step(model, opt)(p, opt.init(p), ts[0])
        out["sgd"] = params_to_numpy(p)
        p = flat_params(params_from_numpy(params, "cpu"))
        opt = adamw(CLIP_LR, grad_clip=CLIP)
        step, state, losses = make_train_step(model, opt), opt.init(p), []
        for b in ts:
            p, state, m = step(p, state, b)
            losses.append(float(m["loss"]))
    out["adamw"], out["losses"] = params_to_numpy(p), losses
    return out


def unsharded_loop(cfg, batches, root):
    """The unsharded ``TrainLoop`` (adamw(1e-3), seed 0, a checkpoint a
    step under ``root/unsharded``), its step-2 checkpoint copied to
    ``root/resume-sharded`` for the ranks: its log and final params."""
    with one_thread():
        loop = TrainLoop(get_model(cfg), adamw(1e-3), lambda s: batches[s],
                         TrainLoopConfig(total_steps=len(batches),
                                         log_every=1, save_every=1,
                                         checkpoint_dir=str(root
                                                            / "unsharded")),
                         device="cpu")
        log = loop.run()["metrics_log"]
    shutil.copytree(root / "unsharded" / "step_00000002",
                    root / "resume-sharded" / "step_00000002")
    return {"log": log, "params": params_to_numpy(loop.params)}


def resume_unsharded(cfg, batches, root):
    """The ranks' step-2 checkpoint resumed unsharded: (start, params)."""
    shutil.copytree(root / "sharded" / "step_00000002",
                    root / "resume-unsharded" / "step_00000002")
    with one_thread():
        loop = TrainLoop(get_model(cfg), adamw(1e-3), lambda s: batches[s],
                         TrainLoopConfig(total_steps=len(batches),
                                         log_every=1, save_every=1,
                                         checkpoint_dir=str(
                                             root / "resume-unsharded")),
                         device="cpu")
        start = loop.start_step
        loop.run()
    return start, params_to_numpy(loop.params)


def seed_init(cfg):
    return params_to_numpy(get_model(cfg).init(
        torch.Generator("cpu").manual_seed(0), "cpu"))


def host_round(cfg, tree, placement, mode, params, batch):
    """The port's host path of one federated round: (params after it,
    loss)."""
    n_clients = next(iter(batch.values())).shape[0]
    fl = FLTrainStep(get_model(cfg), sgd(FL_LR),
                     Hierarchy(*tree[:3], n_clients=tree[3]), placement,
                     local_steps=1, mode=mode)
    one = params_from_numpy(params, "cpu")
    stacked = tree_map(lambda x: x.expand((n_clients,) + x.shape).clone(),
                       one)
    states = [fl.optimizer.init(one) for _ in range(n_clients)]
    with one_thread():
        new, _, metrics = fl.make_round_fn()(
            stacked, states, {k: torch.tensor(v) for k, v in batch.items()})
    return (tree_map(lambda x: x[0].detach().numpy().copy(), new),
            float(metrics["loss"]))
