"""The dense and vlm decoders over batch axes beside the model axis, with
and without fsdp, held to the port's unsharded path and to the
reference's own sharded run; the global-norm clip (fault F4); and
``TrainLoop`` over a rank mesh.

* F4, the clip on sharded params: on a (1, 4) ``("data", "model")``
  mesh (tensor parallelism only) and a (2, 2) mesh with fsdp on and
  off, the clip reads the global norm (rtol 1e-6 of the unsharded
  gradient's, every leaf counted once over the axes that replicate it,
  where the rank's own norm is 0.46-0.68 of it); one
  ``sgd(grad_clip=0.1)`` step, where the clip bites, and 3 steps of
  ``adamw(grad_clip=0.1)`` through ``make_train_step`` equal the
  unsharded steps (each leaf's update within SGD_UPDATE_REL and
  ADAMW_UPDATE_REL relative L2: float32 rounding of ``p - lr * g``
  sets the first; the rank's own norm put 1.3e-2 there); the norms'
  params are bit-equal on every rank after the steps.
* Batch axes and fsdp (``make_policy(mesh, fsdp=..., seq_shard=...)``)
  on (2, 2) ``("data", "model")`` and (2, 2, 2) ``("pod", "data",
  "model")``, sequence parallelism off and on, reduced granite-8b and
  reduced llava (its 8-patch prefix), float32 compute: the global
  batch's loss within rtol 1e-5 of the unsharded loss, the gathered
  gradient within rel L2 1e-4 a leaf, the prefill logits and 4
  teacher-forced decode steps (with the same policy, and with fsdp off
  on the params cut again: the reference's decode layout) within
  rtol 1e-5 / atol 1e-5; the cache holds the rank's rows; the norms'
  gradients are equal on every rank. A batch of 3 on a data axis of 2
  does not divide: every rank takes it whole and the gradient still
  counts it once.
* bf16 compute (the configs' own), fsdp on: the port's gap to the
  reference's sharded run (forged ``Auto`` meshes in a subprocess, 8
  host devices) within BAND_MARGIN (2) times the reference's own gap
  between its sharded and unsharded runs, for each gradient leaf (rel
  L2) and the logits (max abs), and for the loss within BAND_MARGIN
  times the larger of that gap and LOSS_BAND
  (``test_torch_tensor_parallel.py``'s rule).
* ``TrainLoop`` on (2, 2) with fsdp, 3 steps of ``adamw(1e-3)``, a
  checkpoint a step: losses within rtol 1e-5 of the unsharded loop's,
  each leaf's update within LOOP_UPDATE_REL; its checkpoint holds the
  global tree (the unsharded loop's keys and shapes); an unsharded
  checkpoint at step 2 resumed on the ranks, and the ranks' step-2
  checkpoint resumed unsharded, each end within LOOP_UPDATE_REL of the
  loop it left.

Two worlds (4 ranks, 8 ranks) run once each; every test reads their
stored results. The ranks' tasks are ``tests/_torch_world.py``'s
``fsdp_case``, ``clip_case`` and ``loop_case``.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.launch.world import run_world
from repro_torch.models import get_model
from repro_torch.models.api import flat_params, make_train_step
from repro_torch.optim import adamw, sgd
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.utils.trees import tree_flatten, tree_global_norm, tree_leaves

sys.path.insert(0, str(Path(__file__).parent))
import _torch_world  # noqa: E402  (the ranks' tasks)

SRC = str(Path(__file__).resolve().parents[1] / "src")
_INIT_STREAM = 28
_DATA_STREAM = 2028
WORLD_TIMEOUT_S = 300
BATCH, SEQ, PROMPT, STEPS = 4, 16, 12, 4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_RTOL = 1e-6
CLIP, CLIP_LR = 0.1, 1e-3
SGD_UPDATE_REL = 1e-3
ADAMW_UPDATE_REL = 2e-3
LOOP_UPDATE_REL = 1e-3
BAND_MARGIN = 2.0
LOSS_BAND = 4.34e-4

ARCHS = {"granite": "granite-8b", "llava": "llava-next-mistral-7b"}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SEQS = (False, True)
# name -> (arch key, mesh key, seq, batch rows)
CASES = {f"{a}-{m}-seq-{'on' if s else 'off'}": (a, m, s, BATCH)
         for a in ARCHS for m in MESHES for s in SEQS}
CASES["granite-2x2-batch-3"] = ("granite", "2x2", False, 3)
CLIP_CASES = {"tp-1x4": ((1, 4), False), "fsdp-2x2": ((2, 2), True),
              "data-2x2": ((2, 2), False)}


def _cfg(arch, dtype):
    return get_config(ARCHS[arch]).reduced().replace(dtype=dtype)


def _inputs(arch, dtype, rows=BATCH, seed=0):
    """(params, batch, prompt, steps) of an arch, numpy, from seeds."""
    cfg = _cfg(arch, dtype)
    gen = torch.Generator().manual_seed(_INIT_STREAM)
    params = params_to_numpy(get_model(cfg).init(gen, "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, list(ARCHS).index(arch), seed,
                                 rows))
    toks = rng.integers(0, cfg.vocab_size, (rows, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prompt = {"tokens": rng.integers(0, cfg.vocab_size,
                                     (rows, PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        front = rng.standard_normal(
            (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch["frontend"] = prompt["frontend"] = front
    steps = rng.integers(0, cfg.vocab_size, (rows, STEPS)).astype(np.int32)
    return params, batch, prompt, steps


def _train_batches(n, rows=BATCH):
    cfg = _cfg("granite", "float32")
    rng = np.random.default_rng((_DATA_STREAM, 99))
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (rows, 2 * SEQ + 1))
        toks = toks.astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _live(tree):
    leaves, rebuild = tree_flatten(tree)
    return [x.detach().requires_grad_() for x in leaves], rebuild


def _unsharded(arch, rows):
    """The port's unsharded float32 loss, grads and logits."""
    cfg = _cfg(arch, "float32")
    params, batch, prompt, steps = _inputs(arch, "float32", rows)
    model = get_model(cfg)
    p = params_from_numpy(params, "cpu")
    live, rebuild = _live(p)
    loss, _ = model.loss_fn(rebuild(live), {k: torch.tensor(v)
                                            for k, v in batch.items()})
    grads = params_to_numpy(rebuild(list(torch.autograd.grad(loss, live))))
    with torch.no_grad():
        logits, state = model.prefill_fn(p, {k: torch.tensor(v)
                                             for k, v in prompt.items()})
        dec = []
        for j in range(STEPS):
            out, state = model.decode_fn(
                p, state, {"token": torch.tensor(steps[:, j:j + 1])})
            dec.append(out.numpy())
    return float(loss.detach()), grads, logits.numpy(), dec


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread, as each rank runs (the float32 sums then
    take the ranks' order of a BLAS call's terms)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the unsharded oracles (in this process) and the two worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def loop_dirs(tmp_path_factory):
    """The unsharded loop (3 steps, a checkpoint a step) and the
    directories the ranks' loops write and resume in."""
    root = tmp_path_factory.mktemp("loops")
    batches = _train_batches(3)
    with _one_thread():
        loop = TrainLoop(get_model(_cfg("granite", "float32")), adamw(1e-3),
                         lambda s: batches[s],
                         TrainLoopConfig(total_steps=3, log_every=1,
                                         save_every=1, checkpoint_dir=str(
                                             root / "unsharded")),
                         device="cpu")
        log = loop.run()["metrics_log"]
    shutil.copytree(root / "unsharded" / "step_00000002",
                    root / "resume-sharded" / "step_00000002")
    return {"root": root, "batches": batches, "log": log,
            "params": params_to_numpy(loop.params)}


@pytest.fixture(scope="module")
def worlds(loop_dirs):
    """World 4: the (1, 4) and (2, 2) cases, the clip and the loops;
    world 8: the (2, 2, 2) cases."""
    out = {}
    for world in (4, 8):
        keys, tasks = [], []
        for name, (arch, mesh, seq, rows) in CASES.items():
            dims, axes = MESHES[mesh]
            if int(np.prod(dims)) != world:
                continue
            for dtype in ("float32", "bfloat16"):
                if dtype == "bfloat16" and rows != BATCH:
                    continue
                params, batch, prompt, steps = _inputs(arch, dtype, rows)
                for fsdp in ((True, False) if dtype == "float32"
                             else (True,)):
                    keys.append((name, dtype, fsdp))
                    tasks.append(("fsdp_case", dict(
                        dims=dims, axes=axes, cfg=(ARCHS[arch],
                                                   {"dtype": dtype}),
                        seq=seq, fsdp=fsdp, params=params, batch=batch,
                        prompt=prompt, steps=steps)))
        if world == 4:
            params = _inputs("granite", "float32")[0]
            for name, (dims, fsdp) in CLIP_CASES.items():
                keys.append(("clip", name))
                tasks.append(("clip_case", dict(
                    dims=dims, axes=("data", "model"),
                    cfg=("granite-8b", {"dtype": "float32"}), fsdp=fsdp,
                    params=params, batches=_train_batches(3), lr=CLIP_LR,
                    clip=CLIP)))
            for name in ("sharded", "resume-sharded"):
                keys.append(("loop", name))
                tasks.append(("loop_case", dict(
                    dims=(2, 2), axes=("data", "model"),
                    cfg=("granite-8b", {"dtype": "float32"}), fsdp=True,
                    batches=loop_dirs["batches"], lr=1e-3,
                    ckpt=str(loop_dirs["root"] / name))))
        per_rank = run_world(_torch_world.run_tasks, world, (tasks,),
                             timeout=WORLD_TIMEOUT_S)
        for j, key in enumerate(keys):
            out[key] = [r[j] for r in per_rank]
    return out


@pytest.fixture(scope="module")
def unsharded():
    with _one_thread():
        return {key: _unsharded(*key)
                for key in {(c[0], c[3]) for c in CASES.values()}}


# ---------------------------------------------------------------------------
# F4: the clip reads the global norm
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unsharded_clip():
    """The unsharded norm, SGD step and 3 AdamW steps of the clip cases."""
    with _one_thread():
        return _unsharded_clip()


def _unsharded_clip():
    params = _inputs("granite", "float32")[0]
    model = get_model(_cfg("granite", "float32"))
    batches = [{k: torch.tensor(v) for k, v in b.items()}
               for b in _train_batches(3)]
    live, rebuild = _live(params_from_numpy(params, "cpu"))
    loss, _ = model.loss_fn(rebuild(live), batches[0])
    norm = float(tree_global_norm(list(torch.autograd.grad(loss, live))))
    out = {"params": params, "norm": norm}
    p = flat_params(params_from_numpy(params, "cpu"))
    opt = sgd(CLIP_LR, grad_clip=CLIP)
    p, _, _ = make_train_step(model, opt)(p, opt.init(p), batches[0])
    out["sgd"] = params_to_numpy(p)
    p = flat_params(params_from_numpy(params, "cpu"))
    opt = adamw(CLIP_LR, grad_clip=CLIP)
    step, state, losses = make_train_step(model, opt), opt.init(p), []
    for b in batches:
        p, state, m = step(p, state, b)
        losses.append(float(m["loss"]))
    out["adamw"], out["losses"] = params_to_numpy(p), losses
    return out


@pytest.mark.parametrize("name", list(CLIP_CASES))
def test_clip_reads_the_global_norm(worlds, unsharded_clip, name):
    want = unsharded_clip["norm"]
    for r in worlds["clip", name]:
        np.testing.assert_allclose(r["norm"], want, rtol=NORM_RTOL)
        assert r["norm"] == worlds["clip", name][0]["norm"]
    # the rank's own norm, what the clip read before, is not it
    assert worlds["clip", name][0]["local_norm"] < 0.9 * want


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("name", list(CLIP_CASES))
def test_clipped_steps_equal_the_unsharded_steps(worlds, unsharded_clip,
                                                 name, opt):
    ranks = worlds["clip", name]
    p0 = tree_leaves(unsharded_clip["params"])
    tol = SGD_UPDATE_REL if opt == "sgd" else ADAMW_UPDATE_REL
    for got, want, p in zip(tree_leaves(ranks[0][opt]),
                            tree_leaves(unsharded_clip[opt]), p0,
                            strict=True):
        assert _rel(got - p, want - p) <= tol
    if opt == "adamw":
        np.testing.assert_allclose(ranks[0]["losses"],
                                   unsharded_clip["losses"], rtol=LOSS_RTOL)
        for r in ranks[1:]:        # replicated leaves stay bit-equal
            for k, v in r["scales"].items():
                np.testing.assert_array_equal(v, ranks[0]["scales"][k])


# ---------------------------------------------------------------------------
# float32: batch axes and fsdp equal the unsharded path
# ---------------------------------------------------------------------------
def _case_ids():
    return [(n, f) for n in CASES for f in (True, False)]


@pytest.mark.parametrize("name,fsdp", _case_ids(),
                         ids=[f"{n}-fsdp-{'on' if f else 'off'}"
                              for n, f in _case_ids()])
def test_loss_and_gathered_gradient_equal_the_unsharded_path(
        worlds, unsharded, name, fsdp):
    arch, _, _, rows = CASES[name]
    ranks = worlds[name, "float32", fsdp]
    want_loss, want_grads, _, _ = unsharded[arch, rows]
    for r in ranks:               # one loss, the global batch's, everywhere
        assert r["loss"] == ranks[0]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], want_loss, rtol=LOSS_RTOL)
    got, want = tree_leaves(ranks[0]["grads"]), tree_leaves(want_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        assert _rel(a, b) <= GRAD_REL
    for r in ranks[1:]:           # the norms' gradients, on every rank
        for k, g in r["norms"].items():
            np.testing.assert_array_equal(g, ranks[0]["norms"][k])


@pytest.mark.parametrize("name,fsdp", _case_ids(),
                         ids=[f"{n}-fsdp-{'on' if f else 'off'}"
                              for n, f in _case_ids()])
def test_prefill_and_decode_equal_the_unsharded_path(worlds, unsharded,
                                                     name, fsdp):
    arch, mesh, _, rows = CASES[name]
    ranks = worlds[name, "float32", fsdp]
    _, _, want_prefill, want_decode = unsharded[arch, rows]
    data = int(np.prod(MESHES[mesh][0][:-1]))
    local_rows = rows // data if rows % data == 0 else rows
    for r in ranks:               # the logits are gathered to every rank
        np.testing.assert_allclose(r["prefill"], want_prefill, **LOGIT_TOL)
        for key in [k for k in r if k.startswith("decode-")]:
            for got, w in zip(r[key], want_decode, strict=True):
                np.testing.assert_allclose(got, w, **LOGIT_TOL)
        assert r["cache"][1] == local_rows
    assert ("decode-fsdp-off" in ranks[0]) == fsdp


def test_fsdp_gathers_and_scatters_the_weights(worlds):
    on = worlds["granite-2x2-seq-off", "float32", True][0]["traffic"]
    off = worlds["granite-2x2-seq-off", "float32", False][0]["traffic"]
    # fsdp: every weight gathered where read, its gradient reduce-
    # scattered; without it the weights' gradients are all-reduced
    assert on["all_gather"][1] > off.get("all_gather", [0, 0])[1]
    assert on["reduce_scatter"][0] > 0
    assert off["all_reduce_sum"][1] > on["all_reduce_sum"][1]


# ---------------------------------------------------------------------------
# bf16: inside the reference's own sharded band
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

    for i, (arch, dims, axes, seq) in enumerate(cases):
        cfg = get_config(arch).reduced().replace(dtype="bfloat16")
        params = inp[f"params_{arch}"].item()
        batch = {k: jnp.asarray(v)
                 for k, v in inp[f"batch_{arch}"].item().items()}
        prompt = {k: jnp.asarray(v)
                  for k, v in inp[f"prompt_{arch}"].item().items()}
        steps = inp[f"steps_{arch}"]
        if f"un_{arch}_loss" not in out:
            save(f"un_{arch}", run(get_model(cfg),
                                   jax.tree.map(jnp.asarray, params),
                                   batch, prompt, steps))
        mesh = jax.make_mesh(tuple(dims), tuple(axes),
                             axis_types=(AxisType.Auto,) * len(dims))
        model = get_model(cfg, make_policy(mesh, fsdp=True, seq_shard=seq))
        p = jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
            params, model.param_pspecs(),
            is_leaf=lambda x: isinstance(x, np.ndarray))
        save(f"sh{i}", run(model, p, batch, prompt, steps))
    np.savez(sys.argv[2], **out)
""")


def _bf16_keys():
    return [n for n, c in CASES.items() if c[3] == BATCH]


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's bf16 loss, grads and logits, unsharded and with
    fsdp on every bf16 case's forged mesh."""
    tmp = tmp_path_factory.mktemp("ref_fsdp")
    cases, arr = [], {}
    for name in _bf16_keys():
        arch, mesh, seq, _ = CASES[name]
        cases.append((ARCHS[arch], *MESHES[mesh], seq))
        key = ARCHS[arch]
        (arr[f"params_{key}"], arr[f"batch_{key}"], arr[f"prompt_{key}"],
         arr[f"steps_{key}"]) = _inputs(arch, "bfloat16")
    np.savez(tmp / "in.npz", cases=json.dumps(cases), **arr)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", _bf16_keys())
def test_bf16_stays_inside_the_reference_sharded_band(worlds, ref_sharded,
                                                      name):
    i = _bf16_keys().index(name)
    ref, un = ref_sharded, f"un_{ARCHS[CASES[name][0]]}"
    port = worlds[name, "bfloat16", True][0]
    ref_gap = abs(ref[f"sh{i}_loss"] - ref[f"{un}_loss"])
    gap = abs(port["loss"] - ref[f"sh{i}_loss"])
    assert gap <= BAND_MARGIN * max(ref_gap, LOSS_BAND), (gap, ref_gap)
    for j, g in enumerate(tree_leaves(port["grads"])):
        ref_gap = _rel(ref[f"sh{i}_g{j}"], ref[f"{un}_g{j}"])
        gap = _rel(g, ref[f"sh{i}_g{j}"])
        assert gap <= BAND_MARGIN * ref_gap, (j, gap, ref_gap)
    logits = [port["prefill"]] + port["decode-same"]
    for j, got in enumerate(logits):
        sh, un_l = ref[f"sh{i}_logits{j}"], ref[f"{un}_logits{j}"]
        ref_gap = float(np.abs(sh - un_l).max())
        gap = float(np.abs(got - sh).max())
        assert gap <= BAND_MARGIN * ref_gap, (j, gap, ref_gap)


# ---------------------------------------------------------------------------
# TrainLoop over a rank mesh, checkpoints across layouts
# ---------------------------------------------------------------------------
def _assert_updates_close(got, want, init, tol=LOOP_UPDATE_REL):
    for a, b, p in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(init), strict=True):
        assert a.shape == b.shape
        assert _rel(a - p, b - p) <= tol


def _init():
    cfg = _cfg("granite", "float32")
    return params_to_numpy(get_model(cfg).init(
        torch.Generator("cpu").manual_seed(0), "cpu"))


def test_train_loop_over_ranks_equals_the_unsharded_loop(worlds, loop_dirs):
    ranks = worlds["loop", "sharded"]
    want = [rec["loss"] for rec in loop_dirs["log"]]
    for r in ranks:
        assert r["start"] == 0
        np.testing.assert_allclose([rec["loss"] for rec in r["log"]], want,
                                   rtol=LOSS_RTOL)
    _assert_updates_close(ranks[0]["params"], loop_dirs["params"], _init())


def test_sharded_checkpoint_holds_the_global_tree(worlds, loop_dirs):
    root = loop_dirs["root"]
    got = np.load(root / "sharded" / "step_00000003" / "arrays.npz")
    want = np.load(root / "unsharded" / "step_00000003" / "arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape
    flat = {f"params/{path}": leaf for path, leaf in _paths(
        worlds["loop", "sharded"][0]["params"])}
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def test_checkpoints_resume_across_layouts(worlds, loop_dirs):
    root = loop_dirs["root"]
    # an unsharded checkpoint resumed on the ranks
    ranks = worlds["loop", "resume-sharded"]
    assert all(r["start"] == 2 for r in ranks)
    _assert_updates_close(ranks[0]["params"], loop_dirs["params"], _init())
    # the ranks' checkpoint resumed unsharded
    shutil.copytree(root / "sharded" / "step_00000002",
                    root / "resume-unsharded" / "step_00000002")
    batches = loop_dirs["batches"]
    loop = TrainLoop(get_model(_cfg("granite", "float32")), adamw(1e-3),
                     lambda s: batches[s],
                     TrainLoopConfig(total_steps=3, log_every=1, save_every=1,
                                     checkpoint_dir=str(root
                                                        / "resume-unsharded")),
                     device="cpu")
    assert loop.start_step == 2
    loop.run()
    _assert_updates_close(params_to_numpy(loop.params),
                          worlds["loop", "sharded"][0]["params"], _init())
