"""The dense and vlm decoders over a model axis of gloo ranks, held to
the port's unsharded path and to the reference's own sharded run.

* Float32 compute: on a ``("data", "model")`` mesh of (1, 4) or (1, 2)
  ranks, with sequence parallelism off and on, the sharded loss, its
  gradients (gathered back to full), the prefill logits and 4
  teacher-forced decode steps equal the port's unsharded path at loss
  rtol 1e-5, grads rtol 1e-4 / atol 1e-6 and logits rtol 1e-5 / atol
  1e-5 (the sums over the ranks' partial products change the float32
  rounding only). The cases cover reduced granite-8b and reduced llava
  (its 8-patch prefix), both cache layouts of the reference's rule (the
  kv heads split; 2 kv heads on 4 ranks: the cache split over its
  length, or over hd where the length does not divide), tied
  embeddings with remat, and attention replicated where the q heads do
  not divide. The norms' gradients are equal on every rank.
* bf16 compute (the configs' own): against the reference's sharded run
  on forged ``Auto`` meshes (a subprocess, 8 host devices). The port's
  gap to it stays within BAND_MARGIN (2) times the reference's own gap
  between its sharded and unsharded runs, for each gradient leaf
  (relative L2) and the logits (max abs), and for the loss within
  BAND_MARGIN times the larger of that gap and LOSS_BAND, 4.34e-4, the
  reference's own sharded deviation on reduced granite-8b at (4, 16):
  sharding moves the bf16 rounding, and the port's rounding differs
  from the reference's by about as much (reduced llava's loss is 2.9
  times the reference's small 8.9e-5 gap from the port's own
  cross-package difference, and inside 4.34e-4).

* The hybrid and audio layouts that raised before their port (a model
  axis, fsdp, a data axis of 2) run on a world of 4 ranks and answer a
  loss and prefill logits (``_torch_world.py:answer_case``; their parity
  is ``test_torch_{hybrid,encdec}_tp.py``'s); the ssm family names item
  12b-1b-2b and the moe family 12b-1c.

Each world (4 ranks, 2 ranks) runs once; every test reads its stored
results. The ranks' task is ``tests/_torch_world.py:tp_case``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.launch.world import run_world
from repro_torch.models import UNSHARDED, ShardingPolicy, get_model, make_policy
from repro_torch.models import common, transformer
from repro_torch.utils.trees import tree_flatten, tree_leaves, tree_unstack

sys.path.insert(0, str(Path(__file__).parent))
import _torch_world  # noqa: E402  (the ranks' tasks)

SRC = str(Path(__file__).resolve().parents[1] / "src")
_INIT_STREAM = 27
_DATA_STREAM = 2027
WORLD_TIMEOUT_S = 300
BATCH, SEQ, STEPS = 4, 16, 4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BAND_MARGIN = 2.0
LOSS_BAND = 4.34e-4

# name -> (arch, overrides, model axis, prompt tokens)
CASES = {
    "granite-m4": ("granite-8b", {}, 4, 12),
    "granite-m2": ("granite-8b", {}, 2, 12),
    "granite-kv2-length": ("granite-8b", {"n_kv_heads": 2}, 4, 12),
    "granite-kv2-hd": ("granite-8b", {"n_kv_heads": 2}, 4, 14),
    "granite-tied-remat": ("granite-8b", {"tie_embeddings": True,
                                          "remat": True}, 4, 12),
    "granite-replicated-attention": ("granite-8b", {"n_heads": 2,
                                                    "n_kv_heads": 2}, 4, 14),
    "llava-m4": ("llava-next-mistral-7b", {}, 4, 12),
    "llava-m2": ("llava-next-mistral-7b", {}, 2, 12),
}
# the cache layout each case's prefill must give: (T_local, Hkv_local, hd)
CACHE = {"granite-m4": (76, 1, 64), "granite-m2": (76, 2, 64),
         "granite-kv2-length": (19, 2, 64), "granite-kv2-hd": (78, 2, 16),
         "granite-tied-remat": (76, 1, 64),
         "granite-replicated-attention": (78, 2, 16),
         "llava-m4": (84, 1, 64), "llava-m2": (84, 2, 64)}
BF16_CASES = ("granite-m4", "granite-kv2-length", "llava-m4")
SEQS = (False, True)


def _cfg(name, dtype):
    arch, over, _, _ = CASES[name]
    return arch, dict(over, dtype=dtype)


def _inputs(name, dtype):
    """(params, batch, prompt, steps) of a case, numpy, from seeds."""
    arch, over = _cfg(name, dtype)
    cfg = get_config(arch).reduced().replace(**over)
    gen = torch.Generator().manual_seed(_INIT_STREAM)
    params = params_to_numpy(get_model(cfg).init(gen, "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, list(CASES).index(name)))
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    prompt = {"tokens": rng.integers(0, cfg.vocab_size,
                                     (BATCH, CASES[name][3])).astype(np.int32)}
    if cfg.family == "vlm":
        front = rng.standard_normal(
            (BATCH, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch["frontend"] = prompt["frontend"] = front
    steps = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    stream = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    return params, batch, prompt, steps, stream


def _unsharded(name, dtype):
    """The port's unsharded loss, grads and logits of a case."""
    arch, over = _cfg(name, dtype)
    params, batch, prompt, steps, stream = _inputs(name, dtype)
    cfg = get_config(arch).reduced().replace(**over)
    model = get_model(cfg)
    p = params_from_numpy(params, "cpu")
    leaves, rebuild = tree_flatten(p)
    live = [x.detach().requires_grad_() for x in leaves]
    loss, _ = model.loss_fn(rebuild(live), {k: torch.tensor(v)
                                            for k, v in batch.items()})
    grads = params_to_numpy(rebuild(list(torch.autograd.grad(loss, live))))
    with torch.no_grad():
        logits, state = model.prefill_fn(p, {k: torch.tensor(v)
                                             for k, v in prompt.items()})
        out = [logits.numpy()]
        for j in range(STEPS):
            logits, state = model.decode_fn(
                p, state, {"token": torch.tensor(steps[:, j:j + 1])})
            out.append(logits.numpy())
        layer = tree_unstack(p["layers"])[0]
        x = torch.tensor(stream)
        blocks = {"attention": transformer.attention_block(
            layer["attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps), cfg,
            UNSHARDED, torch.arange(SEQ), None).numpy(),
            "block": transformer.make_block_fn(cfg, UNSHARDED, None)(
                (x, torch.zeros(())), layer)[0][0].numpy()}
    return float(loss.detach()), grads, out, blocks


@pytest.fixture(scope="module")
def worlds():
    """Every case's ranks: a world of 4 (model axis 4) and one of 2."""
    out = {}
    for world in (4, 2):
        keys, tasks = [], []
        for name, (arch, over, m, _) in CASES.items():
            if m != world:
                continue
            dtypes = ("float32", "bfloat16") if name in BF16_CASES \
                else ("float32",)
            for dtype in dtypes:
                params, batch, prompt, steps, stream = _inputs(name, dtype)
                for seq in SEQS:
                    keys.append((name, dtype, seq))
                    tasks.append(("tp_case", dict(
                        dims=(1, m), cfg=_cfg(name, dtype), seq=seq,
                        params=params, batch=batch, prompt=prompt,
                        steps=steps, stream=stream)))
        per_rank = run_world(_torch_world.run_tasks, world, (tasks,),
                             timeout=WORLD_TIMEOUT_S)
        for j, key in enumerate(keys):
            out[key] = [r[j] for r in per_rank]
    return out


@pytest.fixture(scope="module")
def unsharded():
    return {name: _unsharded(name, "float32") for name in CASES}


# ---------------------------------------------------------------------------
# float32: the sharded path equals the unsharded one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", SEQS, ids=["seq-off", "seq-on"])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss_and_grads_equal_the_unsharded_path(worlds, unsharded,
                                                         name, seq):
    ranks = worlds[name, "float32", seq]
    want_loss, want_grads, _, _ = unsharded[name]
    for r in ranks:             # one replicated loss on every rank
        assert r["loss"] == ranks[0]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], want_loss, rtol=LOSS_RTOL)
    got = tree_leaves(ranks[0]["grads"])
    want = tree_leaves(want_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("seq", SEQS, ids=["seq-off", "seq-on"])
@pytest.mark.parametrize("name", list(CASES))
def test_norm_gradients_are_equal_on_every_rank(worlds, name, seq):
    """Under sequence parallelism each rank's norms see its own
    positions; their gradients must be summed over the ranks."""
    ranks = worlds[name, "float32", seq]
    for r in ranks[1:]:
        for k, g in r["norms"].items():
            np.testing.assert_array_equal(g, ranks[0]["norms"][k])


@pytest.mark.parametrize("seq", SEQS, ids=["seq-off", "seq-on"])
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_equal_the_unsharded_path(worlds, unsharded,
                                                     name, seq):
    ranks = worlds[name, "float32", seq]
    want = unsharded[name][2]
    for r in ranks:            # the logits are gathered to every rank
        assert len(r["logits"]) == STEPS + 1
        for got, w in zip(r["logits"], want, strict=True):
            np.testing.assert_allclose(got, w, **LOGIT_TOL)
    t, hkv, hd = CACHE[name]
    assert ranks[0]["cache"]["k"] == (2, BATCH, t, hkv, hd)
    assert ranks[0]["roundtrip"]


@pytest.mark.parametrize("seq", SEQS, ids=["seq-off", "seq-on"])
@pytest.mark.parametrize("name", list(CASES))
def test_attention_block_and_block_fn_equal_the_unsharded_ones(
        worlds, unsharded, name, seq):
    """The reference-shaped pieces on a rank (``policy`` in the
    reference's place): the stream in its layout, gathered back."""
    want = unsharded[name][3]
    for r in worlds[name, "float32", seq]:
        for k in ("attention", "block"):
            np.testing.assert_allclose(r["blocks"][k], want[k], **LOGIT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_are_counted_and_seq_par_scatters(worlds, name):
    off = worlds[name, "float32", False][0]["traffic"]
    on = worlds[name, "float32", True][0]["traffic"]
    assert off["all_reduce_sum"][0] > 0 and off["all_reduce_sum"][1] > 0
    assert "reduce_scatter" not in off
    # sequence parallelism turns the blocks' all-reduces into
    # reduce-scatter / all-gather pairs
    assert on["reduce_scatter"][0] > 0
    assert on["all_reduce_sum"][1] < off["all_reduce_sum"][1]


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

    for i, (arch, over, dims, seq) in enumerate(cases):
        cfg = get_config(arch).reduced().replace(**over)
        params = inp[f"params{i}"].item()
        batch = {k: jnp.asarray(v) for k, v in inp[f"batch{i}"].item().items()}
        prompt = {k: jnp.asarray(v)
                  for k, v in inp[f"prompt{i}"].item().items()}
        steps = inp[f"steps{i}"]
        runs = {"un": run(get_model(cfg), jax.tree.map(jnp.asarray, params),
                          batch, prompt, steps)}
        # Auto axes: jax 0.9's default axis types refuse the embedding
        # gather of the sharded loss
        mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        model = get_model(cfg, make_policy(mesh, seq_shard=seq))
        p = jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
            params, model.param_pspecs(),
            is_leaf=lambda x: isinstance(x, np.ndarray))
        runs["sh"] = run(model, p, batch, prompt, steps)
        for tag, (loss, grads, logits) in runs.items():
            out[f"{tag}{i}_loss"] = loss
            for j, g in enumerate(grads):
                out[f"{tag}{i}_g{j}"] = g
            for j, l in enumerate(logits):
                out[f"{tag}{i}_logits{j}"] = l
    np.savez(sys.argv[2], **out)
""")


def _bf16_keys():
    return [(name, seq) for name in BF16_CASES for seq in SEQS]


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's bf16 loss, grads and logits, unsharded and on a
    forged (1, M) mesh with ``Auto`` axes, for every bf16 case."""
    tmp = tmp_path_factory.mktemp("ref_tp")
    cases, arr = [], {}
    for i, (name, seq) in enumerate(_bf16_keys()):
        arch, over = _cfg(name, "bfloat16")
        cases.append((arch, over, (1, CASES[name][2]), seq))
        (arr[f"params{i}"], arr[f"batch{i}"], arr[f"prompt{i}"],
         arr[f"steps{i}"], _) = _inputs(name, "bfloat16")
    np.savez(tmp / "in.npz", cases=json.dumps(cases), **arr)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name,seq", _bf16_keys(),
                         ids=[f"{n}-seq-{'on' if s else 'off'}"
                              for n, s in _bf16_keys()])
def test_bf16_stays_inside_the_reference_sharded_band(worlds, ref_sharded,
                                                      name, seq):
    i = _bf16_keys().index((name, seq))
    ref = ref_sharded
    port = worlds[name, "bfloat16", seq][0]
    ref_gap = abs(ref[f"sh{i}_loss"] - ref[f"un{i}_loss"])
    gap = abs(port["loss"] - ref[f"sh{i}_loss"])
    assert gap <= BAND_MARGIN * max(ref_gap, LOSS_BAND), (gap, ref_gap)
    for j, g in enumerate(tree_leaves(port["grads"])):
        ref_gap = _rel_l2(ref[f"sh{i}_g{j}"], ref[f"un{i}_g{j}"])
        gap = _rel_l2(g, ref[f"sh{i}_g{j}"])
        assert gap <= BAND_MARGIN * ref_gap, (j, gap, ref_gap)
    for j, got in enumerate(port["logits"]):
        sh, un = ref[f"sh{i}_logits{j}"], ref[f"un{i}_logits{j}"]
        ref_gap = float(np.abs(sh - un).max())
        gap = float(np.abs(got - sh).max())
        assert gap <= BAND_MARGIN * ref_gap, (j, gap, ref_gap)


# ---------------------------------------------------------------------------
# what still raises (the dense and vlm families' fsdp and batch axes run:
# tests/test_torch_fsdp.py; the hybrid and audio families' layouts run
# here and in tests/test_torch_{hybrid,encdec}_tp.py)
# ---------------------------------------------------------------------------
def _mesh(dims):
    return DeviceMesh((torch.device("cpu"),) * int(np.prod(dims)),
                      ("data", "model"), dims)


# (arch, policy): the layouts of the hybrid and audio families that
# raised before they were ported; a (1, 4) mesh, "data-2" a (2, 2) one
PORTED = [("recurrentgemma-2b", "fsdp"), ("recurrentgemma-2b", "model"),
          ("seamless-m4t-large-v2", "model"),
          ("seamless-m4t-large-v2", "data-2")]


@pytest.fixture(scope="module")
def ported():
    """Each ported layout's loss and prefill on a world of 4 ranks."""
    tasks = [("answer_case", dict(
        dims=(2, 2) if policy == "data-2" else (1, 4), arch=arch,
        fsdp=policy == "fsdp", seq=policy == "seq")) for arch, policy in PORTED]
    per_rank = run_world(_torch_world.run_tasks, 4, (tasks,),
                         timeout=WORLD_TIMEOUT_S)
    return {key: [r[j] for r in per_rank] for j, key in enumerate(PORTED)}


@pytest.mark.parametrize("arch,policy", PORTED)
def test_ported_layouts_run_and_answer(ported, arch, policy):
    """The layouts that named item 12b-1b-2 run: the seeded init cut
    into each rank's shards, a finite loss (the same on every rank) and
    the prefill logits of the global batch, gathered to every rank."""
    ranks = ported[arch, policy]
    cfg = get_config(arch).reduced()
    for r in ranks:
        assert np.isfinite(r["loss"]) and r["loss"] == ranks[0]["loss"]
        assert r["logits"].shape == (2, 1, cfg.padded_vocab)
        assert np.isfinite(r["logits"]).all()
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    assert get_model(cfg, make_policy(
        _mesh((2, 2) if policy == "data-2" else (1, 4)),
        fsdp=policy == "fsdp")).param_pspecs()


@pytest.mark.parametrize("arch,policy,item", [
    ("granite-moe-1b-a400m", "model", "12b-1c"),
    ("granite-moe-1b-a400m", "fsdp", "12b-1c"),
    ("xlstm-1.3b", "seq", "12b-1b-2b"),
    ("xlstm-1.3b", "fsdp", "12b-1b-2b"),
])
def test_layouts_still_to_port_raise_and_name_their_item(arch, policy, item):
    dims = (2, 4) if policy == "data-2" else (1, 4)
    pol = make_policy(_mesh(dims), fsdp=policy == "fsdp",
                      seq_shard=policy == "seq")
    model = get_model(get_config(arch).reduced(), pol)
    for fn in (lambda: model.loss_fn(None, None),
               lambda: model.prefill_fn(None, None),
               lambda: model.init(None, "cpu")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()
    assert model.param_pspecs()        # the specs still answer
    ep2d = ShardingPolicy(mesh=_mesh((1, 4)), model_axis="model",
                          ep2d_axis="data")
    with pytest.raises(NotImplementedError, match="item 12b-1c"):
        get_model(get_config("granite-8b").reduced(), ep2d).loss_fn(None, None)


def test_federated_rounds_over_a_model_axis_name_their_item():
    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.optim import sgd
    # the dense, vlm, hybrid and audio families run it
    # (tests/test_torch_fl_tp.py, tests/test_torch_{hybrid,encdec}_tp.py);
    # the ssm family names its item
    model = get_model(get_config("xlstm-1.3b").reduced(),
                      make_policy(_mesh((2, 4))))
    fl = FLTrainStep(model, sgd(0.1), Hierarchy(1, 1, 1, n_clients=2),
                     np.arange(1))
    assert fl.stacked_param_pspecs()          # the specs answer
    with pytest.raises(NotImplementedError, match="item 12b-1b-2b"):
        fl.make_round_fn()
    with pytest.raises(NotImplementedError, match="item 12b-1b-2b"):
        fl.init_stacked(torch.Generator(), "cpu")
