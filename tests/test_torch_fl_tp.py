"""Federated rounds of tensor-parallel clients (the reference's
``_fl_train_bundle``): each client is the model-axis group at one data
coordinate of a ``("data", "model")`` mesh, and the paper's aggregation
tree runs over the data axis at each model coordinate.

* Float32 compute, reduced granite-8b, one local SGD step: on (4, 2)
  (4 clients of 2 ranks; a depth-2 tree, ``Hierarchy(2, 1, 1,
  n_clients=4)`` at placement [2, 0], and ``choose_fl_hierarchy(4)``)
  and on (2, 2) (2 clients), hierarchical and flat, sequence
  parallelism off and on: the round's params, gathered over the model
  axis, equal the port's host path (``FLTrainStep`` without a mesh,
  every client on one device) at ``test_torch_distributed.py``'s
  tolerance, rtol 3e-4 /
  atol 3e-5, and so does the loss; every rank's shards are bit-equal
  along the data axis; ``init_stacked`` draws the one seeded init on
  every rank and keeps its shards.
* bf16 compute (the config's own): the reference's sharded round on a
  forged (4, 2) or (2, 2) ``Auto`` mesh (a subprocess, 8 host devices)
  and its host round. The port's round update (after minus before) a
  leaf is within BAND_MARGIN (2) times the reference's own gap between
  its sharded and host updates of the reference's sharded update, or
  within the port's own float32 update's gap (the bf16 rounding of
  the step), whichever is larger.
* Reduced recurrentgemma-2b and seamless-m4t-large-v2 run a round of 2
  tensor-parallel clients on (2, 2) and answer (their parity with the
  host path is ``test_torch_{hybrid,encdec}_tp.py``'s); the xlstm
  family raises naming item 12b-1b-2b, the moe family 12b-1c; a policy
  with batch or fsdp axes is refused.

Two worlds (8 ranks, 4 ranks) run once each; the ranks' task is
``tests/_torch_world.py:fl_tp_round``.
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
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.state import params_to_numpy
from repro_torch.fl.distributed import FLTrainStep, choose_fl_hierarchy
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.launch.world import run_world
from repro_torch.models import ShardingPolicy, get_model, make_policy
from repro_torch.optim import sgd
from repro_torch.utils.trees import tree_leaves, tree_map

sys.path.insert(0, str(Path(__file__).parent))
import _torch_world  # noqa: E402  (the ranks' tasks)

SRC = str(Path(__file__).resolve().parents[1] / "src")
_INIT_STREAM = 281
_DATA_STREAM = 2281
WORLD_TIMEOUT_S = 300
ARCH = "granite-8b"
LR, LOCAL_STEPS, ROWS, SEQ = 0.05, 1, 2, 16
FL_TOL = dict(rtol=3e-4, atol=3e-5)      # the reference's own
BAND_MARGIN = 2.0


def _tree(h):
    return (h.depth, h.width, h.trainers_per_leaf, h.n_clients)


DEPTH2 = ((2, 1, 1, 4), [2, 0])
CHOSEN = (_tree(choose_fl_hierarchy(4)), [0])
PAIR = (_tree(choose_fl_hierarchy(2)), [0])
# name -> (dims, (tree, placement), mode, seq)
CASES = {
    "4x2-depth2-hierarchical-seq-off": ((4, 2), DEPTH2, "hierarchical", False),
    "4x2-depth2-hierarchical-seq-on": ((4, 2), DEPTH2, "hierarchical", True),
    "4x2-depth2-flat-seq-on": ((4, 2), DEPTH2, "flat", True),
    "4x2-chosen-hierarchical-seq-off": ((4, 2), CHOSEN, "hierarchical", False),
    "2x2-hierarchical-seq-off": ((2, 2), PAIR, "hierarchical", False),
    "2x2-hierarchical-seq-on": ((2, 2), PAIR, "hierarchical", True),
    "2x2-flat-seq-off": ((2, 2), PAIR, "flat", False),
}
BF16_CASES = ("4x2-depth2-hierarchical-seq-on", "2x2-flat-seq-off")


def _cfg(dtype):
    return get_config(ARCH).reduced().replace(dtype=dtype)


def _inputs(dtype, n_clients):
    """(initial params, client-stacked batch), numpy, from seeds."""
    cfg = _cfg(dtype)
    gen = torch.Generator().manual_seed(_INIT_STREAM)
    params = params_to_numpy(get_model(cfg).init(gen, "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, n_clients))
    toks = rng.integers(0, cfg.vocab_size,
                        (n_clients, ROWS, SEQ + 1)).astype(np.int32)
    return params, {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _host_round(dtype, tree, placement, mode, n_clients):
    """The port's host path: (params after the round, loss)."""
    from repro_torch.core.state import params_from_numpy
    params, batch = _inputs(dtype, n_clients)
    fl = FLTrainStep(get_model(_cfg(dtype)), sgd(LR),
                     Hierarchy(*tree[:3], n_clients=tree[3]), placement,
                     local_steps=LOCAL_STEPS, mode=mode)
    one = params_from_numpy(params, "cpu")
    stacked = tree_map(lambda x: x.expand((n_clients,) + x.shape).clone(),
                       one)
    states = [fl.optimizer.init(one) for _ in range(n_clients)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        new, _, metrics = fl.make_round_fn()(
            stacked, states, {k: torch.tensor(v) for k, v in batch.items()})
    finally:
        torch.set_num_threads(n)
    return (tree_map(lambda x: x[0].detach().numpy().copy(), new),
            float(metrics["loss"]))


OTHER_FAMILIES = ("recurrentgemma-2b", "seamless-m4t-large-v2")


def _family_inputs(arch):
    """A reduced family's seeded init and a 2-client batch, numpy."""
    cfg = get_config(arch).reduced()
    params = params_to_numpy(get_model(cfg).init(
        torch.Generator().manual_seed(_INIT_STREAM), "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, len(arch)))
    toks = rng.integers(0, cfg.vocab_size, (2, ROWS, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "audio":
        batch["frontend"] = rng.standard_normal(
            (2, ROWS, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return params, batch


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for world in (8, 4):
        keys, tasks = [], []
        for arch in OTHER_FAMILIES if world == 4 else ():
            params, batch = _family_inputs(arch)
            keys.append((arch, "float32"))
            tasks.append(("fl_tp_round", dict(
                dims=(2, 2), cfg=(arch, {"dtype": "float32"}), seq=True,
                tree=PAIR[0], placement=PAIR[1], mode="hierarchical", lr=LR,
                local_steps=LOCAL_STEPS, params=params, batch=batch)))
        for name, (dims, (tree, placement), mode, seq) in CASES.items():
            if dims[0] * dims[1] != world:
                continue
            dtypes = ("float32", "bfloat16") if name in BF16_CASES \
                else ("float32",)
            for dtype in dtypes:
                params, batch = _inputs(dtype, dims[0])
                keys.append((name, dtype))
                tasks.append(("fl_tp_round", dict(
                    dims=dims, cfg=(ARCH, {"dtype": dtype}), seq=seq,
                    tree=tree, placement=placement, mode=mode, lr=LR,
                    local_steps=LOCAL_STEPS, params=params, batch=batch)))
        per_rank = run_world(_torch_world.run_tasks, world, (tasks,),
                             timeout=WORLD_TIMEOUT_S)
        for j, key in enumerate(keys):
            out[key] = [r[j] for r in per_rank]
    return out


@pytest.fixture(scope="module")
def host_rounds():
    out = {}
    for name, (dims, (tree, placement), mode, _) in CASES.items():
        for dtype in ("float32", "bfloat16") if name in BF16_CASES \
                else ("float32",):
            out[name, dtype] = _host_round(dtype, tree, placement, mode,
                                           dims[0])
    return out


# ---------------------------------------------------------------------------
# float32: the rank path equals the host path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_round_of_tensor_parallel_clients_equals_the_host_path(
        worlds, host_rounds, name):
    ranks = worlds[name, "float32"]
    want, want_loss = host_rounds[name, "float32"]
    np.testing.assert_allclose(ranks[0]["loss"], want_loss, **FL_TOL)
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        assert r["steps"][0] == "local steps"
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(want),
                        strict=True):
            np.testing.assert_allclose(a, b, **FL_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_every_shard_of_the_aggregate_is_equal_along_the_data_axis(worlds,
                                                                   name):
    ranks = worlds[name, "float32"]
    dims = CASES[name][0]
    assert sorted({r["client"] for r in ranks}) == list(range(dims[0]))
    for r in ranks:
        first = next(q for q in ranks if q["model"] == r["model"])
        for a, b in zip(tree_leaves(r["local"]), tree_leaves(first["local"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)


def test_init_stacked_keeps_each_rank_its_shards_of_one_init(worlds):
    got = worlds["4x2-depth2-hierarchical-seq-off", "float32"][0]["init"]
    want = params_to_numpy(get_model(_cfg("float32")).init(
        torch.Generator().manual_seed(0), "cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# bf16: inside the reference's own sharded band
# ---------------------------------------------------------------------------
REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.core.hierarchy import Hierarchy
    from repro.fl.distributed import FLTrainStep
    from repro.models import get_model
    from repro.models.sharding import ShardingPolicy
    from repro.optim import sgd

    inp = np.load(sys.argv[1], allow_pickle=True)
    cases = json.loads(str(inp["cases"]))
    lr, local_steps = float(inp["lr"]), int(inp["local_steps"])
    out = {}
    for i, (arch, dims, seq, tree, placement, mode) in enumerate(cases):
        cfg = get_config(arch).reduced().replace(dtype="bfloat16")
        params = inp[f"params{i}"].item()
        batch = {k: jnp.asarray(v) for k, v in inp[f"batch{i}"].item().items()}
        h = Hierarchy(*tree[:3], n_clients=tree[3])
        n = dims[0]
        for tag in ("un", "sh"):
            if tag == "un":
                mesh, model = None, get_model(cfg)
            else:
                mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2)
                model = get_model(cfg, ShardingPolicy(
                    mesh=mesh, batch_axes=None, model_axis="model",
                    fsdp_axes=None, seq_axis="model" if seq else None))
            fl = FLTrainStep(model, sgd(lr), h, np.asarray(placement),
                             local_steps=local_steps, mode=mode)
            stacked = jax.tree.map(
                lambda x: jnp.broadcast_to(jnp.asarray(x), (n,) + x.shape),
                params, is_leaf=lambda x: isinstance(x, np.ndarray))
            opt = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                               fl.optimizer.init(jax.tree.map(
                                   jnp.asarray, params,
                                   is_leaf=lambda x: isinstance(
                                       x, np.ndarray))))
            b = batch
            if mesh is not None:
                stacked = jax.tree.map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                    stacked, fl.stacked_param_pspecs())
                b = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                     for k, v in batch.items()}
            new, _, metrics = jax.jit(fl.make_round_fn())(stacked, opt, b)
            for j, x in enumerate(jax.tree.leaves(new)):
                out[f"{tag}{i}_p{j}"] = np.asarray(x[0], np.float32)
            out[f"{tag}{i}_loss"] = float(metrics["loss"])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def ref_rounds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_fl_tp")
    cases, arr = [], {}
    for i, name in enumerate(BF16_CASES):
        dims, (tree, placement), mode, seq = CASES[name]
        cases.append((ARCH, dims, seq, tree, placement, mode))
        arr[f"params{i}"], arr[f"batch{i}"] = _inputs("bfloat16", dims[0])
    np.savez(tmp / "in.npz", cases=json.dumps(cases), lr=LR,
             local_steps=LOCAL_STEPS, **arr)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_round_update_stays_inside_the_reference_band(
        worlds, ref_rounds, name):
    i = BF16_CASES.index(name)
    ref = ref_rounds
    dims = CASES[name][0]
    p0 = tree_leaves(_inputs("bfloat16", dims[0])[0])
    port = tree_leaves(worlds[name, "bfloat16"][0]["params"])
    port32 = tree_leaves(worlds[name, "float32"][0]["params"])
    for j, (got, got32, p) in enumerate(zip(port, port32, p0, strict=True)):
        sh, un = ref[f"sh{i}_p{j}"] - p, ref[f"un{i}_p{j}"] - p
        band = max(_rel(sh, un), _rel(got32 - p, sh))
        gap = _rel(got - p, sh)
        assert gap <= BAND_MARGIN * band, (j, gap, band)


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------
def _mesh(dims):
    return DeviceMesh((torch.device("cpu"),) * int(np.prod(dims)),
                      ("data", "model"), dims)


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_hybrid_and_audio_rounds_over_a_model_axis_answer(worlds, arch):
    ranks = worlds[arch, "float32"]
    assert sorted({r["client"] for r in ranks}) == [0, 1]
    p0 = tree_leaves(_family_inputs(arch)[0])
    for r in ranks:
        assert np.isfinite(r["loss"]) and r["loss"] == ranks[0]["loss"]
        assert r["steps"][0] == "local steps"
        moved = [np.abs(a - b).max(initial=0.0) for a, b in zip(
            tree_leaves(r["params"]), p0, strict=True)]
        assert max(moved) > 0 and all(np.isfinite(moved))
        first = next(q for q in ranks if q["model"] == r["model"])
        for a, b in zip(tree_leaves(r["local"]), tree_leaves(first["local"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,item", [
    ("xlstm-1.3b", "12b-1b-2b"), ("granite-moe-1b-a400m", "12b-1c"),
])
def test_other_families_over_a_model_axis_name_their_item(arch, item):
    policy = ShardingPolicy(mesh=_mesh((2, 2)), model_axis="model")
    fl = FLTrainStep(get_model(get_config(arch).reduced(), policy), sgd(0.1),
                     Hierarchy(1, 1, 1, n_clients=2), np.arange(1))
    assert fl.stacked_param_pspecs()          # the specs answer
    for fn in (fl.make_round_fn,
               lambda: fl.init_stacked(torch.Generator(), "cpu")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fn()


@pytest.mark.parametrize("fsdp", [False, True])
def test_batch_or_fsdp_axes_split_no_client(fsdp):
    # make_policy's batch axes (and its fsdp axes) would split a client
    fl = FLTrainStep(get_model(_cfg("bfloat16"),
                               make_policy(_mesh((2, 2)), fsdp=fsdp)),
                     sgd(0.1), Hierarchy(1, 1, 1, n_clients=2), np.arange(1))
    with pytest.raises(ValueError, match="batch_axes=None"):
        fl.make_round_fn()
