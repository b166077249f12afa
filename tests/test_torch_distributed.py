"""The paper's aggregation tree across ranks, held to the reference.

* ``AggregationPlan`` equals the reference's field for field, exactly.
* ``hierarchical_psum`` / ``flat_psum`` over gloo ranks (spawned worlds,
  on the CPU) against the reference's under ``compat.shard_map`` on 8
  forged devices (a subprocess), on three layouts: a ``("data",)`` mesh
  of 8 with 8 clients, the same with 4 clients of 2 ranks each, and
  ``("pod", "data")`` = (2, 4). Exact on dyadic weights and small-integer
  inputs; within rtol 1e-6 on random float32.
* ``FLTrainStep``'s host path and rank path (hierarchical, flat, none;
  4 ranks, then 2-rank clients and a pod axis on 8) against the
  reference's host path, on reduced stablelm-1.6b with 1 layer (the
  reference's mesh test model) from the reference's initial params, at
  the reference's own tolerance, rtol 3e-4 / atol 3e-5. Float32 compute:
  at bfloat16 the two packages' local steps already part beyond it.
* ``shard_rows`` and the sharded pooled TPD against the reference's
  ``shard_rows`` (x64) and ``tpd_fast``: the pad path, ``pool_idx``,
  ndev 1, 3 and 8.

The JAX side runs once (one subprocess); each world runs once and every
test reads its stored results. No test starts a process group in the
pytest process: the ranks are spawned (``repro_torch.launch.world``),
and their tasks live in ``tests/_torch_world.py``, which imports no JAX.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.cost_model import CostModel as RefCostModel
from repro.core.hierarchy import ClientPool as RefClientPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.fl.aggregation import AggregationPlan as RefAggregationPlan
from repro.fl.distributed import FLTrainStep as RefFLTrainStep
from repro.models import get_model as ref_get_model
from repro.optim import sgd as ref_sgd
from repro_torch.configs import get_config
from repro_torch.core.cost_model import CostModel, PooledTPDEvaluator
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.fl.aggregation import AggregationPlan
from repro_torch.fl.distributed import FLTrainStep, choose_fl_hierarchy, shard_rows
from repro_torch.launch.mesh import (
    DeviceMesh,
    check_backend,
    make_production_mesh,
    mesh_chip_count,
    row_mesh,
)
from repro_torch.launch.world import run_world
from repro_torch.models import ShardingPolicy, get_model
from repro_torch.models.sharding import UNSHARDED, shard_hint
from repro_torch.optim import sgd
from repro_torch.utils.trees import (
    flat_buffer_of,
    flatten_tree,
    tree_layout,
    tree_map,
    unflatten_tree,
)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_world  # noqa: E402  (the ranks' tasks)

SRC = str(Path(__file__).resolve().parents[1] / "src")
_DATA_STREAM = 25
_PLACE_STREAM = 2025
N = 37                                   # elements a rank: a ragged width
RAND = dict(rtol=1e-6, atol=1e-7)
FL_TOL = dict(rtol=3e-4, atol=3e-5)      # the reference's own
FL_CFG = ("stablelm-1.6b", {"n_layers": 1, "dtype": "float32"})
FL_LR, FL_STEPS = 0.1, 2
H4 = (2, 1, 2, 4)                        # the reference's mesh-test tree
W4 = [0.1, 0.2, 0.3, 0.4]
WORLD_TIMEOUT_S = 240


def _tree_of(h):
    return (h.depth, h.width, h.trainers_per_leaf, h.total_clients)


def _placement(tree, seed):
    h = Hierarchy(*tree[:3], n_clients=tree[3])
    rng = np.random.default_rng((_PLACE_STREAM, seed))
    return rng.permutation(h.total_clients)[: h.dimensions].tolist()


def _psum_cases():
    """(dims, axes, tree, placement, weights, kind) of the psum tests:
    kind "int" (dyadic weights, small integers: exact) or "rand"."""
    t8 = _tree_of(choose_fl_hierarchy(8))
    dy8 = [1 / 4, 1 / 16, 1 / 16, 1 / 8, 1 / 8, 1 / 4, 1 / 16, 1 / 16]
    dy4 = [1 / 4, 1 / 8, 1 / 8, 1 / 2]
    dirichlet = np.random.default_rng((_DATA_STREAM, 1)).dirichlet
    return [
        ((8,), ("data",), t8, _placement(t8, 0), None, "int"),
        ((8,), ("data",), t8, _placement(t8, 1), dy8, "int"),
        ((8,), ("data",), t8, _placement(t8, 2),
         dirichlet(np.ones(8)).tolist(), "rand"),
        ((8,), ("data",), H4, _placement(H4, 3), dy4, "int"),
        ((8,), ("data",), H4, _placement(H4, 4),
         dirichlet(np.ones(4)).tolist(), "rand"),
        ((2, 4), ("pod", "data"), H4, _placement(H4, 5), None, "int"),
        ((2, 4), ("pod", "data"), H4, _placement(H4, 6),
         dirichlet(np.ones(4)).tolist(), "rand"),
    ]


PSUM_CASES = _psum_cases()
PSUM_IDS = [f"{'x'.join(map(str, c[0]))}-{c[2][3]}clients-{c[5]}-{i}"
            for i, c in enumerate(PSUM_CASES)]


def _psum_inputs(i, kind):
    rng = np.random.default_rng((_DATA_STREAM, 100 + i))
    if kind == "int":
        return rng.integers(-8, 8, (8, N)).astype(np.float32)
    return rng.standard_normal((8, N)).astype(np.float32)


# the TPD case of the reference's sharded test: 24 clients, 5 pools, 21
# rows (the pad path) routed by pool_idx
def _tpd_case(models_of):
    h = (3, 2, 2, 24)
    models = models_of(h)
    rng = np.random.default_rng((_DATA_STREAM, 7))
    ps = np.stack([rng.permutation(24)[:7] for _ in range(21)]).astype(
        np.int32)
    return models, ps, rng.integers(0, 5, size=21)


def _ref_models(h):
    hh = RefHierarchy(*h[:3], n_clients=h[3])
    return [RefCostModel(hh, RefClientPool.random(24, seed=s),
                         memory_penalty=0.3) for s in range(5)]


def _port_models(h):
    hh = Hierarchy(*h[:3], n_clients=h[3])
    return [CostModel(hh, ClientPool.random(24, seed=s), memory_penalty=0.3,
                      device="cpu") for s in range(5)]


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.cost_model import CostModel
    from repro.core.hierarchy import ClientPool, Hierarchy
    from repro.fl.aggregation import AggregationPlan, flat_psum, hierarchical_psum
    from repro.fl.distributed import shard_rows
    from repro.kernels import compat

    inp = np.load(sys.argv[1])
    cases = json.loads(str(inp["cases"]))
    out = {}
    for i, (dims, axes, tree, placement, weights) in enumerate(cases):
        mesh = jax.make_mesh(tuple(dims), tuple(axes))
        plan = AggregationPlan.build(
            Hierarchy(*tree[:3], n_clients=tree[3]), np.asarray(placement),
            mesh.shape["data"], weights)
        pod = "pod" if "pod" in axes else None
        spec = P(tuple(axes)) if len(axes) > 1 else P(axes[0])
        def body(v, plan=plan, pod=pod):
            return (hierarchical_psum(v[0], plan, "data", pod)[None],
                    flat_psum(v[0], plan, "data", pod)[None])

        run = jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec),
            axis_names=set(axes), check_vma=False))
        out[f"hier{i}"], out[f"flat{i}"] = map(
            np.asarray, run(jnp.asarray(inp[f"x{i}"])))

    jax.config.update("jax_enable_x64", True)
    h = Hierarchy(3, 2, 2, n_clients=24)
    models = [CostModel(h, ClientPool.random(24, seed=s), memory_penalty=0.3)
              for s in range(5)]
    attrs = np.stack([m._attr_stack(np.float64) for m in models], axis=1)
    fn = models[0]._make_batch_tpd(jnp, dtype=np.float64, pool_attrs=attrs)
    ps, idx = inp["ps"], inp["idx"]
    for nd in (1, 3, 8):
        mesh = jax.make_mesh((nd,), ("rows",))
        out[f"rows{nd}"] = np.asarray(shard_rows(fn, mesh, len(ps))(
            jnp.asarray(ps), jnp.asarray(idx)), np.float64)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """The reference's psums and shard_rows on 8 forged devices."""
    tmp = tmp_path_factory.mktemp("ref_mesh")
    _, ps, idx = _tpd_case(_ref_models)
    xs = {f"x{i}": _psum_inputs(i, c[5]) for i, c in enumerate(PSUM_CASES)}
    np.savez(tmp / "in.npz", cases=json.dumps([c[:5] for c in PSUM_CASES]),
             ps=ps, idx=idx, **xs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


# ---------------------------------------------------------------------------
# the reference's host path (the oracle of both port paths)
# ---------------------------------------------------------------------------
def _ref_round(tree, weights, mode, n_clients, seed=0):
    """(initial params, client-stacked batch, params after one round of
    the reference's host path: one tree a client)."""
    cfg = ref_get_config(FL_CFG[0]).reduced().replace(**FL_CFG[1])
    h = RefHierarchy(*tree[:3], n_clients=tree[3])
    fl = RefFLTrainStep(ref_get_model(cfg), ref_sgd(FL_LR), h,
                        np.arange(h.dimensions), weights=weights,
                        local_steps=FL_STEPS, mode=mode)
    params, opt = fl.init_stacked(jax.random.key(seed))
    rng = np.random.default_rng((_DATA_STREAM, 3))
    batch = {k: rng.integers(0, cfg.vocab_size, (n_clients, 2, 8)).astype(
        np.int32) for k in ("tokens", "labels")}
    new, _, metrics = jax.jit(fl.make_round_fn())(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    p0 = jax.tree.map(lambda x: np.asarray(x[0]), params)
    per_client = [jax.tree.map(lambda x, c=c: np.asarray(x[c]), new)
                  for c in range(n_clients)]
    return p0, batch, per_client, float(metrics["loss"])


# (tree, weights, mode, clients) of each reference round the tests read
REF_ROUNDS = {
    "h4": (H4, None, "hierarchical", 4),
    "h4-none": (H4, None, "none", 4),
    "h4-weighted": (H4, W4, "hierarchical", 4),
    "h8": (_tree_of(choose_fl_hierarchy(8)), None, "hierarchical", 8),
}


@pytest.fixture(scope="module")
def ref_rounds():
    return {k: _ref_round(*v) for k, v in REF_ROUNDS.items()}


def _fl_task(ref, dims, axes, tree, weights, mode):
    p0, batch = ref[0], ref[1]
    return ("fl_round", dict(
        dims=dims, axes=axes, cfg=FL_CFG, tree=tree, placement=np.arange(
            Hierarchy(*tree[:3], n_clients=tree[3]).dimensions),
        weights=weights, mode=mode, lr=FL_LR, local_steps=FL_STEPS,
        params=p0, batch=batch))


# rank-path rounds: (world, dims, axes, tree, weights, mode, ref round)
FL_RANK_CASES = {
    "4-ranks-hierarchical": (4, (4,), ("data",), H4, None, "hierarchical",
                             "h4"),
    "4-ranks-flat": (4, (4,), ("data",), H4, None, "flat", "h4"),
    "4-ranks-none": (4, (4,), ("data",), H4, None, "none", "h4-none"),
    "4-ranks-weighted": (4, (4,), ("data",), H4, W4, "hierarchical",
                         "h4-weighted"),
    "8-ranks-2-a-client": (8, (8,), ("data",), H4, None, "hierarchical",
                           "h4"),
    "8-ranks-pod-axis": (8, (2, 4), ("pod", "data"), H4, None,
                         "hierarchical", "h8"),
}


@pytest.fixture(scope="module")
def worlds(ref_rounds):
    """Each world once: 8 ranks (the psum layouts, 2-rank clients, the
    pod axis) and 4 ranks (the reference's mesh test, three modes)."""
    out = {}
    for world in (8, 4):
        names, tasks = [], []
        if world == 8:
            for i, c in enumerate(PSUM_CASES):
                names.append(("psum", i))
                tasks.append(("psum_case", dict(
                    dims=c[0], axes=c[1], tree=c[2], placement=c[3],
                    weights=c[4], x=_psum_inputs(i, c[5]))))
        for name, (w, dims, axes, tree, weights, mode, ref) in \
                FL_RANK_CASES.items():
            if w == world:
                names.append(("fl", name))
                tasks.append(_fl_task(ref_rounds[ref], dims, axes, tree,
                                      weights, mode))
        if world == 4:
            for perturb in (False, True):
                names.append(("replicas", perturb))
                tasks.append(("replica_check", dict(
                    dims=(4,), axes=("data",), cfg=FL_CFG, perturb=perturb)))
        per_rank = run_world(_torch_world.run_tasks, world, (tasks,),
                             timeout=WORLD_TIMEOUT_S)
        for j, key in enumerate(names):
            out[key] = [r[j] for r in per_rank]
    return out


# ---------------------------------------------------------------------------
# AggregationPlan
# ---------------------------------------------------------------------------
def _plan_cases():
    out = []
    for tree in ((2, 1, 2, 4), (2, 2, 1, 6), (2, 3, 3, 14), (3, 2, 1, 12),
                 _tree_of(choose_fl_hierarchy(16))):
        for seed in (0, 1):
            for per in (1, 2):
                for weights in (None, "given"):
                    out.append((tree, seed, per, weights))
    return out


@pytest.mark.parametrize("tree,seed,per,weights", _plan_cases())
def test_aggregation_plan_equals_the_reference(tree, seed, per, weights):
    placement = np.asarray(_placement(tree, seed))
    n_dev = tree[3] * per
    if weights == "given":
        weights = np.random.default_rng((_DATA_STREAM, seed)).dirichlet(
            np.ones(tree[3])).tolist()
    got = AggregationPlan.build(Hierarchy(*tree[:3], n_clients=tree[3]),
                                placement, n_dev, weights)
    want = RefAggregationPlan.build(
        RefHierarchy(*tree[:3], n_clients=tree[3]), placement, n_dev,
        weights)
    assert got.n_devices == want.n_devices
    for name in ("client_of_device", "weight_of_device", "root_rep_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.client_groups == want.client_groups
    assert len(got.levels) == len(want.levels)
    for (g, c, m), (rg, rc, rm) in zip(got.levels, want.levels, strict=True):
        assert g == rg
        assert c.dtype == rc.dtype and np.array_equal(c, rc)
        assert m.dtype == rm.dtype and np.array_equal(m, rm)


def test_aggregation_plan_refuses_a_ragged_data_axis():
    h = Hierarchy(2, 1, 2, n_clients=4)
    with pytest.raises(ValueError, match="multiple of the client count"):
        AggregationPlan.build(h, np.arange(2), 6)


# ---------------------------------------------------------------------------
# grouped psums over ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(PSUM_CASES)), ids=PSUM_IDS)
@pytest.mark.parametrize("which", ["hier", "flat"])
def test_psum_over_ranks_equals_the_reference(worlds, ref_mesh, i, which):
    want = ref_mesh[f"{which}{i}"]
    got = np.stack([r[which] for r in worlds["psum", i]])
    if PSUM_CASES[i][5] == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **RAND)
    for r in range(8):        # every rank holds the same global aggregate
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("i", range(len(PSUM_CASES)), ids=PSUM_IDS)
def test_singleton_groups_launch_no_collective(worlds, i):
    for steps in (r["steps"] for r in worlds["psum", i]):
        for name, ranks, moved in steps:
            assert (moved == 0) == (ranks == 1), (name, ranks, moved)
        assert steps[-1][0] == ("pod" if "pod" in PSUM_CASES[i][1]
                                else "root")


# ---------------------------------------------------------------------------
# FLTrainStep
# ---------------------------------------------------------------------------
def _assert_params_close(got, want, tol=FL_TOL):
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol)


def _port_host_round(ref, tree, weights, mode):
    cfg = get_config(FL_CFG[0]).reduced().replace(**FL_CFG[1])
    h = Hierarchy(*tree[:3], n_clients=tree[3])
    fl = FLTrainStep(get_model(cfg), sgd(FL_LR), h, np.arange(h.dimensions),
                     weights=weights, local_steps=FL_STEPS, mode=mode)
    p0 = params_from_numpy(ref[0], "cpu")
    layout = tree_layout(p0)
    stack = torch.empty((fl.n_clients_total, layout.numel))
    flatten_tree(p0, layout, out=stack[0])
    stack[1:] = stack[0]
    states = [fl.optimizer.init(None) for _ in range(fl.n_clients_total)]
    batch = {k: torch.tensor(v) for k, v in ref[1].items()}
    stats = []
    out, states, metrics = fl.make_round_fn()(
        unflatten_tree(stack, layout), states, batch, stats=stats)
    assert flat_buffer_of(out, lead=1).data_ptr() == stack.data_ptr()
    assert len(states) == fl.n_clients_total
    assert [s["step"] for s in stats] == (
        ["local steps"] + (["fedavg"] if mode != "none" else []))
    return out, float(metrics["loss"])


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("_one_thread")
@pytest.mark.parametrize("ref", ["h4", "h4-none", "h4-weighted"])
def test_host_path_equals_the_reference_host_path(ref_rounds, ref):
    tree, weights, mode, n = REF_ROUNDS[ref]
    out, loss = _port_host_round(ref_rounds[ref], tree, weights, mode)
    want = ref_rounds[ref][2]
    for c in range(n):
        _assert_params_close(params_to_numpy(
            tree_map(lambda x, c=c: x[c], out)), want[c])
    np.testing.assert_allclose(loss, ref_rounds[ref][3], rtol=1e-4)


@pytest.mark.parametrize("case", list(FL_RANK_CASES))
def test_rank_path_equals_the_reference_host_path(worlds, ref_rounds, case):
    world, dims, axes, tree, weights, mode, ref = FL_RANK_CASES[case]
    want = ref_rounds[ref][2]
    results = worlds["fl", case]
    for r in results:
        _assert_params_close(r["params"], want[r["client"]])
        np.testing.assert_allclose(r["loss"], ref_rounds[ref][3], rtol=1e-4)
        assert r["steps"][0] == "local steps"
        assert ("root" in r["steps"]) == (mode == "hierarchical")
        assert r["in_place"]     # the round kept the rank's param leaves
    # every client is some rank's; ranks of one client hold one model
    assert sorted({r["client"] for r in results}) == list(range(len(want)))


def test_rank_path_hierarchical_equals_flat(worlds):
    for a, b in zip(worlds["fl", "4-ranks-hierarchical"],
                    worlds["fl", "4-ranks-flat"], strict=True):
        _assert_params_close(a["params"], b["params"])


def test_init_stacked_checks_that_ranks_start_equal(worlds):
    same = worlds["replicas", False]
    assert all(v == same[0] for v in same)
    for err in worlds["replicas", True]:
        assert err is not None and "different params" in err


def test_host_init_stacked_stacks_one_init():
    cfg = get_config(FL_CFG[0]).reduced().replace(**FL_CFG[1])
    h = Hierarchy(*H4[:3], n_clients=H4[3])
    fl = FLTrainStep(get_model(cfg), sgd(FL_LR), h, np.arange(2))
    params, states = fl.init_stacked(torch.Generator().manual_seed(0), "cpu")
    stack = flat_buffer_of(params, lead=1)
    assert stack.shape[0] == 4 and len(states) == 4
    assert all(torch.equal(stack[c], stack[0]) for c in range(4))
    assert fl.client_axes is None and fl.ranks_per_client == 1
    with pytest.raises(ValueError, match="unknown mode"):
        FLTrainStep(get_model(cfg), sgd(FL_LR), h, np.arange(2), mode="ring")


# ---------------------------------------------------------------------------
# the mesh, the policy and the launcher
# ---------------------------------------------------------------------------
def test_replica_policy_runs_and_other_axes_name_item_12b():
    class _Mesh:
        shape = {"pod": 2, "data": 4}
        axis_names = ("pod", "data")

    replicas = ShardingPolicy(mesh=_Mesh())
    assert replicas.axis_size("data") == 4
    assert replicas.axis_size(("pod", "data")) == 8
    assert replicas.model_size == 1 and replicas.batch_size_divisor == 1
    x = torch.ones(2, 3)
    assert shard_hint(x, replicas, "batch", None) is x
    assert shard_hint(x, UNSHARDED, "model", None) is x
    model = get_model(get_config("paper-mlp-1m8"), replicas)
    assert model.policy is replicas
    # the MLP's rule replicates every param, so any axis runs it whole;
    # the families still to port name their item when run
    lm = get_config("xlstm-1.3b").reduced()
    for bad in (dict(model_axis="model"), dict(fsdp_axes=("data",)),
                dict(seq_axis="model"), dict(ep2d_axis="data")):
        policy = ShardingPolicy(mesh=_Mesh(), **bad)
        assert shard_hint(x, policy, "batch", None) is x
        assert get_model(get_config("paper-mlp-1m8"), policy).policy is policy
        with pytest.raises(NotImplementedError, match="item 12b"):
            get_model(lm, policy).loss_fn(None, None)
    batched = ShardingPolicy(mesh=_Mesh(), batch_axes=("data",))
    assert batched.dim("batch") == "data" and batched.dim("model") is None
    assert shard_hint(x, batched, "batch", None) is x


def test_production_mesh_needs_its_world_and_nccl_a_card_a_rank():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    check_backend("gloo", "cuda:0", 3, 4, cards=1)
    check_backend("nccl", "cuda:2", 2, 4, cards=4)
    for dev, cards in (("cuda:0", 1), ("cuda:0", 4), ("cpu", 4)):
        with pytest.raises(ValueError, match="nccl needs a card a rank"):
            check_backend("nccl", dev, 2, 4, cards=cards)
    mesh = row_mesh(3, "cpu")
    assert mesh.shape == {"rows": 3} and mesh_chip_count(mesh) == 3
    with pytest.raises(ValueError, match="do not fill"):
        DeviceMesh((torch.device("cpu"),) * 3, ("rows",), (4,))


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="unknown task"):
        run_world(_torch_world.run_tasks, 2, ([("no-such-task", {})],),
                  timeout=120)


# ---------------------------------------------------------------------------
# shard_rows and the sharded pooled TPD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_tpds_sharded_equals_the_reference_shard_rows(ref_mesh, ndev):
    models, ps, idx = _tpd_case(_port_models)
    ref_models, _, _ = _tpd_case(_ref_models)
    got = PooledTPDEvaluator(models).tpds_sharded(ps, pool_idx=idx,
                                                 ndev=ndev)
    np.testing.assert_allclose(got, ref_mesh[f"rows{ndev}"], rtol=1e-12)
    oracle = np.array([ref_models[i].tpd_fast(p) for i, p in zip(idx, ps)])
    # on the host the torch build is the numpy exact path op for op
    np.testing.assert_array_equal(got, oracle)
    on = PooledTPDEvaluator(models, shard="on").tpds(ps, pool_idx=idx)
    np.testing.assert_array_equal(on, oracle)


def test_shard_rows_pads_and_merges_segments():
    calls = []

    def fn(x, y):
        calls.append(x.shape[0])
        return (x * 2 + y).double()

    x = torch.arange(10)
    run = shard_rows(fn, row_mesh(4, "cpu"), 10)
    np.testing.assert_array_equal(run(x, x).numpy(), np.arange(10) * 3.0)
    assert calls == [3, 3, 3, 3]                 # 10 rows padded to 12
    with pytest.raises(ValueError, match="1-D"):
        shard_rows(fn, DeviceMesh((torch.device("cpu"),) * 2,
                                  ("pod", "rows"), (1, 2)), 4)


def test_sharded_auto_stays_on_numpy_without_cards():
    models, ps, idx = _tpd_case(_port_models)
    ev = PooledTPDEvaluator(models, shard="auto")
    assert ev._device_count() == 1
    np.testing.assert_array_equal(
        ev.tpds(ps, pool_idx=idx),
        PooledTPDEvaluator(models, shard="off").tpds(ps, pool_idx=idx))
    assert ev._shard_fn is None                 # the numpy path ran
