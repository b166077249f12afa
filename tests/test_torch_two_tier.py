"""The two-tier pod cost model and the pooled evaluator: port vs
reference.

``TwoTierCostModel``'s scalar ``tpd``, exact ``tpd_fast`` and float32
numpy ``batch_tpd`` are numpy in both packages and must be equal
exactly, duplicate-id rows and heterogeneous payloads included. The
port's torch build (the reference's jit build, written in torch) runs
on the CPU here: within rtol 2e-5 of the float64 scalar model, the
tolerance the reference holds its own float32 builds to. The CUDA TPD
kernel does not price pod edges: the gate never picks it for a
two-tier model and ``backend="kernel"`` is refused.
``PooledTPDEvaluator`` rows are bit-equal to each pool's own
``tpd_fast`` and to the reference's pooled rows, with pools mutated
between calls.
"""
import numpy as np
import pytest

from repro.core.cost_model import CostModel as RefCostModel
from repro.core.cost_model import PooledTPDEvaluator as RefPooled
from repro.core.cost_model import TwoTierCostModel as RefTwoTier
from repro.core.hierarchy import ClientPool as RefPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments import run_experiment as ref_run_experiment
from repro_torch.core.cost_model import CostModel, PooledTPDEvaluator, TwoTierCostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.experiments import EvalConfig, get_scenario, run_experiment

RTOL_F32 = 2e-5

# (depth, width, trainers_per_leaf, n_clients, pods, penalty)
TREES = [
    (3, 2, 2, 24, 2, 0.0),          # the two-tier preset's shape
    (4, 3, 2, 120, 5, 2.0),
    (5, 3, 2, 1024, 8, 1.5),
]


def _pair(depth, width, tpl, n, pods, penalty, seed=0):
    """The same two-tier model in both packages: heterogeneous
    payloads, random pods."""
    rng = np.random.default_rng(seed)
    ref_pool = RefPool.random(n, seed=seed)
    ref_pool.mdatasize = rng.uniform(1.0, 40.0, n)
    pool = ClientPool(memcap=ref_pool.memcap.copy(),
                      pspeed=ref_pool.pspeed.copy(),
                      mdatasize=ref_pool.mdatasize.copy())
    pod_of = rng.integers(0, pods, n)
    kw = dict(memory_penalty=penalty, pod_of=pod_of, ici_cost=0.005,
              dcn_cost=0.05)
    ref = RefTwoTier(RefHierarchy(depth=depth, width=width,
                                  trainers_per_leaf=tpl, n_clients=n),
                     ref_pool, **kw)
    port = TwoTierCostModel(Hierarchy(depth=depth, width=width,
                                      trainers_per_leaf=tpl, n_clients=n),
                            pool, device="cpu", **kw)
    return ref, port


def _placements(h, n, seed=1, duplicates=True):
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.permutation(h.total_clients)[:h.dimensions]
                   for _ in range(n)])
    if duplicates:
        ps[0, -1] = ps[0, 0]                 # a duplicate id
        ps[1, 1:] = ps[1, 0]                 # one host everywhere
    return ps


@pytest.mark.parametrize("tree", TREES, ids=[f"C{t[3]}" for t in TREES])
def test_two_tier_numpy_paths_equal_reference(tree):
    ref, port = _pair(*tree)
    ps = _placements(port.hierarchy, 12)
    for p in ps:
        assert port.tpd(p) == ref.tpd(p)
        assert port.tpd_fast(p) == ref.tpd_fast(p)
    got = port.batch_tpd(ps, backend="np")
    want = ref.batch_tpd(ps, backend="np")
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("tree", TREES, ids=[f"C{t[3]}" for t in TREES])
def test_two_tier_torch_build_within_f32_of_scalar(tree):
    ref, port = _pair(*tree)
    ps = _placements(port.hierarchy, 40)
    scalar = np.array([port.tpd(p) for p in ps])
    got = port.batch_tpd(ps, backend="torch")
    np.testing.assert_allclose(got, scalar, rtol=RTOL_F32)
    np.testing.assert_allclose(got, ref.batch_tpd(ps, backend="np"),
                               rtol=RTOL_F32)
    # auto-selection on the CPU: numpy below the threshold, the torch
    # build above it (40 particles x 1024 clients)
    assert np.array_equal(port.batch_tpd(ps[:1]),
                          port.batch_tpd(ps[:1], backend="np"))
    if 40 * port.hierarchy.total_clients > port._NP_FASTPATH_ELEMS:
        assert np.array_equal(port.batch_tpd(ps), got)


def test_two_tier_kernel_gate():
    _, port = _pair(*TREES[0])
    assert not port._kernel_ok()
    ps = _placements(port.hierarchy, 4)
    with pytest.raises(ValueError, match="pod"):
        port.batch_tpd(ps, backend="kernel")
    port.set_default_backend("kernel")
    with pytest.raises(ValueError, match="pod"):
        port.batch_tpd(ps)
    # the base model on the CPU is no kernel case either
    base = CostModel(port.hierarchy, port.clients, device="cpu")
    assert not base._kernel_ok()


def test_two_tier_retarget_refuses_a_pool_resize():
    _, port = _pair(*TREES[0])
    port.clients.join(memcap=np.full(4, 64.0), pspeed=np.ones(4))
    grown = Hierarchy(depth=3, width=2, trainers_per_leaf=2,
                      n_clients=len(port.clients))
    with pytest.raises(ValueError, match="two-tier"):
        port.retarget(grown)


@pytest.mark.parametrize("tree", TREES[:2], ids=["C24", "C120"])
def test_cross_pod_edges_match_reference_and_oracle(tree):
    ref, port = _pair(*tree)
    for p in _placements(port.hierarchy, 25, seed=2):
        got = port.cross_pod_edges(p)
        assert got == ref.cross_pod_edges(p)
        assert got == port._cross_pod_edges_ref(p)
    podless = TwoTierCostModel(port.hierarchy, port.clients, device="cpu")
    p = _placements(port.hierarchy, 1, duplicates=False)[0]
    assert podless.cross_pod_edges(p) == podless._cross_pod_edges_ref(p)


def test_two_tier_preset_equals_reference():
    """The registered preset through run_experiment (batched lockstep by
    default, and the sequential loop): placements, TPDs, artifact."""
    ref = ref_run_experiment("two-tier", ["pso", "random"], rounds=40,
                             seeds=(0, 1), progress=False)
    for mode in ("batched", "sequential"):
        port = run_experiment("two-tier", ["pso", "random"], rounds=40,
                              seeds=(0, 1), progress=False, device="cpu",
                              eval_config=EvalConfig(mode=mode))
        assert port.to_dict() == ref.to_dict()
    env = get_scenario("two-tier").make_environment(0, device="cpu")
    assert isinstance(env.cost_model, TwoTierCostModel)
    ref_env = ref_get_scenario("two-tier").make_environment(0)
    assert np.array_equal(env.cost_model.pod_of, ref_env.cost_model.pod_of)
    for r in range(6):
        p = _placements(env.hierarchy, 1, seed=r, duplicates=False)[0]
        assert env.step(r, p).tpd == ref_env.step(r, p).tpd


def _pools(n, k, seed):
    rng = np.random.default_rng(seed)
    pools, ref_pools = [], []
    for s in range(k):
        rp = RefPool.random(n, seed=seed + s)
        rp.mdatasize = rng.uniform(1.0, 40.0, n)
        ref_pools.append(rp)
        pools.append(ClientPool(memcap=rp.memcap.copy(),
                                pspeed=rp.pspeed.copy(),
                                mdatasize=rp.mdatasize.copy()))
    return pools, ref_pools


@pytest.mark.parametrize("two_tier", [False, True], ids=["base", "pods"])
def test_pooled_evaluator_rows_bit_equal_under_drift(two_tier):
    shape = dict(depth=4, width=3, trainers_per_leaf=2, n_clients=256)
    h, rh = Hierarchy(**shape), RefHierarchy(**shape)
    pools, ref_pools = _pools(256, 3, seed=5)
    kw = dict(memory_penalty=1.5)
    if two_tier:
        kw["pod_of"] = np.arange(256) * 4 // 256
        port_models = [TwoTierCostModel(h, p, device="cpu", **kw)
                       for p in pools]
        ref_models = [RefTwoTier(rh, p, **kw) for p in ref_pools]
    else:
        port_models = [CostModel(h, p, device="cpu", **kw) for p in pools]
        ref_models = [RefCostModel(rh, p, **kw) for p in ref_pools]
    ev, ref_ev = PooledTPDEvaluator(port_models, shard="off"), \
        RefPooled(ref_models, shard="off")
    ps = _placements(h, 3, seed=3)
    got = ev.tpds(ps)
    assert np.array_equal(got, ref_ev.tpds(ps))
    for s in range(3):
        assert got[s] == port_models[s].tpd_fast(ps[s])
    # drift one pool in place between calls; map rows to pools
    factor = np.random.default_rng(11).uniform(0.5, 2.0, 256)
    for pool in (pools[1], ref_pools[1]):
        pool.pspeed[:] = pool.pspeed * factor
        pool.touch()
    idx = np.array([0, 1, 2, 1, 1, 0])
    rows = np.concatenate([ps, ps])
    got2 = ev.tpds(rows, pool_idx=idx)
    assert np.array_equal(got2, ref_ev.tpds(rows, pool_idx=idx))
    for i, s in enumerate(idx):
        assert got2[i] == port_models[s].tpd_fast(rows[i])
    assert got2[1] != got[1]


def test_pooled_evaluator_rejects_mismatched_models():
    h = Hierarchy(depth=3, width=2, trainers_per_leaf=2)
    h2 = Hierarchy(depth=3, width=2, trainers_per_leaf=3)
    pool = ClientPool.random(h.total_clients, seed=0)
    pool2 = ClientPool.random(h2.total_clients, seed=0)
    with pytest.raises(ValueError, match="hierarchy"):
        PooledTPDEvaluator([CostModel(h, pool, device="cpu"),
                            CostModel(h2, pool2, device="cpu")])
    with pytest.raises(ValueError, match="penalty"):
        PooledTPDEvaluator([CostModel(h, pool, device="cpu"),
                            CostModel(h, pool, memory_penalty=2.0,
                                      device="cpu")])
    with pytest.raises(ValueError, match="type"):
        PooledTPDEvaluator([CostModel(h, pool, device="cpu"),
                            TwoTierCostModel(h, pool, device="cpu")])
    with pytest.raises(ValueError, match="pod"):
        PooledTPDEvaluator([
            TwoTierCostModel(h, pool, device="cpu",
                             pod_of=np.zeros(h.total_clients, int)),
            TwoTierCostModel(h, pool, device="cpu",
                             pod_of=np.ones(h.total_clients, int))])
    with pytest.raises(ValueError, match="shard"):
        PooledTPDEvaluator([CostModel(h, pool, device="cpu")],
                           shard="maybe")
    with pytest.raises(ValueError, match="at least one"):
        PooledTPDEvaluator([])
