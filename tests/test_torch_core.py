"""Port vs reference: hierarchy, pools, ladders, Flag-Swap PSO, state
carry-over and the ten placement strategies (all numpy, so exact)."""
import json

import numpy as np
import pytest

from repro.core import create_strategy as ref_create_strategy
from repro.core.cost_model import CostModel as RefCostModel
from repro.core.hierarchy import ClientPool as RefClientPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.core.hierarchy import rows_with_duplicates as ref_rows_with_duplicates
from repro.core.hierarchy import slot_remap as ref_slot_remap
from repro.core.pso import FlagSwapPSO as RefPSO
from repro.fl.distributed import choose_fl_hierarchy as ref_choose
from repro.fl.distributed import elastic_rehierarchize as ref_elastic
from repro_torch.core import CostModel, create_strategy, strategy_names
from repro_torch.core.hierarchy import ClientPool, Hierarchy, rows_with_duplicates, slot_remap
from repro_torch.core.pso import FlagSwapPSO
from repro_torch.core.state import pool_from_numpy, swarm_from_state
from repro_torch.fl.distributed import choose_fl_hierarchy, elastic_rehierarchize

SHAPES = [(1, 1, 1, None), (2, 2, 1, None), (3, 4, 2, None),
          (4, 3, 2, 120), (5, 2, 3, None), (6, 3, 2, 1024)]


def _placements(n_clients, n_slots, P, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n_clients)[:n_slots] for _ in range(P)])


@pytest.mark.parametrize("depth,width,tpl,n", SHAPES)
def test_hierarchy_tables_match_reference(depth, width, tpl, n):
    ref = RefHierarchy(depth, width, tpl, n)
    port = Hierarchy(depth, width, tpl, n)
    for name in ("dimensions", "n_leaves", "min_clients", "max_clients",
                 "total_clients", "level_starts", "leaf_slots"):
        assert getattr(port, name) == getattr(ref, name), name
    assert np.array_equal(port.levels, ref.levels)
    assert port.levels.dtype == ref.levels.dtype
    assert np.array_equal(port.kids_table, ref.kids_table)
    for p in _placements(ref.total_clients, ref.dimensions, 3, seed=depth):
        assert port.children_clients(p) == ref.children_clients(p)
        assert port.clusters(p) == ref.clusters(p)
        for a, b in zip(port.round_plan(p).levels, ref.round_plan(p).levels,
                        strict=True):
            assert np.array_equal(a.src, b.src)
            assert np.array_equal(a.member_clients, b.member_clients)


def test_slot_remap_and_duplicate_rows_match_reference():
    for (d0, w0), (d1, w1) in [((2, 2), (3, 2)), ((4, 3), (3, 4)),
                               ((3, 4), (2, 2)), ((6, 4), (5, 3))]:
        got = slot_remap(Hierarchy(d0, w0), Hierarchy(d1, w1))
        want = ref_slot_remap(RefHierarchy(d0, w0), RefHierarchy(d1, w1))
        assert np.array_equal(got, want) and got.dtype == want.dtype
    rows = np.random.default_rng(3).integers(0, 12, (40, 6))
    assert np.array_equal(rows_with_duplicates(rows),
                          ref_rows_with_duplicates(rows))


@pytest.mark.parametrize("n,seed,mds", [(10, 0, 5.0), (341, 7, 5.0),
                                        (10000, 0, 5.0), (64, 3, 2.5)])
def test_client_pool_random_matches_reference(n, seed, mds):
    port = ClientPool.random(n, seed=seed, mdatasize=mds)
    ref = RefClientPool.random(n, seed=seed, mdatasize=mds)
    for name in ("memcap", "pspeed", "mdatasize"):
        assert np.array_equal(getattr(port, name), getattr(ref, name))


def test_pool_from_numpy_copies_reference_pool():
    ref = RefClientPool.random(50, seed=4)
    port = pool_from_numpy(ref.memcap, ref.pspeed, ref.mdatasize)
    assert np.array_equal(port.pspeed, ref.pspeed)
    port.pspeed[0] = -1.0
    assert ref.pspeed[0] != -1.0


def test_pool_resizes_match_reference():
    port, ref = ClientPool.random(20, seed=1), RefClientPool.random(20, seed=1)
    for pool in (port, ref):
        pool.join([11.0, 12.0], [6.0, 7.0])
        pool.leave([0, 5, 21])
        pool.join([30.0], [8.0], mdatasize=4.0)
    a, b = port.drain_resizes(), ref.drain_resizes()
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    for name in ("memcap", "pspeed", "mdatasize"):
        assert np.array_equal(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("scale", [False, True])
def test_choose_fl_hierarchy_ladder_matches_reference(scale):
    for n in list(range(1, 80)) + [255, 341, 1000, 1024, 4096, 10000, 20000]:
        got, want = choose_fl_hierarchy(n, scale=scale), ref_choose(n, scale=scale)
        assert (got.depth, got.width, got.trainers_per_leaf, got.n_clients) == \
            (want.depth, want.width, want.trainers_per_leaf, want.n_clients)


def test_elastic_rehierarchize_sequence_matches_reference():
    walk = [12, 18, 24, 30, 36, 42, 54, 40, 25, 14, 11, 60, 200, 90, 1500]
    port_h, ref_h = Hierarchy(2, 2, 4, 12), RefHierarchy(2, 2, 4, 12)
    port_cap = ref_cap = max(port_h.max_clients, 12)
    for n in walk:
        port_h, port_cap = elastic_rehierarchize(port_h, n, port_cap)
        ref_h, ref_cap = ref_elastic(ref_h, n, ref_cap)
        assert port_cap == ref_cap
        assert (port_h.depth, port_h.width, port_h.trainers_per_leaf,
                port_h.n_clients) == (ref_h.depth, ref_h.width,
                                      ref_h.trainers_per_leaf, ref_h.n_clients)


def _assert_same_swarm(port, ref):
    for name in ("x", "v", "pbest_x", "pbest_f", "gbest_x"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert port.gbest_f == ref.gbest_f
    assert port.evaluations == ref.evaluations
    assert port.history.best == ref.history.best
    assert port.history.worst == ref.history.worst
    assert port.history.mean == ref.history.mean
    assert len(port.history.per_particle) == len(ref.history.per_particle)
    for a, b in zip(port.history.per_particle, ref.history.per_particle,
                    strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(port.best_placement, ref.best_placement)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def _fitness(depth, width, n, seed):
    h = RefHierarchy(depth, width, 2, n)
    cm = RefCostModel(h, RefClientPool.random(n, seed=seed))
    return h, cm


@pytest.mark.parametrize("depth,width,n,P,seed", [(3, 4, 80, 10, 5),
                                                  (4, 3, 200, 7, 1),
                                                  (2, 2, 9, 5, 2)])
def test_pso_run_matches_reference_50_iters(depth, width, n, P, seed):
    h, cm = _fitness(depth, width, n, seed)
    fit = cm.batch_fitness
    ref = RefPSO(h.dimensions, n, n_particles=P, seed=seed)
    port = FlagSwapPSO(h.dimensions, n, n_particles=P, seed=seed)
    best_ref = ref.run(cm.fitness, 50, batch_fitness_fn=fit)
    best_port = port.run(cm.fitness, 50, batch_fitness_fn=fit)
    assert np.array_equal(best_ref, best_port)
    _assert_same_swarm(port, ref)


def test_pso_ask_tell_matches_reference():
    h, cm = _fitness(3, 2, 30, 3)
    ref = RefPSO(h.dimensions, 30, n_particles=6, seed=3)
    port = FlagSwapPSO(h.dimensions, 30, n_particles=6, seed=3)
    for _ in range(40):
        a, b = ref.ask(), port.ask()
        assert np.array_equal(a, b)
        ref.tell(cm.fitness(a))
        port.tell(cm.fitness(b))
    assert port.converged == ref.converged
    _assert_same_swarm(port, ref)


def test_swarm_from_state_continues_reference_run():
    h, cm = _fitness(3, 4, 80, 9)
    ref = RefPSO(h.dimensions, 80, n_particles=10, seed=9)
    ref.run(cm.fitness, 20, batch_fitness_fn=cm.batch_fitness)
    state = json.loads(json.dumps(ref.state_dict()))  # plain JSON crosses
    port = swarm_from_state(state)
    _assert_same_swarm(port, ref)
    ref.run(cm.fitness, 30, batch_fitness_fn=cm.batch_fitness)
    port.run(cm.fitness, 30, batch_fitness_fn=cm.batch_fitness)
    _assert_same_swarm(port, ref)


def _drive_strategy(name, h_args, n_rounds, seed):
    """Run the port and reference strategy ``name`` through the same
    propose/observe loop; the observed cost is the reference's exact
    TPD, so any divergence is the strategy's own."""
    ref_h, h = RefHierarchy(*h_args), Hierarchy(*h_args)
    ref_pool = RefClientPool.random(ref_h.total_clients, seed=seed)
    pool = ClientPool.random(h.total_clients, seed=seed)
    ref_cm = RefCostModel(ref_h, ref_pool)
    kw = {"placement": tuple(range(h.dimensions))} if name == "static" else {}
    ref_s = ref_create_strategy(name, ref_h, seed=seed, clients=ref_pool,
                                cost_model=ref_cm, **kw)
    s = create_strategy(name, h, seed=seed, clients=pool,
                        cost_model=CostModel(h, pool, device="cpu"), **kw)
    for r in range(n_rounds):
        a, b = ref_s.propose(r), s.propose(r)
        assert np.array_equal(np.asarray(a), np.asarray(b)), (name, r)
        tpd = ref_cm.tpd_fast(a)
        ref_s.observe(np.asarray(a, np.int64), tpd)
        s.observe(np.asarray(b, np.int64), tpd)
    assert json.dumps(s.save_state(), sort_keys=True, default=str) == \
        json.dumps(ref_s.save_state(), sort_keys=True, default=str)


@pytest.mark.parametrize("name", ["random", "uniform", "static", "pso",
                                  "pso-adaptive", "ga", "sa", "cem",
                                  "greedy", "exhaustive"])
def test_strategies_propose_identically(name):
    assert name in strategy_names()
    _drive_strategy(name, (2, 2, 1, None), 30, seed=4)
    if name != "exhaustive":
        _drive_strategy(name, (3, 3, 2, 40), 40, seed=11)
