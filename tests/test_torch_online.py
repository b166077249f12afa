"""The online track: port vs reference, on the CPU.

* ``VirtualClock`` and ``ArrivalProcess`` are pure Python / numpy in
  both packages: the clock's order and the arrival factors equal the
  reference's exactly, checkpoint round trips included.
* ``OnlineEnvironment`` runs (``online-fig4``, ``online-straggler``, the
  fault behaviours, elastic growth) against ``repro.experiments``: event
  logs, placements, TPDs, overlap, staleness, swaps and every fault
  series are numpy and must be equal exactly; losses (float32 training
  from the reference's initial params, copied in) within rtol 1e-4,
  final params within rtol 1e-3 / atol 1e-5 but for at most 1e-4 of the
  elements (float32 sums in other orders), and within 1e-4 everywhere.
* ``online-sync`` (the degenerate lockstep config) equals the port's own
  emulated ``paper-fig4`` bit for bit: the same orchestrator calls.
* A resumed online run equals the uninterrupted run byte for byte.
* Stored in-flight updates are copies: a later full-cohort
  ``train_cohort``, which trains into the aggregator's client rows, does
  not touch them.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments import run_experiment as ref_run_experiment
from repro.experiments.environments import _encode_event as ref_encode_event
from repro.experiments.runner import run_single as ref_run_single
from repro.online import ArrivalProcess as RefArrivalProcess
from repro.online import VirtualClock as RefVirtualClock
from repro_torch.checkpoint.store import latest_step
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy, TopologyUpdate, slot_remap
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.experiments import OnlineEnvironment, get_scenario, run_experiment, run_single
from repro_torch.experiments.environments import _decode_event, _encode_event
from repro_torch.faults import ClientCrash, FaultAt
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model
from repro_torch.models import mlp as port_mlp
from repro_torch.online import (
    ArrivalProcess,
    AsyncConfig,
    BufferDeadline,
    BufferEntry,
    PartialArrival,
    RootComplete,
    UpdateArrival,
    VirtualClock,
)
from repro_torch.utils.trees import tree_leaves

SMOKE = {"model": "mlp-smoke"}
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
# float32 local training in two packages sums in other orders; over many
# staleness-weighted merges a few elements near 0 move by ~1e-5, so the
# params are held elementwise on every element, but for online-straggler
# up to this share of them (2 of its 50,176 elements part by 1.3e-5 after
# 8 rounds of float32 training in two packages), and within PARAM_MAX_ABS
# everywhere
PARAM_SHARE = {"online-straggler": 5e-5}
PARAM_MAX_ABS = 1e-4
ONLINE_SERIES = ("overlap", "reopt_swaps", "merged", "staleness_mean",
                 "staleness_max")
FAULT_SERIES = ("down", "partitioned", "faults", "dropped_updates",
                "retries", "degraded_flushes", "failovers")


@pytest.fixture
def reference_init(monkeypatch):
    """Make the port's MLP start from the reference's initial params for
    the seed the test runs (the reference draws them with jax.random)."""
    from repro.configs import get_config as ref_get_config
    from repro.models import get_model as ref_get_model

    def use(seed):
        def init(generator, cfg, device="cuda"):
            model = ref_get_model(ref_get_config(cfg.name))
            ref = jax.tree.map(np.asarray, model.init(jax.random.key(seed)))
            return params_from_numpy(ref, device=device)
        monkeypatch.setattr(port_mlp, "init_mlp_params", init)
    return use


def keeping(spec, envs, **make_kw):
    """``spec`` as a ScenarioSpec of its own class whose environments are
    appended to ``envs`` (both packages; ``make_kw`` goes to the
    package's own ``make_environment``)."""
    base = type(spec)

    class Kept(base):
        def make_environment(self, seed=0, eval_config=None, **kw):
            env = base.make_environment(self, seed, eval_config,
                                        **dict(kw, **make_kw))
            envs.append(env)
            return env

    return Kept(**{f.name: getattr(spec, f.name)
                   for f in dataclasses.fields(spec)})


def _series(run, names):
    return {k: run.metrics[k] for k in names if k in run.metrics}


def _assert_params_close(port_env, ref_env, share=0.0):
    """Final params within PARAM_TOL elementwise, but for at most
    ``share`` of the elements, and within PARAM_MAX_ABS everywhere."""
    got = jax.tree.leaves(params_to_numpy(port_env.orchestrator.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray,
                                        ref_env.orchestrator.params))
    total = outside = 0
    for x, y in zip(got, want, strict=True):
        assert x.shape == y.shape and np.all(np.isfinite(x))
        np.testing.assert_allclose(x, y, rtol=0, atol=PARAM_MAX_ABS)
        total += x.size
        outside += int(np.count_nonzero(~np.isclose(x, y, **PARAM_TOL)))
    assert outside <= share * total, (outside, total)


# ---------------------------------------------------------------------------
# virtual clock
# ---------------------------------------------------------------------------
def test_clock_pops_in_time_order_and_fifo_on_ties():
    clk, ref = VirtualClock(), RefVirtualClock()
    times = [2.0, 1.0, 3.0, 1.0, 1.0, 2.0, 0.5]
    for i, t in enumerate(times):
        clk.schedule(t, f"ev{i}")
        ref.schedule(t, f"ev{i}")
    got = [clk.pop() for _ in times]
    assert got == [ref.pop() for _ in times]
    assert got[:4] == [(0.5, "ev6"), (1.0, "ev1"), (1.0, "ev3"),
                       (1.0, "ev4")]
    assert clk.now == 3.0 and not clk
    with pytest.raises(IndexError):
        clk.pop()


def test_clock_refuses_the_past_and_rewinds():
    clk = VirtualClock()
    clk.schedule(1.0, "a")
    clk.pop()
    with pytest.raises(ValueError, match="past"):
        clk.schedule(0.5, "b")
    clk.advance_to(4.0)
    assert clk.now == 4.0
    with pytest.raises(ValueError, match="rewind"):
        clk.advance_to(2.0)


def test_clock_replace_and_state_round_trip():
    clk = VirtualClock()
    clk.schedule(2.0, UpdateArrival(1, 0))
    clk.schedule(1.0, BufferDeadline(2, 3))
    clk.schedule(1.0, RootComplete((BufferEntry(4, 0), BufferEntry(2, 1))))
    clk.schedule(1.5, PartialArrival(0, 7, (BufferEntry(7, 2),)))
    pend = clk.pending()
    clk.replace([row for row in pend if not isinstance(row[2],
                                                        UpdateArrival)])
    assert [ev for _t, _s, ev in clk.pending()] == \
        [ev for _t, _s, ev in pend if not isinstance(ev, UpdateArrival)]
    clk.schedule(2.0, UpdateArrival(1, 0))
    state = json.loads(json.dumps(clk.state_dict(_encode_event)))
    back = VirtualClock()
    back.load_state(state, _decode_event)
    assert back.now == clk.now and back.pending() == clk.pending()
    back.schedule(2.0, "later")           # the counter resumes past all
    assert back.pending()[-1] == (2.0, clk._seq, "later")


# ---------------------------------------------------------------------------
# seeded arrivals
# ---------------------------------------------------------------------------
def test_arrival_zero_sigma_is_exactly_one_and_stateless():
    ap = ArrivalProcess(seed=7, sigma=0.0)
    assert all(ap.factor(c) == 1.0 for c in range(5))
    assert not ap._rngs


@pytest.mark.parametrize("seed,sigma", [(3, 0.4), (0, 0.35), (11, 1.2)])
def test_arrival_factors_equal_reference_in_any_call_order(seed, sigma):
    a, ref = ArrivalProcess(seed, sigma), RefArrivalProcess(seed, sigma)
    order = [4, 2, 0, 3, 1, 2, 2, 0, 4, 9]
    assert [a.factor(c) for c in order] == [ref.factor(c) for c in order]
    b = ArrivalProcess(seed, sigma)
    fb = {c: [b.factor(c) for _ in range(order.count(c))]
          for c in sorted(set(order))}
    fa = {}
    a2 = ArrivalProcess(seed, sigma)
    for c in order:
        fa.setdefault(c, []).append(a2.factor(c))
    assert fa == fb


def test_arrival_migrate_and_state_round_trip():
    a, ref = ArrivalProcess(3, 0.4), RefArrivalProcess(3, 0.4)
    for c in range(4):
        a.factor(c)
        ref.factor(c)
    remap = np.array([0, -1, 1, 2])      # client 1 departs
    a.migrate(remap)
    ref.migrate(remap)
    state = json.loads(json.dumps(a.state_dict()))
    b = ArrivalProcess(3, 0.4)
    b.load_state(state)
    want = [ref.factor(c) for c in (0, 1, 2, 5)]
    assert [a.factor(c) for c in (0, 1, 2, 5)] == want
    assert [b.factor(c) for c in (0, 1, 2, 5)] == want


# ---------------------------------------------------------------------------
# the event codec
# ---------------------------------------------------------------------------
def test_event_codec_round_trips_and_equals_reference():
    from repro.faults import ClientCrash as RefClientCrash
    from repro.faults import FaultAt as RefFaultAt
    from repro.online import BufferDeadline as RefDeadline
    from repro.online import BufferEntry as RefEntry
    from repro.online import PartialArrival as RefPartial
    from repro.online import RootComplete as RefRoot
    from repro.online import UpdateArrival as RefArrival
    crash = dict(client=3, at_round=2, offset=0.25, down_rounds=1)
    pairs = [
        (UpdateArrival(3, 7), RefArrival(3, 7)),
        (PartialArrival(2, 5, (BufferEntry(5, 1), BufferEntry(8, 0))),
         RefPartial(2, 5, (RefEntry(5, 1), RefEntry(8, 0)))),
        (BufferDeadline(4, 9), RefDeadline(4, 9)),
        (RootComplete((BufferEntry(0, 3),)), RefRoot((RefEntry(0, 3),))),
        (FaultAt(ClientCrash(**crash)), RefFaultAt(RefClientCrash(**crash))),
    ]
    for ev, ref in pairs:
        enc = _encode_event(ev)
        assert enc == ref_encode_event(ref)
        assert _decode_event(json.loads(json.dumps(enc))) == ev
    with pytest.raises(TypeError):
        _encode_event("not an event")
    with pytest.raises(ValueError):
        _decode_event({"t": "bogus"})


# ---------------------------------------------------------------------------
# OnlineEnvironment against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,strategy,rounds", [
    ("online-fig4", "pso", 6), ("online-fig4", "greedy", 5),
    ("online-straggler", "pso", 8)])
def test_online_presets_match_reference(name, strategy, rounds,
                                        reference_init):
    reference_init(0)
    ports, refs, got, want = [], [], [], []
    run = run_single(keeping(get_scenario(name).with_overrides(**SMOKE),
                             ports), strategy, seed=0, rounds=rounds,
                     device="cpu",
                     on_observation=lambda o: got.append(
                         o.placement.tolist()))
    ref = ref_run_single(keeping(ref_get_scenario(name).with_overrides(
        **SMOKE), refs), strategy, seed=0, rounds=rounds,
        on_observation=lambda o: want.append(o.placement.tolist()))
    assert got == want
    assert run.tpds == ref.tpds
    assert run.event_log == ref.event_log
    assert _series(run, ONLINE_SERIES) == _series(ref, ONLINE_SERIES)
    np.testing.assert_allclose(run.metrics["loss"], ref.metrics["loss"],
                               rtol=LOSS_RTOL)
    _assert_params_close(ports[0], refs[0], PARAM_SHARE.get(name, 0.0))
    assert max(run.metrics["overlap"]) > 0
    assert max(run.metrics["staleness_max"]) > 0
    if name == "online-straggler":
        assert run.metrics["reopt_swaps"][-1] > 0
        assert any("REOPT" in line for line in run.event_log)


def test_online_sync_is_the_emulated_track_bit_for_bit():
    envs = {"online": [], "emulated": []}
    runs = {}
    for kind, name in (("online", "online-sync"),
                       ("emulated", "paper-fig4")):
        runs[kind] = run_single(
            keeping(get_scenario(name).with_overrides(**SMOKE), envs[kind]),
            "pso", seed=0, rounds=5, device="cpu")
    a, b = runs["online"], runs["emulated"]
    assert a.tpds == b.tpds
    for k in ("loss", "accuracy", "train_time", "agg_time"):
        assert a.metrics[k] == b.metrics[k]
    assert a.metrics["merged"] == [10.0] * 5
    assert a.metrics["staleness_max"] == [0.0] * 5
    assert all("lockstep merge" in line for line in a.event_log
               if "merge" in line)
    pa = tree_leaves(envs["online"][0].orchestrator.params)
    pb = tree_leaves(envs["emulated"][0].orchestrator.params)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb, strict=True))
    assert envs["online"][0]._store == {}


FAULT_CASES = {
    "drop-retries": (dict(faults=json.dumps(
        [{"fault": "UpdateDrop", "client": 0, "at_round": 1,
          "offset": 0.05}]), retry_limit="3"), 3),
    "drop-lost": (dict(faults=json.dumps(
        [{"fault": "UpdateDrop", "client": 0, "at_round": 1,
          "offset": 0.05}])), 3),
    "crash": (dict(faults=json.dumps(
        [{"fault": "ClientCrash", "client": 3, "at_round": 1,
          "offset": 0.01, "down_rounds": 1}])), 4),
    "aggregator-failure": (dict(faults=json.dumps(
        [{"fault": "AggregatorFailure", "slot": 0, "at_round": 1,
          "offset": 0.05, "down_rounds": 1}])), 4),
    "partition": (dict(faults=json.dumps(
        [{"fault": "NetworkPartition", "clients": [2, 5], "at_round": 1,
          "for_rounds": 1}])), 4),
    "quorum-refusal": (dict(quorum_frac="0.99"), 3),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_online_fault_behaviours_match_reference(case, reference_init):
    reference_init(0)
    overrides, rounds = FAULT_CASES[case]
    run = run_single(get_scenario("online-fig4").with_overrides(
        **SMOKE, **overrides), "pso", seed=0, rounds=rounds, device="cpu")
    ref = ref_run_single(ref_get_scenario("online-fig4").with_overrides(
        **SMOKE, **overrides), "pso", seed=0, rounds=rounds)
    assert run.tpds == ref.tpds
    assert run.event_log == ref.event_log
    assert _series(run, ONLINE_SERIES + FAULT_SERIES) == \
        _series(ref, ONLINE_SERIES + FAULT_SERIES)
    np.testing.assert_allclose(run.metrics["loss"], ref.metrics["loss"],
                               rtol=LOSS_RTOL)
    m = run.metrics
    if case == "drop-retries":
        assert m["retries"][-1] == 1.0 and m["dropped_updates"][-1] == 0.0
    elif case == "drop-lost":
        assert m["retries"][-1] == 0.0 and m["dropped_updates"][-1] == 1.0
    elif case == "crash":
        assert max(m["down"]) >= 1.0 and m["down"][-1] == 0.0
        assert m["faults"][-1] == 1.0
    elif case == "aggregator-failure":
        assert m["failovers"][-1] >= 1.0
        assert any("FAILOVER" in line for line in run.event_log)
    elif case == "partition":
        assert max(m["partitioned"]) == 2.0 and m["partitioned"][-1] == 0.0
    else:
        assert m["degraded_flushes"][-1] > 0
        assert all(x == 0.0 for x in m["merged"])
        assert all(np.isfinite(v) for v in m["loss"])


def test_armed_but_silent_schedule_is_bit_identical_online():
    spec = get_scenario("online-fig4").with_overrides(**SMOKE)
    armed = spec.with_overrides(faults=json.dumps(
        [{"fault": "ClientCrash", "client": 0, "at_round": 10 ** 6}]))
    a = run_experiment(spec, ["pso"], rounds=4, seeds=(0,),
                       progress=False, device="cpu").runs[0]
    b = run_experiment(armed, ["pso"], rounds=4, seeds=(0,),
                       progress=False, device="cpu").runs[0]
    assert a.tpds == b.tpds
    assert a.metrics["loss"] == b.metrics["loss"]
    assert b.metrics["faults"] == [0.0] * 4


@pytest.mark.parametrize("strategy", ["pso", "greedy"])
def test_chaos_online_matches_reference(strategy, reference_init):
    reference_init(0)
    spec = get_scenario("chaos").with_overrides(**SMOKE)
    run = run_single(spec, strategy, seed=0, rounds=8, device="cpu")
    ref = ref_run_single(ref_get_scenario("chaos").with_overrides(**SMOKE),
                         strategy, seed=0, rounds=8)
    assert run.tpds == ref.tpds
    assert run.event_log == ref.event_log
    assert _series(run, ONLINE_SERIES + FAULT_SERIES) == \
        _series(ref, ONLINE_SERIES + FAULT_SERIES)
    assert max(run.metrics["faults"]) > 0
    np.testing.assert_allclose(run.metrics["loss"], ref.metrics["loss"],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# checkpoint/resume, elasticity
# ---------------------------------------------------------------------------
def _dump(run):
    return json.dumps(run.to_dict(), sort_keys=True)


@pytest.mark.parametrize("name,strategy,stop", [
    ("chaos", "pso", 3), ("online-fig4", "greedy", 2)])
def test_online_resume_is_bit_identical(tmp_path, name, strategy, stop):
    spec = get_scenario(name).with_overrides(**SMOKE)
    full = run_single(spec, strategy, seed=0, rounds=6, device="cpu")
    ckpt = run_single(spec, strategy, seed=0, rounds=stop, device="cpu",
                      checkpoint_dir=str(tmp_path))
    assert ckpt.tpds == full.tpds[:stop]    # checkpointing never perturbs
    meta = json.loads((tmp_path / f"step_{stop:08d}" / "meta.json")
                      .read_text())
    assert meta["extra"]["store_keys"]      # updates were in flight
    resumed = run_single(spec, strategy, seed=0, rounds=6, device="cpu",
                         checkpoint_dir=str(tmp_path), resume=True)
    assert _dump(resumed) == _dump(full)
    assert latest_step(str(tmp_path)) == 6


def test_online_elastic_population_grows_mid_run():
    events = ('[{"event": "ClientJoin", "every": 3, "count": 6, '
              '"first_round": 2}]')
    spec = get_scenario("online-fig4").with_overrides(**SMOKE,
                                                      events=events)
    res = run_experiment(spec, ["pso"], rounds=6, seeds=[0],
                         progress=False, device="cpu")
    ref = ref_run_experiment(ref_get_scenario("online-fig4").with_overrides(
        **SMOKE, events=events), ["pso"], rounds=6, seeds=[0],
        progress=False)
    run, want = res.runs[0], ref.runs[0]
    assert run.tpds == want.tpds
    assert run.event_log == want.event_log
    for k in ("n_clients", "topology_version") + ONLINE_SERIES:
        assert run.metrics[k] == want.metrics[k]
    assert run.metrics["n_clients"][0] == 10.0
    assert run.metrics["n_clients"][-1] > 10.0
    assert max(run.metrics["topology_version"]) >= 1.0


# ---------------------------------------------------------------------------
# the environment directly
# ---------------------------------------------------------------------------
def _online_env(async_cfg, seed=0, pspeed=None):
    cfg = get_config("mlp-smoke")
    h = Hierarchy(depth=2, width=2, trainers_per_leaf=1, n_clients=10)
    if pspeed is None:
        pool = ClientPool.random(h.total_clients, seed=seed)
    else:
        pool = ClientPool(memcap=np.full(10, 1024.0),
                          pspeed=np.asarray(pspeed, np.float64),
                          mdatasize=np.full(10, 5.0))
    data = make_federated_dataset(cfg, h.total_clients, seed=seed)
    orch = FederatedOrchestrator(get_model(cfg), h, pool, data,
                                 local_steps=1, batch_size=16, seed=seed,
                                 comm_latency=0.002,
                                 timing="deterministic", device="cpu")
    env = OnlineEnvironment(orch, async_cfg, seed=seed)
    env.begin()
    return env


ASYNC = AsyncConfig(jitter=0.35, flush_fraction=0.75, flush_timeout=0.5,
                    server_lr=0.7)


def test_stored_updates_survive_a_later_full_cohort():
    """An update still in flight when a full cohort trains into the
    aggregator's client rows keeps its bits: the store holds copies."""
    env = _online_env(ASYNC)
    orch = env.orchestrator
    env.step(0, np.array([0, 1, 2]))        # a full cohort dispatched
    assert env._store
    before = {k: [x.clone() for x in tree_leaves(v)]
              for k, v in sorted(env._store.items())}
    rows = orch._agg.client_stack(orch.params)
    orch.train_cohort(np.arange(10), 5)     # trains into those rows
    for k, leaves in before.items():
        for x, y in zip(tree_leaves(env._store[k]), leaves, strict=True):
            assert torch.equal(x, y)
            assert x.untyped_storage().data_ptr() != \
                tree_leaves(rows)[0].untyped_storage().data_ptr()


def test_online_reopt_swaps_host_mid_round_and_pulses():
    env = _online_env(
        AsyncConfig(jitter=0.1, flush_fraction=0.75, flush_timeout=0.5,
                    server_lr=0.7, reopt_threshold=2.0, reopt_beta=0.5),
        pspeed=[10.0, 10.0, 10.0] + [8.0] * 7)
    proposal = np.array([0, 1, 2])
    for r in range(3):
        assert np.array_equal(env.step(r, proposal).placement, proposal)
    env.clients.pspeed[0] = 0.05            # the root host slows down
    for r in range(3, 8):
        obs = env.step(r, proposal)
        if obs.metrics["reopt_swaps"] > 0:
            break
    assert obs.placement[0] != 0
    assert any("REOPT" in line for line in obs.log)
    update = env.sync_topology()
    assert update.client_remap is None and update.version == 1
    assert update.new_hierarchy is env.hierarchy
    assert env.sync_topology() is None


def test_migration_refuses_a_stale_client_id():
    env = _online_env(ASYNC)
    env.step(0, np.array([0, 1, 2]))
    h = env.hierarchy
    stale = TopologyUpdate(version=1, old_hierarchy=h, new_hierarchy=h,
                           slot_remap=slot_remap(h, h),
                           client_remap=np.arange(3))
    with pytest.raises(RuntimeError, match="outside the remap domain"):
        env._migrate_engine(stale)


def test_online_env_refusals_and_protocol():
    cfg = get_config("mlp-smoke")
    h = Hierarchy(depth=2, width=2, trainers_per_leaf=1, n_clients=10)
    orch = FederatedOrchestrator(
        get_model(cfg), h, ClientPool.random(10, seed=0),
        make_federated_dataset(cfg, 10, seed=0), local_steps=1,
        batch_size=16, engine="loop", device="cpu")
    with pytest.raises(ValueError, match="batched"):
        OnlineEnvironment(orch, AsyncConfig())
    env = _online_env(ASYNC)
    assert env.cost_model.device.type == "cpu"
    strat = create_strategy("pso", env.hierarchy, seed=0)
    for r in range(2):
        p = np.asarray(strat.propose(r), np.int64)
        obs = env.step(r, p)
        assert obs.tpd > 0
        strat.observe(p, obs.tpd)
    assert strat.pso.evaluations == 2
    with pytest.raises(ValueError, match="calibrated"):
        from repro_torch.experiments import EvalConfig
        get_scenario("online-fig4").with_overrides(**SMOKE).make_environment(
            0, eval_config=EvalConfig(cost_source="calibrated",
                                      calibration="x.json"), device="cpu")
