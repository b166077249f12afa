"""The emulated fault track, checkpoint/resume and the elastic emulated
population: port vs reference, on the CPU.

* The server rules (``staleness_weights``, ``flush_count``,
  ``quorum_count``, ``RetryPolicy``) are float64 numpy in both packages:
  equal exactly. The merges (``async_merge_batched``,
  ``quorum_merge_batched``) are one float32 tensordot a leaf in both:
  held to the reference at rtol 1e-6 and to their own scalar oracles.
* Fault rounds through the environments: placements, TPDs and every
  fault series are numpy and must equal the reference's exactly; losses
  (float32 training from the reference's initial params, copied in)
  within rtol 1e-4, params within rtol 1e-4, atol 1e-6.
* Resume: a run checkpointed at round r and resumed equals the
  uninterrupted run's ``to_dict()`` byte for byte, and checkpointing
  never perturbs a run.
* Elastic presets on the emulated track: the numpy series equal the
  reference's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments.runner import run_single as ref_run_single
from repro.faults import RetryPolicy as RefRetryPolicy
from repro.faults import quorum_count as ref_quorum_count
from repro.faults import quorum_merge_batched as ref_quorum_merge
from repro.online import async_merge_batched as ref_async_merge
from repro.online.async_fedavg import flush_count as ref_flush_count
from repro.online.async_fedavg import staleness_weights as ref_staleness_weights
from repro_torch.checkpoint.store import latest_step
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.experiments import get_scenario, run_experiment, run_single
from repro_torch.faults import RetryPolicy, quorum_count, quorum_merge_batched
from repro_torch.faults.tolerance import _quorum_merge_ref
from repro_torch.models import mlp as port_mlp
from repro_torch.online import AggregatorBuffer, AsyncConfig, async_merge_batched, flush_count
from repro_torch.online.async_fedavg import (
    _async_merge_ref,
    _staleness_weights_ref,
    staleness_weights,
)
from repro_torch.utils.trees import tree_leaves

SMOKE = {"model": "mlp-smoke"}
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
MERGE_RTOL = 1e-6
FAULT_SERIES = ("merged", "down", "partitioned", "faults",
                "dropped_updates", "degraded_flushes", "failovers",
                "train_time", "agg_time")

# one crash pinned far past any test horizon: the fault machinery is
# armed (every fault branch live) but nothing ever fires
NEVER = json.dumps(
    [{"fault": "ClientCrash", "client": 0, "at_round": 10 ** 6}])
SHRINK = json.dumps([
    {"fault": "ClientCrash", "client": 3, "at_round": 1, "down_rounds": 1},
    {"fault": "UpdateDrop", "client": 5, "at_round": 2},
    {"fault": "AggregatorFailure", "slot": 0, "at_round": 3,
     "down_rounds": 1},
    {"fault": "LinkDegrade", "client": 2, "at_round": 4, "factor": 3.0,
     "for_rounds": 1},
    {"fault": "NetworkPartition", "clients": [1, 6], "at_round": 5,
     "for_rounds": 1}])


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


def _trees(seed, k):
    """A global tree, k stacked update rows and the same rows as a list,
    in both packages."""
    rng = np.random.default_rng(seed)
    glob = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(3).astype(np.float32)}]}
    stack = {"w": rng.standard_normal((k, 4, 3)).astype(np.float32),
             "layers": [{"b": rng.standard_normal((k, 3))
                         .astype(np.float32)}]}
    rows = [jax.tree.map(lambda x, i=i: x[i], stack) for i in range(k)]
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    return glob, stack, [to_t(r) for r in rows], to_t(glob), to_t(stack)


def _np_leaves(tree):
    return [x.numpy() for x in tree_leaves(tree)]


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# server rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,alpha", [(1, 0.5), (7, 0.0), (16, 1.3)])
def test_staleness_weights_equal_reference(k, alpha):
    rng = np.random.default_rng(k)
    w = rng.uniform(0.01, 1.0, k)
    s = rng.integers(0, 5, k).astype(np.float64)
    got = staleness_weights(w, s, alpha)
    assert np.array_equal(got, ref_staleness_weights(w, s, alpha))
    np.testing.assert_allclose(got, _staleness_weights_ref(w, s, alpha),
                               rtol=1e-15)
    with pytest.raises(ValueError, match="negative"):
        staleness_weights(w, -s - 1, alpha)
    with pytest.raises(ValueError, match="staleness"):
        staleness_weights(w, s[:-1] if k > 1 else np.zeros(2), alpha)


def test_counts_and_retry_policy_equal_reference():
    for expected in (1, 3, 10, 17):
        for frac in (0.0, 0.2, 0.75, 1.0, 1.5):
            assert flush_count(expected, frac) == \
                ref_flush_count(expected, frac)
            assert quorum_count(expected, frac) == \
                ref_quorum_count(expected, frac)
    with pytest.raises(ValueError):
        flush_count(0, 0.5)
    with pytest.raises(ValueError):
        quorum_count(0, 0.5)
    for policy, ref in ((RetryPolicy(), RefRetryPolicy()),
                        (RetryPolicy(3, 0.1, 3.0),
                         RefRetryPolicy(3, 0.1, 3.0))):
        assert policy.enabled == ref.enabled
        assert [policy.delay(a) for a in range(5)] == \
            [ref.delay(a) for a in range(5)]
    with pytest.raises(ValueError, match="negative"):
        RetryPolicy().delay(-1)
    assert AsyncConfig().degenerate and not AsyncConfig(jitter=0.1).degenerate
    buf = AggregatorBuffer(slot=2, expected=4, threshold=2)
    assert not buf.deposit("a") and buf.deposit("b")
    assert buf.take() == ("a", "b") and buf.empty and buf.epoch == 1


@pytest.mark.parametrize("k,alpha,eta", [(1, 0.5, 1.0), (5, 0.5, 0.7),
                                         (12, 0.0, 1.0)])
def test_async_merge_equals_reference_and_oracle(k, alpha, eta):
    glob, stack, rows, tglob, tstack = _trees(k, k)
    rng = np.random.default_rng(k + 100)
    w, s = rng.uniform(0.05, 1.0, k), rng.integers(0, 4, k)
    got = async_merge_batched(tglob, tstack, w, s, alpha, eta)
    want = ref_async_merge(jax.tree.map(jnp.asarray, glob),
                           jax.tree.map(jnp.asarray, stack), w, s, alpha,
                           eta)
    oracle = _async_merge_ref(tglob, rows, w, s, alpha, eta)
    for a, b, c in zip(_np_leaves(got), _ref_leaves(want),
                       _np_leaves(oracle), strict=True):
        np.testing.assert_allclose(a, b, rtol=MERGE_RTOL, atol=1e-7)
        np.testing.assert_allclose(a, c, rtol=MERGE_RTOL, atol=1e-7)


@pytest.mark.parametrize("k,frac", [(3, 0.3), (8, 0.8), (10, 1.0),
                                    (4, 2.0)])
def test_quorum_merge_equals_reference_and_oracle(k, frac):
    glob, stack, rows, tglob, tstack = _trees(k + 7, k)
    rng = np.random.default_rng(k)
    w, s = rng.uniform(0.05, 1.0, k), rng.integers(0, 3, k)
    got = quorum_merge_batched(tglob, tstack, w, s, 0.5, 0.9, frac)
    want = ref_quorum_merge(jax.tree.map(jnp.asarray, glob),
                            jax.tree.map(jnp.asarray, stack), w, s, 0.5,
                            0.9, frac)
    oracle = _quorum_merge_ref(tglob, rows, w, s, 0.5, 0.9, frac)
    for a, b, c in zip(_np_leaves(got), _ref_leaves(want),
                       _np_leaves(oracle), strict=True):
        np.testing.assert_allclose(a, b, rtol=MERGE_RTOL, atol=1e-7)
        np.testing.assert_allclose(a, c, rtol=MERGE_RTOL, atol=1e-7)
    with pytest.raises(ValueError, match="arrived_frac"):
        quorum_merge_batched(tglob, tstack, w, s, 0.5, 0.9, 0.0)


def test_full_participation_is_the_async_merge_bit_for_bit():
    _, _, _, tglob, tstack = _trees(3, 6)
    w, s = np.linspace(0.1, 1.0, 6), np.arange(6)
    full = async_merge_batched(tglob, tstack, w, s, 0.5, 0.7)
    for frac in (1.0, 1.5):
        q = quorum_merge_batched(tglob, tstack, w, s, 0.5, 0.7, frac)
        for a, b in zip(tree_leaves(q), tree_leaves(full), strict=True):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fault rounds through the emulated environment
# ---------------------------------------------------------------------------
def _series(run):
    return {k: run.metrics[k] for k in FAULT_SERIES if k in run.metrics}


def test_armed_but_silent_schedule_is_bit_identical_emulated():
    spec = get_scenario("paper-fig4").with_overrides(**SMOKE)
    armed = spec.with_overrides(faults=NEVER)
    a = run_experiment(spec, ["greedy"], rounds=3, seeds=(0,),
                       progress=False, device="cpu").runs[0]
    b = run_experiment(armed, ["greedy"], rounds=3, seeds=(0,),
                       progress=False, device="cpu").runs[0]
    assert a.tpds == b.tpds
    assert a.metrics["loss"] == b.metrics["loss"]
    assert a.metrics["accuracy"] == b.metrics["accuracy"]
    assert b.metrics["faults"] == [0.0] * 3
    ref = ref_run_single(ref_get_scenario("paper-fig4").with_overrides(
        **SMOKE, faults=NEVER), "greedy", seed=0, rounds=3)
    assert b.tpds == ref.tpds and _series(b) == _series(ref)


def test_emulated_faults_shrink_cohort_and_recover(reference_init):
    reference_init(0)
    spec = get_scenario("paper-fig4").with_overrides(**SMOKE, faults=SHRINK)
    run = run_single(spec, "greedy", seed=0, rounds=7, device="cpu")
    merged = run.metrics["merged"]
    assert merged[0] == 10.0          # clean round: full cohort
    assert merged[1] == 9.0           # crash: one client down
    assert merged[2] == 9.0           # drop: trained but not merged
    assert run.metrics["failovers"][3] == 1.0   # the failed aggregator
    assert merged[4] == 10.0          # a degraded link slows, drops none
    assert run.metrics["train_time"][4] > run.metrics["train_time"][0]
    assert merged[5] == 8.0           # two partitioned, one of them a host
    assert run.metrics["failovers"][-1] == 2.0
    assert merged[-1] == 10.0         # everything healed
    assert run.metrics["partitioned"] == [0.0] * 5 + [2.0, 0.0]
    ref = ref_run_single(ref_get_scenario("paper-fig4").with_overrides(
        **SMOKE, faults=SHRINK), "greedy", seed=0, rounds=7)
    assert run.tpds == ref.tpds
    assert _series(run) == _series(ref)
    np.testing.assert_allclose(run.metrics["loss"], ref.metrics["loss"],
                               rtol=LOSS_RTOL)


def test_quorum_refusal_holds_the_model():
    spec = get_scenario("paper-fig4").with_overrides(
        **SMOKE, quorum_frac="0.99", faults=SHRINK)
    run = run_single(spec, "pso", seed=0, rounds=4, device="cpu")
    # round 2's drop leaves 9 of 10 live updates, under the 0.99 quorum:
    # the merge is refused and the model holds
    assert run.metrics["merged"] == [10.0, 9.0, 0.0, 9.0]
    assert run.metrics["degraded_flushes"] == [0.0, 0.0, 1.0, 1.0]
    assert run.metrics["loss"][2] == run.metrics["loss"][1]
    ref = ref_run_single(ref_get_scenario("paper-fig4").with_overrides(
        **SMOKE, quorum_frac="0.99", faults=SHRINK), "pso", seed=0,
        rounds=4)
    assert run.tpds == ref.tpds and _series(run) == _series(ref)


@pytest.mark.parametrize("strategy", ["pso", "greedy"])
def test_chaos_emulated_matches_reference(strategy, reference_init):
    """The chaos preset's seeded fault profile (crashes, drops, degraded
    links, partitions, aggregator failures, quorum 0.2) on the emulated
    track: every numpy series exactly, losses at the f32 tolerance."""
    reference_init(0)
    want, got = [], []
    ref = ref_run_single(ref_get_scenario("chaos").with_overrides(**SMOKE)
                         .for_env("emulated"), strategy, seed=0, rounds=10,
                         on_observation=lambda o: want.append(
                             o.placement.tolist()))
    run = run_single(get_scenario("chaos").with_overrides(**SMOKE)
                     .for_env("emulated"), strategy, seed=0, rounds=10,
                     device="cpu", on_observation=lambda o: got.append(
                         o.placement.tolist()))
    assert got == want
    assert run.tpds == ref.tpds
    assert _series(run) == _series(ref)
    assert run.event_log == ref.event_log
    assert max(run.metrics["faults"]) > 0
    np.testing.assert_allclose(run.metrics["loss"], ref.metrics["loss"],
                               rtol=LOSS_RTOL)


def test_faulty_round_params_and_agg_time_match_reference(reference_init):
    """One orchestrator round under every fault kind: the merged global
    params against the reference's, the agg-time walk exactly."""
    reference_init(1)
    port_env = get_scenario("paper-fig4").with_overrides(**SMOKE) \
        .make_environment(1, device="cpu")
    ref_env = ref_get_scenario("paper-fig4").with_overrides(**SMOKE) \
        .make_environment(1)
    port, ref = port_env.orchestrator, ref_env.orchestrator
    port.warmup()
    ref.warmup()
    faults = dict(down={2, 7}, dropped={4}, degraded={1: 2.5},
                  quorum_frac=0.2)
    placement = np.array([7, 0, 3])
    a, ea = port.run_round_faulty(0, placement, **faults)
    b, eb = ref.run_round_faulty(0, placement, **faults)
    assert ea == eb and a.placement == b.placement
    assert (a.tpd, a.train_time, a.agg_time) == \
        (b.tpd, b.train_time, b.agg_time)
    for x, y in zip(jax.tree.leaves(params_to_numpy(port.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.params)),
                    strict=True):
        np.testing.assert_allclose(x, y, **PARAM_TOL)
    rng = np.random.default_rng(4)
    for _ in range(10):
        eff = rng.permutation(10)[:3]
        merged = {int(c) for c in rng.permutation(10)[:rng.integers(1, 11)]}
        assert port._faulty_agg_time(eff, merged) == \
            ref._faulty_agg_time(eff, merged)
    # a round with no faults is run_round itself
    clean, extra = port.run_round_faulty(1, placement)
    assert extra["merged"] == 10.0 and extra["down"] == 0.0


def test_faulty_round_refusals():
    orch = get_scenario("paper-fig4").with_overrides(
        **SMOKE, engine="loop").make_environment(0, device="cpu").orchestrator
    with pytest.raises(ValueError, match="batched"):
        orch.run_round_faulty(0, [0, 1, 2], down={5})
    orch = get_scenario("paper-fig4").with_overrides(
        **SMOKE, timing="measured").make_environment(
        0, device="cpu").orchestrator
    with pytest.raises(ValueError, match="deterministic"):
        orch.run_round_faulty(0, [0, 1, 2], down={5})
    orch = get_scenario("paper-fig4").with_overrides(**SMOKE) \
        .make_environment(0, device="cpu").orchestrator
    with pytest.raises(RuntimeError, match="every client is down"):
        orch.run_round_faulty(0, [0, 1, 2], down=set(range(10)))


# ---------------------------------------------------------------------------
# checkpoint/resume
# ---------------------------------------------------------------------------
def _chaos():
    return get_scenario("chaos").with_overrides(**SMOKE).for_env("emulated")


def _dump(run):
    return json.dumps(run.to_dict(), sort_keys=True)


def test_checkpointing_never_perturbs_the_run(tmp_path):
    plain = run_single(_chaos(), "pso", seed=0, rounds=4, device="cpu")
    ckpt = run_single(_chaos(), "pso", seed=0, rounds=4, device="cpu",
                      checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _dump(ckpt) == _dump(plain)
    assert latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("strategy,seed,stop", [("greedy", 1, 2),
                                                ("pso", 0, 3)])
def test_resume_from_checkpoint_is_bit_identical_emulated(
        tmp_path, strategy, seed, stop):
    full = run_single(_chaos(), strategy, seed=seed, rounds=6,
                      device="cpu")
    run_single(_chaos(), strategy, seed=seed, rounds=stop, device="cpu",
               checkpoint_dir=str(tmp_path))
    resumed = run_single(_chaos(), strategy, seed=seed, rounds=6,
                         device="cpu", checkpoint_dir=str(tmp_path),
                         resume=True)
    assert _dump(resumed) == _dump(full)
    assert latest_step(str(tmp_path)) == 6


def test_resume_is_bit_identical_on_the_sampled_simulated_track(tmp_path):
    spec = get_scenario("large-100k").with_overrides(pool_size=256,
                                                     cohort_size=16)
    full = run_single(spec, "pso", seed=0, rounds=6, device="cpu")
    run_single(spec, "pso", seed=0, rounds=3, device="cpu",
               checkpoint_dir=str(tmp_path))
    resumed = run_single(spec, "pso", seed=0, rounds=6, device="cpu",
                         checkpoint_dir=str(tmp_path), resume=True)
    assert _dump(resumed) == _dump(full)


def test_checkpoint_refusals(tmp_path):
    with pytest.raises(ValueError, match="elastic"):
        run_single(get_scenario("flash-crowd"), "pso", seed=0, rounds=2,
                   device="cpu", checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_single(_chaos(), "pso", seed=0, rounds=2, device="cpu",
                   resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        run_single(_chaos(), "pso", seed=0, rounds=2, device="cpu",
                   checkpoint_dir=str(tmp_path), checkpoint_every=0)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        run_single(_chaos(), "pso", seed=0, rounds=2, device="cpu",
                   checkpoint_dir=str(tmp_path / "empty"), resume=True)


# ---------------------------------------------------------------------------
# the elastic emulated population (queue 1 item 6)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["flash-crowd", "ebb-and-flow"])
def test_elastic_presets_on_the_emulated_track_match_reference(name):
    rounds = 30
    ref = ref_run_single(ref_get_scenario(name).with_overrides(**SMOKE)
                         .for_env("emulated"), "pso", seed=0, rounds=rounds)
    run = run_single(get_scenario(name).with_overrides(**SMOKE)
                     .for_env("emulated"), "pso", seed=0, rounds=rounds,
                     device="cpu")
    assert run.tpds == ref.tpds
    for k in ("topology_version", "n_clients"):
        assert run.metrics[k] == ref.metrics[k]
    assert run.event_log == ref.event_log
    assert max(run.metrics["topology_version"]) > 0
    assert len(set(run.metrics["n_clients"])) > 1
