"""The emulated track (paper Fig. 4) end to end: port vs reference.

``paper-fig4`` with the smoke MLP (``mlp-smoke``), run on the CPU by
both packages. The port's initial params are the reference's, copied in
through the params bridge (``jax.random`` and torch draw different
streams). Placements and the deterministic TPD trace are numpy in both
packages, so they must be equal exactly; losses, accuracies and the
final global params are float math summed in different orders, held
to rtol 1e-4 (losses) and rtol 1e-4, atol 1e-6 (params) after 5 rounds.
"""
import jax
import numpy as np
import pytest

from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments.runner import run_experiment as ref_run_experiment
from repro.experiments.runner import run_single as ref_run_single
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.experiments import (
    EmulatedEnvironment,
    ExperimentResult,
    get_scenario,
    run_experiment,
    run_single,
)
from repro_torch.faults import ClientCrash
from repro_torch.models import mlp as port_mlp
from repro_torch.utils.trees import tree_leaves

ROUNDS = 5
SMOKE = {"model": "mlp-smoke"}
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


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


def _collect(into):
    return lambda obs: into.append(
        (obs.placement.tolist(), obs.tpd, obs.metrics["loss"],
         obs.metrics["accuracy"]))


@pytest.mark.parametrize("strategy", ["pso", "random", "uniform"])
def test_fig4_rounds_match_reference(strategy, reference_init):
    seed = 0
    reference_init(seed)
    want, got = [], []
    ref = ref_run_single(ref_get_scenario("paper-fig4").with_overrides(
        **SMOKE), strategy, seed=seed, rounds=ROUNDS,
        on_observation=_collect(want))
    port = run_single(get_scenario("paper-fig4").with_overrides(**SMOKE),
                      strategy, seed=seed, rounds=ROUNDS,
                      on_observation=_collect(got), device="cpu")
    assert [g[:2] for g in got] == [w[:2] for w in want]   # exact
    assert port.tpds == ref.tpds
    for k in ("train_time", "agg_time"):
        assert port.metrics[k] == ref.metrics[k]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=LOSS_RTOL)
    assert port.diagnostics == ref.diagnostics


def test_run_experiment_artifact_matches_reference(reference_init):
    reference_init(0)
    strategies = ["pso", "random", "uniform"]
    ref = ref_run_experiment(
        ref_get_scenario("paper-fig4").with_overrides(**SMOKE), strategies,
        rounds=ROUNDS, seeds=[0], progress=False)
    port = run_experiment(get_scenario("paper-fig4").with_overrides(**SMOKE),
                          strategies, rounds=ROUNDS, seeds=[0],
                          progress=False, device="cpu")
    a, b = port.to_dict(), ref.to_dict()
    assert a["scenario"] == b["scenario"]
    assert a["schema_version"] == b["schema_version"]
    for ra, rb in zip(a["runs"], b["runs"], strict=True):
        assert ra["tpds"] == rb["tpds"]
        assert ra["total_tpd"] == rb["total_tpd"]
        np.testing.assert_allclose(ra["metrics"]["loss"],
                                   rb["metrics"]["loss"], rtol=LOSS_RTOL)
    for s in strategies:
        assert a["aggregates"][s]["total_tpd"] == \
            b["aggregates"][s]["total_tpd"]
    back = ExperimentResult.from_dict(a)
    assert back.to_dict() == a


def test_final_params_match_reference(reference_init):
    """The global model after 5 batched rounds against the reference's,
    through the environments the runner builds."""
    seed = 1
    reference_init(seed)
    spec_r = ref_get_scenario("paper-fig4").with_overrides(**SMOKE)
    spec = get_scenario("paper-fig4").with_overrides(**SMOKE)
    ref_env = spec_r.make_environment(seed)
    env = spec.make_environment(seed, device="cpu")
    assert isinstance(env, EmulatedEnvironment)
    ref_env.begin()
    env.begin()
    rng = np.random.default_rng(seed)
    for r in range(ROUNDS):
        placement = rng.permutation(10)[:3]
        a, b = env.step(r, placement), ref_env.step(r, placement)
        assert a.tpd == b.tpd
    got = params_to_numpy(env.orchestrator.params)
    want = jax.tree.map(np.asarray, ref_env.orchestrator.params)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(x, y, **PARAM_TOL)


def test_loop_engine_equals_batched_engine(reference_init):
    """The port's two round engines: the same TPD trace exactly, the
    same model within float32 tolerance."""
    reference_init(0)
    runs = {}
    for engine in ("loop", "batched"):
        spec = get_scenario("paper-fig4").with_overrides(engine=engine,
                                                         **SMOKE)
        assert spec.make_environment(0, device="cpu").orchestrator.engine \
            == engine
        runs[engine] = run_single(spec, "pso", seed=0, rounds=3,
                                  device="cpu")
    assert runs["loop"].tpds == runs["batched"].tpds
    assert runs["loop"].metrics["agg_time"] == \
        runs["batched"].metrics["agg_time"]
    np.testing.assert_allclose(runs["loop"].metrics["loss"],
                               runs["batched"].metrics["loss"],
                               rtol=LOSS_RTOL)


def test_engines_give_close_params_and_measured_mode_runs(reference_init):
    reference_init(0)
    out = {}
    for engine in ("loop", "batched"):
        spec = get_scenario("paper-fig4").with_overrides(engine=engine,
                                                         **SMOKE)
        env = spec.make_environment(0, device="cpu")
        env.begin()
        for r in range(2):
            env.step(r, [0, 1, 2])
        out[engine] = tree_leaves(env.orchestrator.params)
    for a, b in zip(out["loop"], out["batched"], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)
    # measured timing: wall-clock TPDs, finite and positive
    spec = get_scenario("paper-fig4").with_overrides(timing="measured",
                                                     **SMOKE)
    run = run_single(spec, "random", seed=0, rounds=2, device="cpu")
    assert all(np.isfinite(t) and t > 0 for t in run.tpds)


def test_elastic_admit_matches_reference(reference_init):
    """admit/retire run through sync_population: the hierarchy sequence
    and the next round's TPD follow the reference's."""
    reference_init(0)
    spec_r = ref_get_scenario("paper-fig4").with_overrides(**SMOKE)
    spec = get_scenario("paper-fig4").with_overrides(**SMOKE)
    ref = spec_r.make_environment(0).orchestrator
    port = spec.make_environment(0, device="cpu").orchestrator
    ref.warmup()
    port.warmup()
    for orch in (ref, port):
        orch.admit(memcap=np.full(6, 64.0), pspeed=np.full(6, 1.5),
                   mdatasize=np.full(6, 30.0))
    assert repr(port.hierarchy) == repr(ref.hierarchy)
    assert port.topology_version == ref.topology_version == 1
    placement = np.arange(port.hierarchy.dimensions)
    assert port.run_round(0, placement).tpd == ref.run_round(0,
                                                             placement).tpd
    ur, up = ref.retire([0, 3]), port.retire([0, 3])
    assert repr(up.new_hierarchy) == repr(ur.new_hierarchy)
    assert np.array_equal(up.slot_remap, ur.slot_remap)


def test_fault_path_names_its_roadmap_item(tmp_path):
    """The fault path and run checkpointing (ROADMAP queue 1 item 8),
    once refused here, now run, and so does the online track's fault
    path (item 7), which once named its roadmap item here."""
    spec = get_scenario("paper-fig4").with_overrides(
        faults=(ClientCrash(client=3, at_round=1),), **SMOKE)
    assert spec.make_environment(0, device="cpu")._fault_mode
    run = run_single(spec, "pso", rounds=2, checkpoint_dir=str(tmp_path),
                     device="cpu")
    assert run.metrics["merged"] == [10.0, 9.0]
    assert (tmp_path / "step_00000002" / "meta.json").exists()
    online = get_scenario("online-faulty").with_overrides(**SMOKE) \
        .make_environment(0, device="cpu")
    assert online.kind == "online" and online._fault_mode
