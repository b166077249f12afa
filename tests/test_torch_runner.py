"""The port's sweep runner: ``EvalConfig``, the lockstep batched sweep,
the CLI and simulated timing recording, held to the reference.

Byte targets: the port writes the reference's golden artifacts
(``tests/golden/recording_off_fig3.json`` and both
``sampling_off_*.json``) byte for byte on the CPU, through
``run_experiment`` in sequential and batched mode and through its CLI.
Everything compared here is numpy in both packages, so every comparison
is exact.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments.runner import run_single as ref_run_single
from repro_torch.core.cost_model import PooledTPDEvaluator
from repro_torch.experiments import (
    EvalConfig,
    ExperimentResult,
    SimulatedEnvironment,
    get_scenario,
    resolve_eval_config,
    run_batched,
    run_experiment,
    run_single,
    validate_result_dict,
)
from repro_torch.experiments.cli import main as cli_main
from repro_torch.experiments.scenarios import ScenarioSpec

GOLDEN = Path(__file__).parent / "golden"
FIG3_GOLDEN = (GOLDEN / "recording_off_fig3.json").read_text()


def _fig3_result(**kw):
    spec = get_scenario("paper-fig3").with_overrides(rounds=6)
    return run_experiment(spec, ["pso", "random"], rounds=6, seeds=(0,),
                          progress=False, device="cpu", **kw)


# ---------------------------------------------------------------------------
# byte targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eval_config", [
    None,
    EvalConfig(),
    EvalConfig(recording="on"),
], ids=["default", "explicit-default", "recording-on"])
def test_fig3_byte_identical_to_golden(eval_config):
    res = _fig3_result(eval_config=eval_config)
    assert json.dumps(res.to_dict(), indent=1) == FIG3_GOLDEN


@pytest.mark.parametrize("name,rounds,mode", [
    ("large-1k", 5, "sequential"),
    ("large-1k", 5, "batched"),
    ("flash-crowd", 25, "sequential"),
    ("flash-crowd", 25, "batched"),
])
def test_sampling_off_byte_identical_to_golden(name, rounds, mode):
    res = run_experiment(name, ["pso", "random"], rounds=rounds, seeds=(0,),
                         progress=False, eval_config=EvalConfig(mode=mode),
                         device="cpu")
    got = json.dumps(res.to_dict(), indent=1, sort_keys=True)
    assert got == (GOLDEN / f"sampling_off_{name}.json").read_text()


def test_cli_run_writes_the_fig3_golden(tmp_path, capsys):
    out = tmp_path / "fig3.json"
    rc = cli_main(["run", "paper-fig3", "--set", "rounds=6", "--rounds",
                   "6", "--strategies", "pso,random", "--seeds", "0",
                   "--out", str(out), "--device", "cpu"])
    assert rc == 0
    assert out.read_text() == FIG3_GOLDEN
    assert "device=cpu" in capsys.readouterr().out
    assert cli_main(["validate", str(out)]) == 0


# ---------------------------------------------------------------------------
# the CLI's other commands and options
# ---------------------------------------------------------------------------
def test_cli_validate_flags_broken_artifacts(tmp_path, capsys):
    ok = tmp_path / "ok.json"
    ok.write_text(FIG3_GOLDEN)
    assert cli_main(["validate", str(ok)]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "garbage"}))
    assert cli_main(["validate", str(ok), str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out
    unreadable = tmp_path / "torn.json"
    unreadable.write_text("{")
    assert cli_main(["validate", str(unreadable)]) == 1


def test_cli_list(capsys):
    assert cli_main(["list"]) == 0
    text = capsys.readouterr().out
    for needle in ("paper-fig3", "paper-fig4", "two-tier", "chaos",
                   "pso", "config:"):
        assert needle in text


def test_cli_eval_overrides_and_mode_shim(tmp_path, capsys):
    out = tmp_path / "np.json"
    rc = cli_main(["run", "paper-fig3", "--strategies", "pso", "--rounds",
                   "3", "--set", "depth=2", "--set", "eval.backend=np",
                   "--mode", "sequential", "--out", str(out),
                   "--device", "cpu"])
    assert rc == 0
    d = json.loads(out.read_text())
    assert d["schema_version"] == 4 and d["eval"] == {"backend": "np"}
    assert d["scenario"]["depth"] == 2
    assert "--mode is deprecated" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="conflicting modes"):
        cli_main(["run", "paper-fig3", "--mode", "batched", "--set",
                  "eval.mode=sequential", "--device", "cpu"])
    with pytest.raises(SystemExit, match="eval.backend"):
        cli_main(["run", "paper-fig3", "--set", "eval.backend=pallas",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="no field"):
        cli_main(["run", "paper-fig3", "--set", "bogus=1", "--device",
                  "cpu"])


# ---------------------------------------------------------------------------
# EvalConfig: validation, provenance, overrides, deprecation shims
# ---------------------------------------------------------------------------
def test_eval_config_validates_fields():
    with pytest.raises(ValueError, match="eval.mode"):
        EvalConfig(mode="warp")
    for reference_only in ("jit", "pallas", "interpret", "cuda"):
        with pytest.raises(ValueError, match="eval.backend"):
            EvalConfig(backend=reference_only)
    for ported in (None, "np", "torch", "kernel"):
        assert EvalConfig(backend=ported).backend == ported
    with pytest.raises(ValueError, match="eval.shard"):
        EvalConfig(shard="maybe")
    with pytest.raises(ValueError, match="eval.recording"):
        EvalConfig(recording="sometimes")
    with pytest.raises(ValueError, match="calibration"):
        EvalConfig(cost_source="calibrated")  # needs a path
    with pytest.raises(ValueError, match="sequential"):
        EvalConfig(recording="on", mode="batched")


def test_eval_config_provenance_only_semantics_fields():
    assert EvalConfig().provenance() is None
    assert EvalConfig(mode="batched", shard="off").provenance() is None
    assert EvalConfig(recording="on").provenance() is None
    assert EvalConfig(backend="kernel").provenance() == {"backend": "kernel"}
    prov = EvalConfig(cost_source="calibrated",
                      calibration="cal.json").provenance()
    assert prov == {"cost_source": "calibrated", "calibration": "cal.json"}


def test_eval_config_with_overrides():
    ec = EvalConfig().with_overrides(mode="batched", backend="np")
    assert (ec.mode, ec.backend) == ("batched", "np")
    assert ec.with_overrides(backend="none").backend is None
    with pytest.raises(TypeError, match="no field"):
        EvalConfig().with_overrides(bogus=1)


def test_resolve_eval_config_shims():
    with pytest.warns(DeprecationWarning, match="eval_config"):
        ec = resolve_eval_config(None, mode="batched")
    assert ec.mode == "batched"
    with pytest.warns(DeprecationWarning):
        same = resolve_eval_config(EvalConfig(mode="batched"),
                                   mode="batched")
    assert same == EvalConfig(mode="batched")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicting"):
            resolve_eval_config(EvalConfig(mode="sequential"),
                                mode="batched")


def test_legacy_mode_kwarg_warns_and_stays_byte_identical():
    with pytest.warns(DeprecationWarning, match="eval.mode"):
        res = _fig3_result(mode="sequential")
    assert json.dumps(res.to_dict(), indent=1) == FIG3_GOLDEN


def test_pinned_backend_reaches_the_cost_model_and_the_artifact():
    env = get_scenario("paper-fig3").make_environment(
        0, eval_config=EvalConfig(backend="torch"), device="cpu")
    assert env.cost_model._default_backend == "torch"
    res = _fig3_result(eval_config=EvalConfig(backend="torch"))
    d = res.to_dict()
    assert d["schema_version"] == 4 and d["eval"] == {"backend": "torch"}
    assert validate_result_dict(d) == []
    # the pin changes no number of this sweep
    gold = json.loads(FIG3_GOLDEN)
    assert [r["tpds"] for r in d["runs"]] == \
        [r["tpds"] for r in gold["runs"]]


def test_calibrated_cost_source_names_its_roadmap_item(tmp_path):
    """The calibrated cost source (ROADMAP queue 1 item 9), once refused
    here, now builds the trace-fitted model; the executing tracks still
    refuse it, as the reference does."""
    from repro_torch.calibration import CalibrationResult
    from repro_torch.core.cost_model import CalibratedCostModel
    path = CalibrationResult(payload_scale=0.1, level_link=(0.002,),
                             train_scale=2.0).save(tmp_path / "cal.json")
    ec = EvalConfig(cost_source="calibrated", calibration=str(path))
    env = get_scenario("paper-fig3").make_environment(0, eval_config=ec,
                                                      device="cpu")
    assert isinstance(env.cost_model, CalibratedCostModel)
    with pytest.raises(ValueError, match="simulated"):
        get_scenario("paper-fig4").with_overrides(model="mlp-smoke") \
            .make_environment(0, eval_config=ec, device="cpu")


def test_legacy_make_environment_override_compat():
    """ScenarioSpec subclasses whose override predates the eval_config
    kwarg still run with a default evaluation surface, and fail loudly
    when the run configures one."""
    from repro_torch.experiments.environments import build_environment

    class LegacySpec(ScenarioSpec):
        def make_environment(self, seed=0, *, device="cuda"):
            return build_environment(self, seed, device=device)

    spec = LegacySpec(name="legacy", kind="simulated", depth=2, width=2,
                      rounds=2)
    run = run_single(spec, "random", seed=0, rounds=2, device="cpu")
    assert len(run.tpds) == 2
    with pytest.raises(ValueError, match="eval_config"):
        run_single(spec, "random", seed=0, rounds=2, device="cpu",
                   eval_config=EvalConfig(backend="np"))


# ---------------------------------------------------------------------------
# the lockstep batched sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario,strategies,rounds", [
    ("churn", ["pso", "random"], 20),
    ("drift", ["pso", "sa"], 20),
    ("ebb-and-flow", ["pso", "uniform"], 30),
])
def test_batched_runner_equals_sequential(scenario, strategies, rounds):
    a = run_experiment(scenario, strategies, rounds=rounds, seeds=(0, 1, 2),
                       progress=False, device="cpu",
                       eval_config=EvalConfig(mode="sequential"))
    b = run_experiment(scenario, strategies, rounds=rounds, seeds=(0, 1, 2),
                       progress=False, device="cpu",
                       eval_config=EvalConfig(mode="batched", shard="off"))
    assert [r.to_dict() for r in a.runs] == [r.to_dict() for r in b.runs]


def test_batched_runner_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="simulated-only"):
        run_experiment("paper-fig4", ["pso"], rounds=2, seeds=(0,),
                       progress=False, device="cpu",
                       eval_config=EvalConfig(mode="batched"))
    with pytest.raises(ValueError, match="batched"):
        run_batched(get_scenario("paper-fig3"), [("pso", None)], rounds=2,
                    seeds=(0,), device="cpu",
                    eval_config=EvalConfig(recording="on",
                                           mode="sequential"))

    class MetricEnv(SimulatedEnvironment):
        def step(self, round_idx, placement):
            obs = super().step(round_idx, placement)
            obs.metrics["extra"] = 1.0
            return obs

    class CustomSpec(ScenarioSpec):
        def make_environment(self, seed=0, eval_config=None, *,
                             device="cuda"):
            return MetricEnv(self.make_hierarchy(), self.make_pool(seed),
                             device=device)

    spec = CustomSpec(name="custom", kind="simulated", depth=2, width=2)
    with pytest.raises(ValueError, match="overrides"):
        run_batched(spec, [("pso", None)], seeds=(0,), rounds=2,
                    device="cpu")
    # the sequential loop still records the custom metric
    res = run_experiment(spec, ["pso"], rounds=2, seeds=(0,),
                         progress=False, device="cpu",
                         eval_config=EvalConfig(mode="sequential"))
    assert res.runs[0].metrics["extra"] == [1.0, 1.0]


def test_sharded_pooled_evaluation_names_its_roadmap_item():
    """The device-sharded pooled evaluation (ROADMAP.md queue 1 item
    12a): ``shard="on"`` through ``run_experiment`` gives the placements
    and TPDs of ``shard="off"`` (and of the reference's ``"off"``); on
    the host its float64 torch build is the numpy path op for op, so
    they are equal exactly."""
    env = get_scenario("paper-fig3").make_environment(0, device="cpu")
    placement = np.arange(env.hierarchy.dimensions)[None]
    ev = PooledTPDEvaluator([env.cost_model], shard="on")
    np.testing.assert_array_equal(
        ev.tpds(placement),
        PooledTPDEvaluator([env.cost_model], shard="off").tpds(placement))
    runs = {shard: run_experiment(
        "paper-fig3", ["pso", "random"], rounds=4, seeds=(0, 1),
        progress=False, device="cpu",
        eval_config=EvalConfig(mode="batched", shard=shard))
        for shard in ("on", "off")}
    on, off = (runs[k].to_dict()["strategies"] for k in ("on", "off"))
    assert on == off
    ref = ref_run_single(ref_get_scenario("paper-fig3"), "pso", seed=0,
                         rounds=4)
    got = runs["on"].runs[0]
    assert (got.strategy, got.seed) == ("pso", 0)
    assert list(got.tpds) == list(ref.tpds)
    assert got.metrics == ref.metrics


def test_result_round_trips_through_the_artifact(tmp_path):
    res = _fig3_result(eval_config=EvalConfig(mode="batched"))
    path = res.save(tmp_path / "fig3.json")
    assert path.read_text() == FIG3_GOLDEN
    back = ExperimentResult.load(path)
    assert json.dumps(back.to_dict(), indent=1) == FIG3_GOLDEN


# ---------------------------------------------------------------------------
# simulated timing recording
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,rounds", [("paper-fig3", 4),
                                         ("two-tier", 3),
                                         ("large-100k", 2)])
def test_recorded_timings_equal_the_reference(name, rounds):
    want, got = [], []
    ref_run_single(ref_get_scenario(name), "pso", seed=0, rounds=rounds,
                   eval_config=_ref_recording(),
                   on_observation=lambda o: want.append(o.timings))
    run_single(get_scenario(name), "pso", seed=0, rounds=rounds,
               eval_config=EvalConfig(recording="on"), device="cpu",
               on_observation=lambda o: got.append(o.timings))
    assert len(got) == rounds
    assert json.dumps(got) == json.dumps(want)
    for t in got:
        assert sorted(t) == ["agg_time", "levels", "train", "train_time"]
        for row in t["levels"]:
            assert sorted(row) == ["delays", "hosts", "level", "loads",
                                   "n_parts", "slots"]


def test_recording_off_leaves_timings_empty():
    seen = []
    run_single(get_scenario("paper-fig3"), "pso", seed=0, rounds=2,
               device="cpu", on_observation=lambda o: seen.append(o.timings))
    assert seen == [{}, {}]


def _ref_recording():
    from repro.experiments import EvalConfig as RefEvalConfig
    return RefEvalConfig(recording="on")
