"""Trace calibration and the calibrated cost model: port vs reference,
on the CPU.

* The trace (deterministic timing: numpy) of a recorded emulated run is
  the reference's JSON byte for byte; the least-squares fit of it equals
  the reference's fit exactly, and so do the replay reports.
* ``CalibratedCostModel``: the scalar ``tpd`` and the float64 / float32
  numpy ``batch_tpd`` equal the reference's exactly (duplicate-id rows,
  uniform and heterogeneous payloads); the torch build is within rtol
  1e-6 of the reference's jit build and 2e-5 of the float64 scalar
  model, the tolerances ``tests/test_torch_tpd.py`` holds the analytic
  builds to. Neutral terms are bit-equal to ``CostModel``.
* The CUDA TPD kernel does not price calibrated terms: the gate never
  picks it for a calibrated model and ``backend="kernel"`` is refused.
* The calibration CLI writes the reference CLI's trace and fit bytes;
  ``EvalConfig(cost_source="calibrated")`` builds the calibrated model
  and its Fig. 3 artifact equals the reference's.
"""
import json

import numpy as np
import pytest

from repro.calibration import ANALYTIC as REF_ANALYTIC
from repro.calibration import batch_predict_cluster_delay as ref_batch_predict
from repro.calibration import fit_calibration as ref_fit
from repro.calibration import record_trace as ref_record
from repro.calibration import replay as ref_replay
from repro.calibration.cli import main as ref_cal_main
from repro.calibration.replay import format_report as ref_format_report
from repro.core.cost_model import CalibratedCostModel as RefCalibrated
from repro.core.cost_model import CostModel as RefCostModel
from repro.core.cost_model import PooledTPDEvaluator as RefPooled
from repro.core.hierarchy import ClientPool as RefPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.experiments import EvalConfig as RefEvalConfig
from repro.experiments import get_scenario as ref_get_scenario
from repro.experiments import run_experiment as ref_run_experiment
from repro_torch.calibration import (
    ANALYTIC,
    CalibrationResult,
    TraceArtifact,
    batch_predict_cluster_delay,
    fit_calibration,
    load_calibration,
    record_trace,
    replay,
    validate_trace_dict,
)
from repro_torch.calibration.cli import main as cal_main
from repro_torch.calibration.fit import _predict_cluster_delay_ref
from repro_torch.calibration.replay import format_report
from repro_torch.core.cost_model import CalibratedCostModel, CostModel, PooledTPDEvaluator
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.experiments import EvalConfig, get_scenario, run_experiment
from repro_torch.fl.orchestrator import FederatedOrchestrator

SMOKE = {"model": "mlp-smoke", "local_steps": 1, "batch_size": 16}
RTOL_JIT = 1e-6
RTOL_SCALAR = 2e-5

# (depth, width, trainers_per_leaf, n_clients, penalty)
TREES = [(3, 2, 2, 24, 0.0), (4, 3, 2, 120, 2.0), (5, 3, 2, 1024, 1.5)]
# (payload_scale, level_link, train_scale): a fit's shape, link betas
# for fewer levels than the tree has, scale only, train only
TERMS = [(0.1, (0.002, 0.003, 0.0025), 2.0), (0.37, (0.01,), 0.0),
         (2.5, (), 0.0), (1.0, (), 3.0)]


@pytest.fixture(scope="module")
def traces():
    """The same 4-round paper-fig4 trace from both packages."""
    port = record_trace(get_scenario("paper-fig4").with_overrides(**SMOKE),
                        "pso", seed=0, rounds=4, device="cpu")
    ref = ref_record(ref_get_scenario("paper-fig4").with_overrides(**SMOKE),
                     "pso", seed=0, rounds=4)
    return port, ref


# ---------------------------------------------------------------------------
# record / fit / replay against the reference
# ---------------------------------------------------------------------------
def test_trace_json_equals_reference_byte_for_byte(traces, tmp_path):
    port, ref = traces
    assert port.to_json() == ref.to_json()
    p1 = port.save(tmp_path / "port.json")
    p2 = ref.save(tmp_path / "ref.json")
    assert p1.read_bytes() == p2.read_bytes()
    back = TraceArtifact.load(p1)
    assert back.save(tmp_path / "again.json").read_bytes() == \
        p1.read_bytes()


def test_trace_schema_validation(traces):
    d = traces[0].to_dict()
    assert validate_trace_dict(d) == []
    assert any("schema_version" in e for e in validate_trace_dict(
        dict(d, schema_version=99)))
    assert any("records" in e for e in validate_trace_dict(
        dict(d, records=d["records"][:-1])))
    with pytest.raises(ValueError, match="invalid trace"):
        TraceArtifact.from_dict({"schema": "nope"})


def test_record_refuses_non_stationary_scenarios():
    with pytest.raises(ValueError, match="events"):
        record_trace("flash-crowd", "pso", rounds=2, device="cpu")
    with pytest.raises(ValueError, match="faults"):
        record_trace("online-faulty", "pso", rounds=2, device="cpu")
    with pytest.raises(ValueError, match="cohort"):
        record_trace("large-100k", "pso", rounds=2, device="cpu")


@pytest.mark.parametrize("holdout", [0, 1, 3])
def test_fit_equals_reference_exactly(traces, holdout):
    port, ref = traces
    cal = fit_calibration(port, holdout_rounds=holdout)
    assert cal.to_dict() == ref_fit(ref, holdout_rounds=holdout).to_dict()
    # the engine's constants: 1 / EQ6_PAYLOAD_SCALE, comm_latency, and
    # the local step count
    spec = get_scenario("paper-fig4").with_overrides(**SMOKE)
    assert cal.payload_scale == pytest.approx(
        1.0 / FederatedOrchestrator.EQ6_PAYLOAD_SCALE, abs=1e-9)
    assert all(b == pytest.approx(spec.comm_latency, abs=1e-9)
               for b in cal.level_link)
    assert cal.train_scale == pytest.approx(spec.local_steps, abs=1e-9)
    with pytest.raises(ValueError, match="no fitting rounds"):
        fit_calibration(port, holdout_rounds=len(port.records))
    with pytest.raises(ValueError, match=">= 0"):
        fit_calibration(port, holdout_rounds=-1)


@pytest.mark.parametrize("which,rounds", [("analytic", None),
                                          ("fitted", None),
                                          ("fitted", [3]),
                                          ("fitted", [0, 2])])
def test_replay_equals_reference(traces, which, rounds):
    port, ref = traces
    cal = ANALYTIC if which == "analytic" else \
        fit_calibration(port, holdout_rounds=1)
    ref_cal = REF_ANALYTIC if which == "analytic" else \
        ref_fit(ref, holdout_rounds=1)
    got = replay(port, cal, rounds=rounds)
    want = ref_replay(ref, ref_cal, rounds=rounds)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert format_report(which, got) == ref_format_report(which, want)
    if which == "fitted" and rounds == [3]:
        assert got.mean_abs_error < replay(port, ANALYTIC,
                                           rounds=rounds).mean_abs_error


def test_calibration_save_load_round_trip(traces, tmp_path):
    cal = fit_calibration(traces[0])
    assert load_calibration(cal.save(tmp_path / "cal.json")) == cal
    with pytest.raises(ValueError, match="not a calibration"):
        CalibrationResult.from_dict({"schema": "nope"})


def test_batch_predict_equals_reference_and_scalar_oracle(traces):
    cal = fit_calibration(traces[0])
    rng = np.random.default_rng(11)
    n = 64
    loads = rng.uniform(1.0, 200.0, n)
    pspeed = rng.uniform(5.0, 15.0, n)
    n_parts = rng.integers(1, 9, n)
    levels = rng.integers(0, len(cal.level_link) + 2, n)   # incl. unseen
    got = batch_predict_cluster_delay(loads, pspeed, n_parts, levels, cal)
    assert np.array_equal(got, ref_batch_predict(
        loads, pspeed, n_parts, levels, ref_fit(traces[1])))
    for i in range(n):
        assert got[i] == pytest.approx(_predict_cluster_delay_ref(
            loads[i], pspeed[i], int(n_parts[i]), int(levels[i]), cal),
            rel=1e-12)


def test_cost_model_from_trace_equals_reference(traces):
    port, ref = traces
    cm = CostModel.from_trace(port, device="cpu")
    want = RefCostModel.from_trace(ref)
    assert isinstance(cm, CalibratedCostModel)
    assert cm.device.type == "cpu"
    for rec in port.records:
        p = np.asarray(rec["placement"])
        assert cm.tpd(p) == want.tpd(p)
        assert cm.tpd(p) == pytest.approx(
            rec["train_time"] + rec["agg_time"], abs=1e-8)


# ---------------------------------------------------------------------------
# CalibratedCostModel against the reference
# ---------------------------------------------------------------------------
def _pair(depth, width, tpl, n, penalty, terms, uniform=False, seed=0):
    rng = np.random.default_rng(seed)
    ref_pool = RefPool.random(n, seed=seed)
    ref_pool.mdatasize = np.full(n, 7.0) if uniform \
        else rng.uniform(1.0, 40.0, n)
    pool = ClientPool(memcap=ref_pool.memcap.copy(),
                      pspeed=ref_pool.pspeed.copy(),
                      mdatasize=ref_pool.mdatasize.copy())
    scale, link, train = terms
    kw = dict(memory_penalty=penalty, payload_scale=scale, level_link=link,
              train_scale=train)
    ref = RefCalibrated(RefHierarchy(depth=depth, width=width,
                                     trainers_per_leaf=tpl, n_clients=n),
                        ref_pool, **kw)
    port = CalibratedCostModel(Hierarchy(depth=depth, width=width,
                                         trainers_per_leaf=tpl, n_clients=n),
                               pool, device="cpu", **kw)
    return ref, port


def _placements(h, n, seed=1):
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.permutation(h.total_clients)[:h.dimensions]
                   for _ in range(n)])
    ps[0, -1] = ps[0, 0]                 # a duplicate id
    ps[1, 1:] = ps[1, 0]                 # one host everywhere
    return ps


@pytest.mark.parametrize("uniform", [False, True], ids=["hetero", "uniform"])
@pytest.mark.parametrize("terms", TERMS, ids=[f"t{i}" for i in range(4)])
@pytest.mark.parametrize("tree", TREES, ids=[f"C{t[3]}" for t in TREES])
def test_calibrated_numpy_paths_equal_reference(tree, terms, uniform):
    ref, port = _pair(*tree, terms, uniform=uniform)
    ps = _placements(port.hierarchy, 12)
    for p in ps:
        assert port.tpd(p) == ref.tpd(p)
        assert port.tpd_fast(p) == ref.tpd_fast(p)
    for rows in (ps, ps[2:]):   # with and without duplicate-id rows
        got = port.batch_tpd(rows, backend="np")
        want = ref.batch_tpd(rows, backend="np")
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("terms", TERMS, ids=[f"t{i}" for i in range(4)])
@pytest.mark.parametrize("tree", TREES, ids=[f"C{t[3]}" for t in TREES])
def test_calibrated_torch_build_matches_reference_jit(tree, terms):
    ref, port = _pair(*tree, terms)
    ps = _placements(port.hierarchy, 40)
    got = port.batch_tpd(ps, backend="torch")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref.batch_tpd(ps, backend="jit"),
                               rtol=RTOL_JIT, atol=0)
    np.testing.assert_allclose(got, [port.tpd(p) for p in ps],
                               rtol=RTOL_SCALAR, atol=0)


@pytest.mark.parametrize("tree", TREES, ids=[f"C{t[3]}" for t in TREES])
def test_neutral_terms_are_the_base_model_bit_for_bit(tree):
    _, port = _pair(*tree, (1.0, (), 0.0))
    base = CostModel(port.hierarchy, port.clients, device="cpu",
                     memory_penalty=port.memory_penalty)
    ps = _placements(port.hierarchy, 16)
    for backend in ("np", "torch"):
        assert np.array_equal(port.batch_tpd(ps, backend=backend),
                              base.batch_tpd(ps, backend=backend))
    for p in ps[:4]:
        assert port.tpd(p) == base.tpd(p)
        assert port.tpd_fast(p) == base.tpd_fast(p)
    assert port._kernel_covers() and base._kernel_covers()


def test_kernel_refuses_calibrated_terms():
    _, port = _pair(*TREES[1], TERMS[0])
    assert not port._kernel_covers() and not port._kernel_ok()
    ps = _placements(port.hierarchy, 4)
    with pytest.raises(ValueError, match="trace-calibrated"):
        port.batch_tpd(ps, backend="kernel")
    port.set_default_backend("kernel")
    with pytest.raises(ValueError, match="trace-calibrated"):
        port.batch_tpd(ps)
    for terms in TERMS[1:]:
        assert not _pair(*TREES[0], terms)[1]._kernel_covers()


def test_pooled_evaluator_under_calibration_equals_reference():
    ref_models, models = [], []
    for seed in range(3):
        r, p = _pair(*TREES[1], TERMS[0], seed=seed)
        ref_models.append(r)
        models.append(p)
    ps = _placements(models[0].hierarchy, 3)
    got = PooledTPDEvaluator(models, shard="off").tpds(ps)
    assert np.array_equal(got, RefPooled(ref_models, shard="off").tpds(ps))
    for i, p in enumerate(ps):
        assert got[i] == models[i].tpd_fast(p)
    other = _pair(*TREES[1], TERMS[1], seed=5)[1]
    with pytest.raises(ValueError, match="calibration"):
        PooledTPDEvaluator([models[0], other])


# ---------------------------------------------------------------------------
# the CLI and EvalConfig threading
# ---------------------------------------------------------------------------
def test_calibration_cli_round_trip_writes_the_reference_bytes(tmp_path):
    args = ["--rounds", "3", "--set", "model=mlp-smoke",
            "--set", "local_steps=1", "--set", "batch_size=16"]
    files = {}
    for tag, main, extra in (("port", cal_main, ["--device", "cpu"]),
                             ("ref", ref_cal_main, [])):
        trace, cal = tmp_path / f"{tag}_trace.json", tmp_path / f"{tag}.json"
        assert main(["record", "paper-fig4", *args, *extra,
                     "--out", str(trace)]) == 0
        assert main(["validate", str(trace)]) == 0
        assert main(["fit", str(trace), "--holdout", "1",
                     "--out", str(cal)]) == 0
        assert main(["replay", str(trace), "--calibration", str(cal),
                     "--rounds", "2", "--out",
                     str(tmp_path / f"{tag}_replay.json")]) == 0
        assert main(["report", str(trace), "--holdout", "1",
                     "--rounds", "2"]) == 0
        files[tag] = [trace, cal, tmp_path / f"{tag}_replay.json"]
    for a, b in zip(files["port"], files["ref"], strict=True):
        assert a.read_bytes() == b.read_bytes()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    assert cal_main(["validate", str(bad)]) == 1


def test_calibrated_cost_source_threads_into_the_simulated_track(
        traces, tmp_path):
    path = str(fit_calibration(traces[0]).save(tmp_path / "cal.json"))
    ec = EvalConfig(cost_source="calibrated", calibration=path)
    env = get_scenario("paper-fig3").make_environment(0, eval_config=ec,
                                                      device="cpu")
    assert isinstance(env.cost_model, CalibratedCostModel)
    assert env.cost_model.device.type == "cpu"
    assert env.cost_model.payload_scale == \
        load_calibration(path).payload_scale
    with pytest.raises(ValueError, match="simulated"):
        get_scenario("paper-fig4").with_overrides(**SMOKE) \
            .make_environment(0, eval_config=ec, device="cpu")
    with pytest.raises(ValueError, match="two-tier"):
        get_scenario("two-tier").make_environment(0, eval_config=ec,
                                                  device="cpu")


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_calibrated_fig3_artifact_equals_reference(traces, tmp_path, mode):
    path = str(fit_calibration(traces[0]).save(tmp_path / "cal.json"))
    spec = get_scenario("paper-fig3").with_overrides(rounds=6)
    got = run_experiment(spec, ["pso", "random"], rounds=6, seeds=(0,),
                         progress=False, device="cpu",
                         eval_config=EvalConfig(
                             mode=mode, cost_source="calibrated",
                             calibration=path))
    want = ref_run_experiment(
        ref_get_scenario("paper-fig3").with_overrides(rounds=6),
        ["pso", "random"], rounds=6, seeds=(0,), progress=False,
        eval_config=RefEvalConfig(mode=mode, cost_source="calibrated",
                                  calibration=path))
    assert json.dumps(got.to_dict(), indent=1) == \
        json.dumps(want.to_dict(), indent=1)
    assert got.to_dict()["eval"]["cost_source"] == "calibrated"
    analytic = run_experiment(spec, ["pso"], rounds=6, seeds=(0,),
                              progress=False, device="cpu")
    assert analytic.runs[0].tpds != got.runs[0].tpds


def test_eval_config_points_at_the_port_cli():
    with pytest.raises(ValueError, match="repro_torch.calibration fit"):
        EvalConfig(cost_source="calibrated")
