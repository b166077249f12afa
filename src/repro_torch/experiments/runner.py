"""The multi-seed sweep runner: every strategy x scenario x seed
combination through ONE propose/observe loop.

    from repro_torch.experiments import run_experiment
    result = run_experiment("paper-fig4", ["pso", "random", "uniform"],
                            rounds=50, seeds=[0])
    result.save("artifacts/experiments/fig4.json")

The port of the sequential half of ``repro.experiments.runner``
(``run_single`` and ``run_experiment``): one ``run_single``
propose/observe loop per (strategy, seed), each against its own
environment, built on the caller's ``device`` (``cuda`` unless
``device="cpu"``). Strategies may be plain names (``"pso"``),
``(name, {overrides})`` pairs, or ``(name, ConfigInstance)``, all
resolved through the typed strategy registry.

Not ported yet: the lockstep batched mode (``run_batched`` and its
``PooledTPDEvaluator``; the reference proves it bit-identical to the
sequential loop, so every sweep here runs sequentially), ``EvalConfig``
(ROADMAP.md queue 1 item 9), and checkpoint/resume (item 8).
"""
from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.registry import build_config, create_strategy, resolve_strategy
from repro_torch.experiments.results import ExperimentResult, StrategyRun
from repro_torch.experiments.scenarios import ScenarioSpec, ScheduledEvent, get_scenario

StrategyLike = Union[str, Tuple[str, dict], Tuple[str, object]]

# event rng stream tag: keeps event randomness decoupled from every
# strategy/pool stream (a run without events is bit-identical to the
# pre-events code path)
_EVENT_STREAM = 0xE7E47


def _normalize_strategies(strategies: Iterable[StrategyLike]):
    """-> [(canonical_name, config_overrides_or_instance)]"""
    if isinstance(strategies, str):
        strategies = [s for s in strategies.split(",") if s]
    out = []
    for s in strategies:
        if isinstance(s, str):
            name, cfg = s, None
        else:
            name, cfg = s
        info = resolve_strategy(name)
        if isinstance(cfg, dict):
            cfg = build_config(info.name, cfg)  # validate early
        out.append((info.name, cfg))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate strategies in sweep: {names}")
    return out


def _finalize_run(run: StrategyRun, strategy) -> StrategyRun:
    """End-of-run strategy internals -> diagnostics."""
    if hasattr(strategy, "reignitions"):
        run.diagnostics["reignitions"] = int(strategy.reignitions)
    pso = getattr(strategy, "pso", None)
    if pso is not None:
        run.diagnostics["evaluations"] = int(pso.evaluations)
        run.diagnostics["converged"] = bool(pso.converged)
        if pso.migrations:  # elastic runs only: static artifacts stay put
            run.diagnostics["migrations"] = int(pso.migrations)
    return run


def _sync_topology(env, strategy, events, run: StrategyRun,
                   round_idx: int, verbose: bool) -> None:
    """Per-round elastic step: reconcile the environment's topology with
    the pool the round's events just mutated, migrate the strategy
    across any update, and let stateful events re-key their
    client-indexed state."""
    sync = getattr(env, "sync_topology", None)
    update = sync() if sync is not None else None
    if update is not None:
        run.event_log.append(f"r{round_idx}: {update.describe()}")
        if verbose:
            print(f"    [event s{run.seed}] r{round_idx}: "
                  f"{update.describe()}")
        strategy.migrate(update)
        for ev in events:
            ev.on_topology(update)


def _has_observer_noise(events) -> bool:
    """Does any event distort the observed signal? (then the artifact
    carries BOTH series: tpds = true realized cost, metrics
    observed_tpd = what the strategy was shown)"""
    return any(
        type(ev).transform_tpd is not ScheduledEvent.transform_tpd
        for ev in events)


def run_single(spec: ScenarioSpec, strategy_name: str, *, seed: int = 0,
               rounds: Optional[int] = None, config=None,
               verbose: bool = False,
               capture_state: bool = False,
               checkpoint_dir: Optional[str] = None,
               resume: bool = False,
               on_observation=None,
               device="cuda") -> StrategyRun:
    """One (strategy, seed) trajectory through a fresh environment on
    ``device``.

    THE sequential loop — both paper tracks and every event scenario go
    through it. Elastic scenarios interleave a topology sync after each
    round's events: pool resizes re-hierarchize the environment and the
    strategy migrates across the update before proposing.
    ``capture_state=True`` snapshots the strategy's full checkpoint into
    ``run.strategy_state`` at the end. ``on_observation`` (a callable
    taking each round's :class:`RoundObservation`) is invoked after the
    strategy observes; it must not mutate the observation.
    """
    if checkpoint_dir is not None or resume:
        raise NotImplementedError(
            "run checkpoint/resume comes with ROADMAP.md queue 1 item 8 "
            "(checkpoint/store.py)")
    rounds = rounds if rounds is not None else spec.rounds
    env = spec.make_environment(seed, device=device)
    kw = {"config": config} if config is not None else {}
    strategy = create_strategy(strategy_name, env.hierarchy, seed=seed,
                               clients=env.clients,
                               cost_model=env.cost_model, **kw)
    events = spec.make_events()
    erng = np.random.default_rng((seed, _EVENT_STREAM))
    has_observer_noise = _has_observer_noise(events)
    elastic = spec.is_elastic
    run = StrategyRun(strategy=strategy.name, seed=seed)

    env.begin()
    # sampled environments expose the RESIDENT pool for events (churn /
    # joins hit the population, not just this round's cohort)
    event_pool = getattr(env, "event_pool", env.clients)
    for r in range(rounds):
        for ev in events:
            msg = ev.on_round(r, event_pool, erng)
            if msg:
                run.event_log.append(f"r{r}: {msg}")
                if verbose:
                    print(f"    [event] r{r}: {msg}")
        _sync_topology(env, strategy, events, run, r, verbose)
        placement = np.asarray(strategy.propose(r), np.int64)
        obs = env.step(r, placement)
        observed = obs.tpd
        for ev in events:
            observed = ev.transform_tpd(r, observed, erng)
        # the strategy sees the (possibly noisy) observation; the
        # artifact's headline tpds are the TRUE realized cost
        strategy.observe(placement, observed)
        run.tpds.append(float(obs.tpd))
        if has_observer_noise:
            run.metrics.setdefault("observed_tpd", []).append(
                float(observed))
        if elastic:
            run.metrics.setdefault("topology_version", []).append(
                float(obs.topology_version))
            run.metrics.setdefault("n_clients", []).append(
                float(len(env.clients)))
        for k, v in obs.metrics.items():
            run.metrics.setdefault(k, []).append(float(v))
        for line in obs.log:
            run.event_log.append(f"r{r}: {line}")
        if on_observation is not None:
            on_observation(obs)
        if verbose:
            extra = "".join(f" {k}={v:.3f}" for k, v in obs.metrics.items()
                            if k in ("loss", "accuracy"))
            print(f"    [{strategy.name}] r{r:3d} "
                  f"tpd={obs.tpd:8.4f}{extra}")

    _finalize_run(run, strategy)
    if capture_state:
        run.save_state(strategy)
    return run


def run_experiment(scenario: Union[str, ScenarioSpec],
                   strategies: Iterable[StrategyLike],
                   rounds: Optional[int] = None,
                   seeds: Sequence[int] = (0,), *,
                   verbose: bool = False,
                   progress: bool = True,
                   mode: Optional[str] = None,
                   device="cuda") -> ExperimentResult:
    """Sweep ``strategies`` x ``seeds`` over one scenario on ``device``.

    ``scenario`` is a registered preset name or a ScenarioSpec (e.g. a
    preset with overrides). ``mode`` ``None``/``"auto"``/
    ``"sequential"`` all run the sequential loop; ``"batched"`` (the
    reference's lockstep mode) is not ported yet and raises. Returns the
    versioned :class:`ExperimentResult`; call ``.save(path)`` for the
    artifact.
    """
    if mode not in (None, "auto", "sequential"):
        raise NotImplementedError(
            f"mode={mode!r}: the lockstep batched sweep (run_batched, "
            f"PooledTPDEvaluator) is not ported yet (ROADMAP.md queue 1 "
            f"item 5); use mode='sequential'")
    spec = get_scenario(scenario) if isinstance(scenario, str) else scenario
    rounds = rounds if rounds is not None else spec.rounds
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("need at least one seed")
    norm = _normalize_strategies(strategies)
    result = ExperimentResult(
        scenario=spec.to_dict(), rounds=rounds, seeds=seeds,
        strategies=[n for n, _ in norm])
    for name, cfg in norm:
        t0 = time.perf_counter()
        for seed in seeds:
            run = run_single(spec, name, seed=seed, rounds=rounds,
                             config=cfg, verbose=verbose, device=device)
            result.runs.append(run)
        if progress:
            agg = aggregate_line(result, name)
            print(f"  {name:12s} {agg} "
                  f"[{time.perf_counter() - t0:6.2f}s wall]")
    return result


def aggregate_line(result: ExperimentResult, strategy: str) -> str:
    """One human-readable summary line for a strategy's aggregate."""
    from repro_torch.experiments.results import aggregate_runs
    a = aggregate_runs(result.runs_for(strategy))
    line = (f"total TPD {a['total_tpd']:9.2f} (±{a['total_tpd_std']:.2f}) "
            f"mean {a['mean_tpd']:7.3f} last10 {a['last10_mean_tpd']:7.3f}")
    if "final_accuracy" in a:
        line += f" acc {a['final_accuracy']:.3f}"
    return line
