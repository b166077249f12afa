"""The multi-seed sweep runner: every strategy x scenario x seed
combination through ONE propose/observe loop.

    from repro_torch.experiments import run_experiment
    result = run_experiment("paper-fig4", ["pso", "random", "uniform"],
                            rounds=50, seeds=[0])
    result.save("artifacts/experiments/fig4.json")

The port of ``repro.experiments.runner``; every run is built on the
caller's ``device`` (``cuda`` unless ``device="cpu"``). Strategies may
be plain names (``"pso"``), ``(name, {overrides})`` pairs, or ``(name,
ConfigInstance)``, all resolved through the typed strategy registry.

Two execution modes produce bit-identical artifacts:

* **sequential** — one ``run_single`` propose/observe loop per
  (strategy, seed), each against its own environment. The only mode for
  emulated scenarios (elastic and faulty ones included); it can
  checkpoint a run and resume it bit-identically.
* **batched** — every (strategy, seed) run of a simulated sweep advances
  in lockstep: per round, the runs' proposed placements are scored in
  ONE exact :class:`~repro_torch.core.cost_model.PooledTPDEvaluator`
  call (placement row i against run i's own drifting client pool)
  instead of one ``env.step`` each. Elastic scenarios group the rows
  into *topology cohorts* — runs whose hierarchy diverged under
  join/leave events score in separate pooled calls.

``EvalConfig(mode="auto")`` (the default) picks batched for simulated
scenarios and sequential for emulated ones.
"""
from __future__ import annotations

import inspect
import json
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.checkpoint.store import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.cost_model import PooledTPDEvaluator
from repro_torch.core.hierarchy import rows_with_duplicates
from repro_torch.core.registry import build_config, create_strategy, resolve_strategy
from repro_torch.experiments.eval_config import EvalConfig, resolve_eval_config
from repro_torch.experiments.results import ExperimentResult, StrategyRun
from repro_torch.experiments.scenarios import ScenarioSpec, ScheduledEvent, get_scenario

StrategyLike = Union[str, Tuple[str, dict], Tuple[str, object]]

# event rng stream tag: keeps event randomness decoupled from every
# strategy/pool stream (a run without events is bit-identical to the
# pre-events code path)
_EVENT_STREAM = 0xE7E47


def _spec_environment(spec: ScenarioSpec, seed: int, eval_config, device):
    """Build one run's environment on ``device``, tolerating ScenarioSpec
    subclasses whose ``make_environment(seed, *, device)`` override
    predates the ``eval_config`` kwarg. Such overrides can't honor a
    non-default evaluation surface, so those combinations fail loudly
    instead of silently dropping the config."""
    params = inspect.signature(spec.make_environment).parameters
    if "eval_config" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values()):
        return spec.make_environment(seed, eval_config=eval_config,
                                     device=device)
    if eval_config is not None and (eval_config.provenance() is not None
                                    or eval_config.recording == "on"):
        raise ValueError(
            f"{type(spec).__name__}.make_environment() does not accept "
            f"eval_config=, but this run configures the evaluation "
            f"surface ({eval_config!r}); add the kwarg to the override")
    return spec.make_environment(seed, device=device)


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
    """End-of-run strategy internals -> diagnostics (both modes)."""
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
    """Shared per-round elastic step (both modes, identical order):
    reconcile the environment's topology with the pool the round's
    events just mutated, migrate the strategy across any update, and
    let stateful events re-key their client-indexed state."""
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


def _save_run_state(directory: str, step: int, env, strategy, events,
                    erng, run: StrategyRun) -> None:
    """Snapshot EVERYTHING one (strategy, seed) run holds at a round
    boundary: model params + in-flight update trees go through the
    atomic npz store; env/event/strategy/rng bookkeeping rides in the
    JSON ``extra`` sidecar. The snapshot is read-only — taking it never
    perturbs the run (the no-perturbation and resume bit-identity
    tests pin both)."""
    orch = getattr(env, "orchestrator", None)
    tree = {}
    if orch is not None:
        tree["params"] = orch.params
    store = getattr(env, "_store", None) or {}
    store_keys = []
    for c, v in sorted(store):
        tree[f"store_{c}_{v}"] = store[(c, v)]
        store_keys.append([int(c), int(v)])
    pool = env.clients
    extra = {
        "round_next": int(step),
        "env": env.checkpoint_state(),
        "store_keys": store_keys,
        "pool": {"memcap": [float(x) for x in pool.memcap],
                 "pspeed": [float(x) for x in pool.pspeed],
                 "mdatasize": [float(x) for x in pool.mdatasize]},
        "events": [ev.state_dict() for ev in events],
        "erng": erng.bit_generator.state,
        "strategy": strategy.save_state(),
        "run": run.to_dict(),
    }
    save_checkpoint(directory, step, tree, extra)


def _restore_run_state(directory: str, env, strategy, events, erng):
    """Inverse of :func:`_save_run_state` into freshly constructed run
    objects (call after ``env.begin()``; warmup consumes no rng, so the
    restored streams continue exactly where the snapshot left them).
    Params and in-flight update trees come back as float32 tensors on
    the run's device, bit for bit. Returns ``(round_next, run)``."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    meta = json.loads(
        (Path(directory) / f"step_{step:08d}" / "meta.json").read_text())
    extra = meta["extra"]
    orch = getattr(env, "orchestrator", None)
    template = {}
    if orch is not None:
        template["params"] = orch.params
    for c, v in extra["store_keys"]:
        template[f"store_{c}_{v}"] = orch.params
    tree, _ = restore_checkpoint(directory, template, step)
    pool = env.clients
    pool.memcap[:] = np.asarray(extra["pool"]["memcap"], np.float64)
    pool.pspeed[:] = np.asarray(extra["pool"]["pspeed"], np.float64)
    pool.mdatasize[:] = np.asarray(extra["pool"]["mdatasize"], np.float64)
    pool.touch()
    if orch is not None:
        orch.set_global(tree["params"])
    store = {(int(c), int(v)): tree[f"store_{c}_{v}"]
             for c, v in extra["store_keys"]}
    env.restore_state(extra["env"], store)
    for ev, st in zip(events, extra["events"], strict=True):
        ev.load_state(st)
    erng.bit_generator.state = extra["erng"]
    strategy.load_state(extra["strategy"])
    run = StrategyRun.from_dict(extra["run"])
    return int(extra["round_next"]), run


def run_single(spec: ScenarioSpec, strategy_name: str, *, seed: int = 0,
               rounds: Optional[int] = None, config=None,
               verbose: bool = False,
               capture_state: bool = False,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 1,
               resume: bool = False,
               eval_config: Optional[EvalConfig] = None,
               on_observation=None,
               device="cuda") -> StrategyRun:
    """One (strategy, seed) trajectory through a fresh environment on
    ``device``.

    This is THE sequential loop — both paper tracks and every event
    scenario go through it (the batched mode below is its lockstep
    equivalent, parity-pinned against it). Elastic scenarios interleave
    a topology sync after each round's events: pool resizes
    re-hierarchize the environment and the strategy migrates across the
    update before proposing. ``capture_state=True`` snapshots the
    strategy's full checkpoint into ``run.strategy_state`` at the end
    (sweep resume).

    ``eval_config`` (an :class:`EvalConfig`) selects the evaluation
    surface — cost source, backend pin, timing recording; it is handed
    to ``spec.make_environment``. ``on_observation`` (a callable taking
    each round's :class:`RoundObservation`) is invoked after the
    strategy observes; it must not mutate the observation.

    ``checkpoint_dir`` turns on periodic FULL-run checkpointing (every
    ``checkpoint_every`` round boundaries, through the atomic
    ``repro_torch.checkpoint`` store): model params, in-flight update
    trees (host float32 in the npz, back on the run's device on
    restore), the environment's event queue/buffers/fault state, event +
    rng + strategy state. ``resume=True`` restores
    the latest snapshot and continues — a run killed at round r resumes bit-identically to the
    uninterrupted run (the fault-track acceptance pin). Elastic
    scenarios are refused: a resize swaps the hierarchy out from under
    the snapshot.
    """
    rounds = rounds if rounds is not None else spec.rounds
    if checkpoint_dir is not None or resume:
        if spec.is_elastic:
            raise ValueError(
                f"checkpointing does not support elastic scenarios "
                f"(scenario {spec.name!r} schedules pool resizes)")
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True needs a checkpoint_dir")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
    env = _spec_environment(spec, seed, eval_config, device)
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
    start_round = 0
    if resume:
        start_round, run = _restore_run_state(checkpoint_dir, env,
                                              strategy, events, erng)
    # sampled environments expose the RESIDENT pool for events (churn /
    # joins hit the population, not just this round's cohort)
    event_pool = getattr(env, "event_pool", env.clients)
    for r in range(start_round, rounds):
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
        if checkpoint_dir is not None and (r + 1) % checkpoint_every == 0:
            _save_run_state(checkpoint_dir, r + 1, env, strategy,
                            events, erng, run)

    _finalize_run(run, strategy)
    if capture_state:
        run.save_state(strategy)
    return run


def run_batched(spec: ScenarioSpec,
                strategies: Sequence[Tuple[str, object]], *,
                seeds: Sequence[int], rounds: Optional[int] = None,
                verbose: bool = False,
                shard: Optional[str] = None,
                eval_config: Optional[EvalConfig] = None,
                device="cuda") -> List[StrategyRun]:
    """Lockstep batched sweep over a SIMULATED scenario.

    ``strategies`` is the normalized [(name, config-or-None), ...] list.
    Every (strategy, seed) run keeps its own environment, strategy
    instance, event copies and event rng — exactly the objects the
    sequential path would build — but all runs advance round-by-round
    together, and each round's placements are evaluated in one pooled
    exact call. Returns runs ordered [strategy0 x seeds..., strategy1 x
    seeds...], matching the sequential sweep's ordering.

    ``eval_config.shard`` forwards to :class:`PooledTPDEvaluator`:
    ``"off"`` runs the float64 numpy path on the host, ``"on"`` the
    device-sharded float64 build (rows split over the models' devices),
    ``"auto"`` the sharded build only with more than one card visible.
    The bare ``shard=`` kwarg is a deprecated alias for
    ``eval_config=EvalConfig(shard=...)``.
    """
    if spec.kind != "simulated":
        raise ValueError("batched sweep mode is simulated-only; "
                         f"scenario {spec.name!r} is {spec.kind!r}")
    eval_config = resolve_eval_config(eval_config, shard=shard)
    if eval_config.recording == "on":
        raise ValueError(
            "eval.recording='on' needs the sequential step loop "
            "(batched mode bypasses env.step); run with "
            "mode='sequential'")
    shard = eval_config.shard
    from repro_torch.experiments.environments import SimulatedEnvironment
    rounds = rounds if rounds is not None else spec.rounds

    # one row per (strategy, seed), strategy-major like the sequential
    # sweep's result ordering
    envs, strats, events, erngs, runs = [], [], [], [], []
    for name, config in strategies:
        kw = {"config": config} if config is not None else {}
        for seed in seeds:
            env = _spec_environment(spec, seed, eval_config, device)
            # the lockstep loop replaces env.step with one pooled exact
            # call per round; an overridden step (extra metrics, custom
            # observation logic) would be silently bypassed
            if type(env).step is not SimulatedEnvironment.step:
                raise ValueError(
                    f"batched mode bypasses env.step, but "
                    f"{type(env).__name__} overrides it — run this "
                    f"scenario with mode='sequential'")
            strategy = create_strategy(name, env.hierarchy, seed=seed,
                                       clients=env.clients,
                                       cost_model=env.cost_model, **kw)
            envs.append(env)
            strats.append(strategy)
            events.append(spec.make_events())
            erngs.append(np.random.default_rng((seed, _EVENT_STREAM)))
            runs.append(StrategyRun(strategy=strategy.name, seed=seed))
    if not envs:  # empty strategy sweep == sequential mode's empty result
        return runs
    has_observer_noise = _has_observer_noise(events[0])
    elastic = spec.is_elastic
    n_rows = len(envs)
    # pooled evaluators are cached per topology COHORT (the tuple of run
    # rows currently sharing one hierarchy shape): static sweeps keep
    # one evaluator for the whole run; elastic sweeps split into cohorts
    # while runs' populations diverge and re-merge as they re-align —
    # each cohort is still ONE exact pooled call per round
    evaluators: dict = {}

    for env in envs:
        env.begin()
    event_pools = [getattr(env, "event_pool", env.clients)
                   for env in envs]
    for r in range(rounds):
        for i in range(n_rows):
            for ev in events[i]:
                msg = ev.on_round(r, event_pools[i], erngs[i])
                if msg:
                    runs[i].event_log.append(f"r{r}: {msg}")
                    if verbose:
                        print(f"    [event s{runs[i].seed}] r{r}: {msg}")
            _sync_topology(envs[i], strats[i], events[i], runs[i], r,
                           verbose)
        props = [np.asarray(strats[i].propose(r), np.int64)
                 for i in range(n_rows)]
        # group lockstep rows by topology epoch: runs whose hierarchy
        # (and therefore placement dimension D) diverged score in
        # separate pooled calls; Hierarchy is a frozen dataclass, so
        # field equality — not object identity — defines the cohort
        cohorts: dict = {}
        for i, env in enumerate(envs):
            cohorts.setdefault(env.hierarchy, []).append(i)
        tpds = np.empty(n_rows, np.float64)
        for hierarchy, idxs in cohorts.items():
            placements = np.stack([props[i] for i in idxs])
            _validate_rows(hierarchy, placements)
            key = tuple(idxs)
            evaluator = evaluators.get(key)
            if evaluator is None:
                evaluator = evaluators[key] = PooledTPDEvaluator(
                    [envs[i].cost_model for i in idxs], shard=shard)
            tpds[idxs] = evaluator.tpds(placements)  # ONE call per cohort
        for i in range(n_rows):
            true_tpd = float(tpds[i])
            observed = true_tpd
            for ev in events[i]:
                observed = ev.transform_tpd(r, observed, erngs[i])
            # hand observe() the same array propose() returned — exactly
            # what the sequential loop does (the pooled evaluator reads
            # its own stacked copy, so later strategy-held mutations
            # can't corrupt scoring)
            strats[i].observe(props[i], observed)
            runs[i].tpds.append(true_tpd)
            if has_observer_noise:
                runs[i].metrics.setdefault("observed_tpd", []).append(
                    float(observed))
            if elastic:
                runs[i].metrics.setdefault("topology_version", []).append(
                    float(envs[i].topology_version))
                runs[i].metrics.setdefault("n_clients", []).append(
                    float(len(envs[i].clients)))
            if verbose:
                print(f"    [{runs[i].strategy} s{runs[i].seed}] "
                      f"r{r:3d} tpd={true_tpd:8.4f}")

    for run, strategy in zip(runs, strats, strict=True):
        _finalize_run(run, strategy)
    return runs


def _validate_rows(hierarchy, placements: np.ndarray) -> None:
    """Batch placement validation: one sort catches duplicate ids across
    every row; offending rows re-raise through the scalar validator so
    the error message matches the sequential path."""
    bad = rows_with_duplicates(placements)
    out_of_range = (placements.min(axis=1) < 0) | \
        (placements.max(axis=1) >= hierarchy.total_clients)
    for i in np.nonzero(bad | out_of_range)[0]:
        hierarchy.validate_placement(placements[i])


def run_experiment(scenario: Union[str, ScenarioSpec],
                   strategies: Iterable[StrategyLike],
                   rounds: Optional[int] = None,
                   seeds: Sequence[int] = (0,), *,
                   verbose: bool = False,
                   progress: bool = True,
                   mode: Optional[str] = None,
                   shard: Optional[str] = None,
                   eval_config: Optional[EvalConfig] = None,
                   device="cuda") -> ExperimentResult:
    """Sweep ``strategies`` x ``seeds`` over one scenario on ``device``.

    ``scenario`` is a registered preset name or a ScenarioSpec (e.g. a
    preset with overrides). ``eval_config`` (an :class:`EvalConfig`)
    selects the evaluation surface in one place: ``mode`` ``"auto"``
    (batched for simulated scenarios, sequential for emulated) /
    ``"sequential"`` / ``"batched"`` — both modes produce bit-identical
    artifacts — plus the backend pin, pooled sharding, the
    analytic-vs-calibrated cost source and timing recording. The bare
    ``mode=``/``shard=`` kwargs are deprecated aliases kept for one
    release. Returns the versioned :class:`ExperimentResult`; call
    ``.save(path)`` for the artifact — its ``eval`` section (schema v4)
    appears only when a semantics-bearing field is non-default, so
    default-config artifacts keep the v3 bytes.
    """
    spec = get_scenario(scenario) if isinstance(scenario, str) else scenario
    rounds = rounds if rounds is not None else spec.rounds
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("need at least one seed")
    eval_config = resolve_eval_config(eval_config, mode=mode, shard=shard)
    norm = _normalize_strategies(strategies)
    # recording needs the per-round env.step loop, so it pins 'auto'
    # to sequential (EvalConfig already refused recording + batched)
    batched = (eval_config.mode == "batched") or \
        (eval_config.mode == "auto" and spec.kind == "simulated"
         and eval_config.recording != "on")

    result = ExperimentResult(
        scenario=spec.to_dict(), rounds=rounds, seeds=seeds,
        strategies=[n for n, _ in norm], eval=eval_config.provenance())
    if batched:
        t0 = time.perf_counter()
        result.runs.extend(run_batched(spec, norm, seeds=seeds,
                                       rounds=rounds, verbose=verbose,
                                       eval_config=eval_config,
                                       device=device))
        wall = time.perf_counter() - t0
        if progress:
            for name, _ in norm:
                print(f"  {name:12s} {aggregate_line(result, name)}")
            print(f"  [{wall:6.2f}s wall, batched lockstep x"
                  f"{len(result.runs)} runs]")
        return result

    for name, cfg in norm:
        t0 = time.perf_counter()
        for seed in seeds:
            run = run_single(spec, name, seed=seed, rounds=rounds,
                             config=cfg, verbose=verbose,
                             eval_config=eval_config, device=device)
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
