"""Port vs reference, the slice end to end: scenarios built into
simulated environments, driven round by round (events, elastic
re-hierarchization, cohort sampling), and the paper's Fig. 3 swarm loop.
All of it is exact: the environment steps score with the float64 numpy
path, and the swarm's TPDs go through the plain torch version on the
CPU, which equals the reference's float32 numpy evaluator bit for bit.
"""
import numpy as np
import pytest

from repro.core import create_strategy as ref_create_strategy
from repro.core.pso import FlagSwapPSO as RefPSO
from repro.experiments import get_scenario as ref_get_scenario
from repro_torch.core import create_strategy
from repro_torch.core.pso import FlagSwapPSO
from repro_torch.experiments import get_scenario, list_scenarios
from repro_torch.experiments.environments import SampledSimulatedEnvironment

_EVENT_STREAM = 0xE7E47  # the reference runner's event stream


def _drive(env, strategy, events, seed, rounds):
    """The reference runner's per-round loop (``run_single``), written
    against duck types so it drives either package's objects."""
    erng = np.random.default_rng((seed, _EVENT_STREAM))
    event_pool = getattr(env, "event_pool", env.clients)
    trace = []
    for r in range(rounds):
        for ev in events:
            ev.on_round(r, event_pool, erng)
        update = env.sync_topology()
        if update is not None:
            strategy.migrate(update)
            for ev in events:
                ev.on_topology(update)
        placement = np.asarray(strategy.propose(r), np.int64)
        obs = env.step(r, placement)
        observed = obs.tpd
        for ev in events:
            observed = ev.transform_tpd(r, observed, erng)
        strategy.observe(placement, observed)
        h = env.hierarchy
        trace.append((obs.tpd, obs.topology_version, h.depth, h.width,
                      h.n_clients, placement.tolist(),
                      env.clients.pspeed.tolist()))
    return trace


@pytest.mark.parametrize("name,strategy,rounds", [
    ("paper-fig3", "pso", 40),
    ("large-1k", "pso", 6),
    ("flash-crowd", "pso", 45),
    ("composite-storm", "sa", 40),
    ("large-100k", "random", 4),
])
def test_environment_steps_match_reference(name, strategy, rounds):
    seed = 3
    ref_env = ref_get_scenario(name).make_environment(seed)
    env = get_scenario(name).make_environment(seed, device="cpu")
    assert type(env).__name__ == type(ref_env).__name__
    ref_s = ref_create_strategy(strategy, ref_env.hierarchy, seed=seed,
                                clients=ref_env.clients,
                                cost_model=ref_env.cost_model)
    s = create_strategy(strategy, env.hierarchy, seed=seed,
                        clients=env.clients, cost_model=env.cost_model)
    want = _drive(ref_env, ref_s, ref_get_scenario(name).make_events(),
                  seed, rounds)
    got = _drive(env, s, get_scenario(name).make_events(), seed, rounds)
    assert got == want
    if name == "flash-crowd":  # the tree re-grew on both tracks
        assert max(t[1] for t in got) > 0
        assert len({t[2] for t in got}) > 1
    if name == "large-100k":
        assert isinstance(env, SampledSimulatedEnvironment)


def test_every_reference_preset_is_registered():
    from repro.experiments import list_scenarios as ref_list
    ref = {s.name: s.to_dict() for s in ref_list()}
    port = {s.name: s.to_dict() for s in list_scenarios()}
    assert port == ref


@pytest.mark.parametrize("name", ["paper-fig4", "online-fig4", "two-tier"])
def test_unported_tracks_raise_not_implemented(name):
    """No track raises any more. The emulated fault path (a quorum), the
    two-tier pod model and the online track (ROADMAP queue 1 item 7),
    once refused here, now build and step a round equal to the
    reference's."""
    spec, ref_spec = get_scenario(name), ref_get_scenario(name)
    if name in ("paper-fig4", "online-fig4"):
        over = {"model": "mlp-smoke"}
        if name == "paper-fig4":
            over["quorum_frac"] = 0.5
        spec, ref_spec = spec.with_overrides(**over), \
            ref_spec.with_overrides(**over)
    env, ref_env = spec.make_environment(0, device="cpu"), \
        ref_spec.make_environment(0)
    env.begin()
    ref_env.begin()
    placement = np.arange(env.hierarchy.dimensions)[::-1]
    obs, want = env.step(0, placement), ref_env.step(0, placement)
    assert obs.tpd == want.tpd and obs.tpd > 0
    assert obs.metrics.get("merged") == want.metrics.get("merged")


def test_fig3_cell_swarm_matches_reference():
    """One paper Fig. 3 cell: depth 3, width 4, 10 particles, 100
    iterations, seed 0 — the port on the CPU through backend='torch'
    against the reference through backend='np'."""
    seed = 0
    over = {"depth": 3, "width": 4}
    ref_env = ref_get_scenario("paper-fig3").with_overrides(**over) \
        .make_environment(seed)
    env = get_scenario("paper-fig3").with_overrides(**over) \
        .make_environment(seed, device="cpu")
    ref_cm, cm = ref_env.cost_model, env.cost_model
    cm.set_default_backend("torch")
    h = env.hierarchy
    ref = RefPSO(h.dimensions, h.total_clients, n_particles=10, seed=seed)
    port = FlagSwapPSO(h.dimensions, h.total_clients, n_particles=10,
                       seed=seed)
    want = ref.run(ref_cm.fitness, 100, batch_fitness_fn=lambda p: -np.asarray(
        ref_cm.batch_tpd(p, backend="np")))
    got = port.run(cm.fitness, 100, batch_fitness_fn=cm.batch_fitness)
    assert getattr(cm, "_batch_tpd_torch", None) is not None
    assert np.array_equal(got, want)
    assert port.history.best == ref.history.best
    assert port.history.mean == ref.history.mean
    assert port.history.worst == ref.history.worst
    for a, b in zip(port.history.per_particle, ref.history.per_particle,
                    strict=True):
        assert np.array_equal(a, b)
    assert port.history.best[-1] < port.history.mean[0]  # it optimized
