#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root (it puts ``src`` on ``sys.path`` itself):

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``. Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
Phases, in order; any failed check raises and ends the run non-zero:

1. card and toolchain;
2. build the TPD kernel (``src/repro_torch/csrc/tpd.cu``);
3. the kernel against its plain torch version on the card, exactly, and
   against the float64 scalar model within rtol 2e-5, at the Fig. 3
   extremes, large-1k and large-10k;
4. the main path: the paper's Fig. 3 grid (depth {3,4,5} x width {4,5}
   x particles {5,10}, 100 iterations, seed 0) through
   ``FlagSwapPSO.run(cm.fitness, 100, batch_fitness_fn=cm.batch_fitness)``
   on ``cuda``, each cell held exactly to the same run on the CPU;
5. full scale: large-10k, 10 particles, 50 iterations on ``cuda``;
6. timings (CUDA events, medians) beside the card's name and power
   limit, then one JSON line per kernel and the final status line. The
   JSON line's ``ms`` and ``plain_ms`` are both device time per call,
   host enqueue hidden behind a device spin; wrapper-call times, host
   enqueue included, are printed beside them.

The launch count of every kernel is set to 0 just before phase 4 and
read just after phase 5: the JSON line's ``launches`` is the main
path's count, and comparison launches never enter it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
RTOL_SCALAR = 2e-5             # f32 paths vs the float64 scalar model
SEED = 0
FIG3_DEPTH, FIG3_WIDTH, FIG3_PARTICLES = (3, 4, 5), (4, 5), (5, 10)
FIG3_ITERATIONS = 100
FULL_SCALE_ITERATIONS = 50
TIMING_RUNS = 25               # medians over this many runs
LAUNCHES_PER_RUN = 20          # back-to-back launches inside one run
SPIN_CYCLES = 10_000_000       # device spin hiding host enqueue, ~5 ms
MAX_SPIN_CYCLES = 2 ** 31


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(title: str) -> None:
    print(f"\n== {title} ==", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tpd_bytes(ps, L, W, depth, penalty) -> int:
    """Bytes the TPD function must move for the placements ``ps``: each
    placement row, leaf-load row and internal slot's kid row read once,
    the level starts (launch arguments) once, the output written once,
    and mdatasize and pspeed (and memcap when ``penalty`` > 0) read at
    the distinct ids this swarm places, the only ids the function
    reads them at."""
    P, D = ps.shape
    ids = len(set(ps.ravel().tolist()))
    rows = 3 if penalty > 0 else 2
    return P * (4 * D + 4 * L + 4) + 4 * W * (D - L) + 4 * rows * ids \
        + 4 * (depth + 1)


def median_event_ms(torch, fn, runs=TIMING_RUNS, per_run=LAUNCHES_PER_RUN):
    """Median over ``runs`` of the CUDA-event time of ``per_run``
    back-to-back calls of ``fn``, divided by ``per_run`` (ms per call):
    the wrapper-call time, host enqueue included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_run)
    return statistics.median(times)


def median_device_ms(torch, fn, runs=TIMING_RUNS, per_run=LAUNCHES_PER_RUN):
    """Like :func:`median_event_ms`, but the device first spins in a
    ``torch.cuda._sleep`` while the host enqueues all ``per_run`` calls,
    so the events bracket device work only, without the host's per-call
    cost (ms per call on the device). A run counts only if the device
    had not yet reached the first event when the host finished
    enqueueing; otherwise the spin doubles and the run is repeated.
    ``fn`` must not synchronise."""
    spin = SPIN_CYCLES
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < runs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden:
            times.append(a.elapsed_time(b) / per_run)
        else:
            spin *= 2
            check(spin <= MAX_SPIN_CYCLES,
                  "host enqueue outlasts the longest device spin")
    return statistics.median(times)


def median_host_ms(fn, runs=TIMING_RUNS, sync=None):
    """Median host wall time of one call of ``fn`` (ms), ending in
    ``sync`` when given."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if sync is not None:
            sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def np_leaf_loads(np, ps, mds32, C, L):
    """The reference's host prefix-sum of trainer loads (float64
    bincount, rounded to float32)."""
    P = ps.shape[0]
    p_off = np.arange(P)[:, None]
    unplaced = np.bincount((ps + C * p_off).ravel(),
                           minlength=P * C).reshape(P, C) == 0
    t_mds = np.where(unplaced, mds32[None], np.float32(0.0))
    leaf_of = (np.cumsum(unplaced, axis=1) - 1) % L
    return np.bincount((leaf_of + L * p_off).ravel(), weights=t_mds.ravel(),
                       minlength=P * L).reshape(P, L).astype(np.float32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.pso import FlagSwapPSO
    from repro_torch.experiments import get_scenario
    from repro_torch.kernels import tpd as tpd_mod
    from repro_torch.kernels.ref import tpd_ref
    from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs

    dev = torch.device("cuda")

    # ---- 1. card and toolchain -----------------------------------------
    phase("1. card and toolchain")
    card = card_line()
    print(card)
    nvcc = tpd_mod.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True, timeout=60)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"nvcc {nvcc}: {nvcc_version.stdout.strip().splitlines()[-1]}")

    # ---- 2. build --------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    lib = tpd_mod.build_library()
    build_s = time.perf_counter() - t0
    print(f"built {lib.relative_to(ROOT)} in {build_s:.2f} s")
    log = lib.with_suffix(".log")
    if log.is_file():
        print(log.read_text().strip())

    # ---- 3. kernel vs plain version on the card -------------------------
    phase("3. TPD kernel vs its plain torch version on the card")

    def operands(h, pool, P, penalty, seed, dup_rows):
        C = h.total_clients
        rng = np.random.default_rng(seed)
        ps = np.stack([rng.permutation(C)[:h.dimensions]
                       for _ in range(P)]).astype(np.int32)
        for i in range(1, min(dup_rows, P) + 1):
            ps[-i, 1] = ps[-i, 0]
            ps[-i, -1] = ps[-i, 0]
        cm = CostModel(h, pool, memory_penalty=penalty, device=dev)
        attrs_np = cm._attr_stack(np.float32)
        p = torch.as_tensor(ps, device=dev)
        attrs = torch.as_tensor(attrs_np, device=dev)
        leaf = leaf_loads(p, attrs[0], h.n_leaves)
        return cm, ps, attrs_np, (p, attrs, leaf,
                                  *tpd_kernel_inputs(h, device=dev))

    fig3_pool = {}

    def fig3(depth, width):
        h = Hierarchy(depth, width, 2)
        if (depth, width) not in fig3_pool:
            fig3_pool[depth, width] = ClientPool.random(h.total_clients,
                                                        seed=SEED)
        return h, fig3_pool[depth, width]

    def hetero(h, seed):
        pool = ClientPool.random(h.total_clients, seed=seed)
        pool.mdatasize = np.random.default_rng(seed + 1).uniform(
            1.0, 40.0, h.total_clients)
        return pool

    h1k = get_scenario("large-1k").make_hierarchy()
    h10k = get_scenario("large-10k").make_hierarchy()
    pool10k = ClientPool.random(h10k.total_clients, seed=SEED)
    cases = [("fig3 d3w4", *fig3(3, 4), 10, 0.0, 0),
             ("fig3 d5w5", *fig3(5, 5), 10, 0.0, 0),
             ("large-1k hetero", h1k, hetero(h1k, 1), 10, 3.0, 2),
             ("large-1k hetero", h1k, hetero(h1k, 1), 100, 3.0, 5)]
    for P in (1, 10, 1000):
        for penalty in (0.0, 3.0):
            cases.append(("large-10k", h10k, pool10k, P, penalty,
                          0 if P == 1 else 3))
    max_abs_err = 0.0
    for i, (name, h, pool, P, penalty, dups) in enumerate(cases):
        cm, ps, attrs_np, ops = operands(h, pool, P, penalty, 100 + i, dups)
        leaf_ok = np.array_equal(
            ops[2].cpu().numpy(),
            np_leaf_loads(np, ps, attrs_np[0], h.total_clients, h.n_leaves))
        check(leaf_ok, f"{name} P={P}: leaf_loads differ from the numpy "
                       f"prefix-sum")
        got = batch_tpd_cuda(*ops, penalty=penalty)
        torch.cuda.synchronize()
        want = tpd_ref(*ops, penalty=penalty)
        err = float((got - want).abs().max())
        max_abs_err = max(max_abs_err, err)
        check(torch.equal(got, want),
              f"{name} P={P} penalty={penalty}: kernel != plain version "
              f"(max abs err {err})")
        rows = list(range(min(P, 3))) + ([P - 1] if P > 3 else [])
        scalar = np.array([cm.tpd(ps[r]) for r in rows])
        kern = got.cpu().numpy()[rows].astype(np.float64)
        rel = float(np.max(np.abs(kern - scalar) / np.abs(scalar)))
        check(rel <= RTOL_SCALAR, f"{name} P={P}: kernel vs f64 scalar "
                                  f"rel err {rel} > {RTOL_SCALAR}")
        print(f"{name:16s} D={h.dimensions:5d} C={h.total_clients:6d} "
              f"P={P:5d} penalty={penalty}: exact (atol 0), "
              f"rel err vs f64 scalar {rel:.2e}")

    # ---- 4. main path: the Fig. 3 grid on cuda --------------------------
    phase("4. main path: paper Fig. 3 grid on cuda, held to the CPU run")
    batch_tpd_cuda.launches = 0   # every count to 0 just before the path
    t_main = time.perf_counter()

    def run_cell(depth, width, particles, device, backend=None):
        spec = get_scenario("paper-fig3").with_overrides(depth=depth,
                                                         width=width)
        env = spec.make_environment(SEED, device=device)
        h, cm = env.hierarchy, env.cost_model
        if backend is not None:
            cm.set_default_backend(backend)
        pso = FlagSwapPSO(h.dimensions, h.total_clients,
                          n_particles=particles, inertia=0.01, c1=0.01,
                          c2=1.0, velocity_factor=0.1, seed=SEED)
        best = pso.run(cm.fitness, FIG3_ITERATIONS,
                       batch_fitness_fn=cm.batch_fitness)
        return h, cm, pso, best

    cells = []
    for d in FIG3_DEPTH:
        for w in FIG3_WIDTH:
            for P in FIG3_PARTICLES:
                before = batch_tpd_cuda.launches
                t0 = time.perf_counter()
                h, _, pso, best = run_cell(d, w, P, "cuda")
                wall = time.perf_counter() - t0
                launched = batch_tpd_cuda.launches - before
                check(launched == FIG3_ITERATIONS,
                      f"D={d} W={w} P={P}: {launched} kernel launches, "
                      f"expected {FIG3_ITERATIONS}")
                cells.append((d, w, P, h, pso, best, wall))
    fig3_s = time.perf_counter() - t_main

    # ---- 5. full scale: large-10k ---------------------------------------
    phase("5. full scale: large-10k, 10 particles, 50 iterations on cuda")
    env10k = get_scenario("large-10k").make_environment(SEED, device="cuda")
    h, cm10k = env10k.hierarchy, env10k.cost_model
    pso10k = FlagSwapPSO(h.dimensions, h.total_clients, n_particles=10,
                         seed=SEED, record_per_particle=False)
    before = batch_tpd_cuda.launches
    t0 = time.perf_counter()
    best10k = pso10k.run(cm10k.fitness, FULL_SCALE_ITERATIONS,
                         batch_fitness_fn=cm10k.batch_fitness)
    torch.cuda.synchronize()
    wall10k = time.perf_counter() - t0
    launches_main = batch_tpd_cuda.launches   # read just after the path
    check(launches_main - before == FULL_SCALE_ITERATIONS,
          f"large-10k: {launches_main - before} launches, expected "
          f"{FULL_SCALE_ITERATIONS}")
    scalar_best = cm10k.tpd(best10k)
    rel = abs(-pso10k.gbest_f - scalar_best) / scalar_best
    check(rel <= RTOL_SCALAR, f"large-10k gbest: kernel TPD "
                              f"{-pso10k.gbest_f} vs scalar {scalar_best}")
    print(f"D={h.dimensions} C={h.total_clients}: {wall10k / 50 * 1e3:.3f} "
          f"ms per iteration (host clock, {FULL_SCALE_ITERATIONS} "
          f"iterations, {card}); gbest TPD {-pso10k.gbest_f:.6f} from the "
          f"kernel vs {scalar_best:.6f} scalar (rel {rel:.2e}); TPD "
          f"{pso10k.history.mean[0]:.4f} -> {pso10k.history.best[-1]:.4f}")
    print(f"main path: {launches_main} kernel launches (12 Fig. 3 cells x "
          f"{FIG3_ITERATIONS} + {FULL_SCALE_ITERATIONS})")

    # the Fig. 3 grid again on the CPU: every cell must match exactly
    phase("4b. Fig. 3 grid on the CPU (backend='torch'), compared")
    for d, w, P, h, pso, best, wall in cells:
        _, _, cpu, cpu_best = run_cell(d, w, P, "cpu", backend="torch")
        same = (pso.history.best == cpu.history.best
                and pso.history.mean == cpu.history.mean
                and pso.history.worst == cpu.history.worst
                and np.array_equal(best, cpu_best)
                and np.array_equal(pso.gbest_x, cpu.gbest_x))
        check(same, f"D={d} W={w} P={P}: cuda history/gbest differ from "
                    f"the CPU run")
        print(f"D={d} W={w} P={P:2d} | clients={h.total_clients:5d} "
              f"slots={h.dimensions:4d} | TPD {pso.history.mean[0]:8.3f} "
              f"-> {-pso.gbest_f:8.3f} | {wall / FIG3_ITERATIONS * 1e3:.3f} "
              f"ms/iteration on cuda | equal to the CPU run")
    gbest = {(d, w, P): -pso.gbest_f for d, w, P, _, pso, _, _ in cells}
    improved = sum(-pso.gbest_f < pso.history.mean[0]
                   for _, _, _, _, pso, _, _ in cells)
    p10_wins = sum(gbest[d, w, 10] <= gbest[d, w, 5] * 1.02
                   for d in FIG3_DEPTH for w in FIG3_WIDTH)
    print(f"paper claims (printed, not checked): {improved}/{len(cells)} "
          f"cells improved TPD; P=10 <= P=5 (x1.02) in {p10_wins}/6 grids; "
          f"grid took {fig3_s:.2f} s on cuda")

    # ---- 6. timings --------------------------------------------------------
    phase(f"6. timings on {card}")
    rows = {}
    for P in (10, 1000):
        cm, ps, _, ops = operands(h10k, pool10k, P, 0.0, 7 + P, 0)
        k_ms = median_device_ms(torch, lambda ops=ops: batch_tpd_cuda(*ops))
        r_ms = median_device_ms(torch, lambda ops=ops: tpd_ref(*ops))
        k_call = median_event_ms(torch, lambda ops=ops: batch_tpd_cuda(*ops))
        r_call = median_event_ms(torch, lambda ops=ops: tpd_ref(*ops))
        nbytes = tpd_bytes(ps, h10k.n_leaves, h10k.width, h10k.depth, 0.0)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[P] = (k_ms, r_ms, b_ms)
        print(f"large-10k P={P:5d}: device time per call: kernel "
              f"{k_ms * 1e3:8.2f} us, plain torch {r_ms * 1e3:9.2f} us; "
              f"back-to-back wrapper call: kernel {k_call * 1e3:8.2f} us, "
              f"plain torch {r_call * 1e3:9.2f} us; bound "
              f"{b_ms * 1e3:.4f} us ({nbytes} B / 3.35 TB/s) [{card}]")

    hd = Hierarchy(5, 5, 2)
    cmd, psd, _, opsd = operands(hd, fig3(5, 5)[1], 10, 0.0, 11, 0)
    kd_ms = median_device_ms(torch, lambda: batch_tpd_cuda(*opsd))
    kd_call_ms = median_event_ms(torch, lambda: batch_tpd_cuda(*opsd))
    bd_ms = tpd_bytes(psd, hd.n_leaves, hd.width, hd.depth, 0.0) \
        / HBM_BYTES_PER_S * 1e3
    np_ms = median_host_ms(lambda: cmd.batch_tpd(psd, backend="np"))
    print(f"fig3 d5w5 P=10: kernel {kd_ms * 1e3:.2f} us on the device, "
          f"{kd_call_ms * 1e3:.2f} us per wrapper call, bound "
          f"{bd_ms * 1e3:.4f} us; numpy batch_tpd(backend='np') "
          f"{np_ms * 1e3:.2f} us (host clock) [{card}]")

    # where one large-10k iteration goes (P = 10)
    cm, ps, _, ops = operands(h10k, pool10k, 10, 0.0, 5, 0)
    p_dev, attrs = ops[0], ops[1]
    sync = torch.cuda.synchronize
    h2d_ms = median_host_ms(lambda: torch.as_tensor(ps, device=dev), sync=sync)
    leaf_dev_ms = median_device_ms(
        torch, lambda: leaf_loads(p_dev, attrs[0], h10k.n_leaves))
    leaf_ms = median_event_ms(
        torch, lambda: leaf_loads(p_dev, attrs[0], h10k.n_leaves))
    out_dev = batch_tpd_cuda(*ops)
    d2h_ms = median_host_ms(lambda: out_dev.cpu().numpy())
    full_ms = median_host_ms(lambda: cm.batch_tpd(ps, backend="kernel"))
    swarm = FlagSwapPSO(h10k.dimensions, h10k.total_clients, n_particles=10,
                        seed=SEED, record_per_particle=False)
    fs = -cm.batch_tpd(swarm.placements(), backend="np").astype(np.float64)

    def host_update():
        swarm.history.record(-fs)
        swarm._update_bests_swarm(fs)
        swarm._step_swarm()
        swarm.placements()

    pso_ms = median_host_ms(host_update)
    print(f"large-10k iteration (P=10): H2D {h2d_ms * 1e3:.1f} us, "
          f"leaf_loads {leaf_ms * 1e3:.1f} us per call "
          f"({leaf_dev_ms * 1e3:.1f} us on the device), kernel "
          f"{rows[10][0] * 1e3:.1f} us on the device, D2H "
          f"{d2h_ms * 1e3:.1f} us, whole batch_tpd {full_ms * 1e3:.1f} us, "
          f"host PSO update {pso_ms * 1e3:.1f} us; measured iteration "
          f"{wall10k / FULL_SCALE_ITERATIONS * 1e3 * 1e3:.1f} us [{card}]")

    # numbers for a GPU auto-dispatch threshold: whole batch_tpd calls
    for name, hh, pool, P in (("fig3 d3w4", *fig3(3, 4), 10),
                              ("fig3 d5w5", *fig3(5, 5), 10),
                              ("large-1k", h1k, ClientPool.random(
                                  h1k.total_clients, seed=SEED), 10),
                              ("large-10k", h10k, pool10k, 10),
                              ("large-10k", h10k, pool10k, 1000)):
        cm, ps, _, _ = operands(hh, pool, P, 0.0, 3, 0)
        t_np = median_host_ms(lambda cm=cm, ps=ps: cm.batch_tpd(ps, "np"))
        t_k = median_host_ms(lambda cm=cm, ps=ps: cm.batch_tpd(ps, "kernel"))
        print(f"batch_tpd {name:10s} P={P:5d} (P*C={P * hh.total_clients}):"
              f" np {t_np * 1e3:9.1f} us, kernel path {t_k * 1e3:9.1f} us "
              f"(host clock) [{card}]")

    k_ms, r_ms, b_ms = rows[10]
    print(json.dumps({"kernels": [{
        "name": "tpd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tpd.cu",
        "replaces": "src/repro/kernels/tpd.py:75",
        "launches": launches_main,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": r_ms,
        "bound_ms": b_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
