"""Port vs reference: the batched TPD (eqs. 6-7) — the plain torch
version of the kernel, the on-device trainer leaf loads, the kernel's
launch plan and a numpy emulation of its leaf stage, and the port's
CostModel backends.

Tolerances: the port's ``tpd_ref`` adds kids left to right and level
maxima deepest first, numpy's order for W < 8, so it equals the
reference's float32 numpy evaluator exactly (atol 0). XLA may sum the
kids in another order, so the jnp oracle and the Pallas interpreter are
held at rtol 1e-6 (a few f32 ulps). Against the float64 scalar model
the f32 paths keep the reference's documented rtol 2e-5. Leaf loads are
float64 sums in bincount's order rounded to float32, so they are held
to the reference's host prefix-sum exactly, payloads over 2^-30..2^30
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost_model import CostModel as RefCostModel
from repro.core.hierarchy import ClientPool as RefClientPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.kernels.ref import tpd_ref as ref_tpd_ref
from repro.kernels.tpd import batch_tpd_pallas
from repro.kernels.tpd import tpd_kernel_inputs as ref_tpd_kernel_inputs
from repro_torch.core.cost_model import CostModel
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.state import pool_from_numpy
from repro_torch.kernels.ref import tpd_ref
from repro_torch.kernels import tpd as ktpd
from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs

# (depth, width, trainers/leaf, clients) — all W < 8
SHAPES = [(3, 4, 2, 60), (4, 3, 2, 200), (2, 5, 3, None), (5, 2, 2, 90)]


def _swarm(h, P, seed, dup_rows=2):
    """P placements; the last ``dup_rows`` rows repeat ids (legal for
    the scalar model: duplicates shrink the placed set)."""
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.permutation(h.total_clients)[:h.dimensions]
                   for _ in range(P)]).astype(np.int32)
    for i in range(1, dup_rows + 1):
        ps[-i, 1] = ps[-i, 0]
        ps[-i, -1] = ps[-i, 0]
    return ps


def _models(shape, hetero, penalty, seed=0):
    depth, width, tpl, n = shape
    ref_h = RefHierarchy(depth, width, tpl, n)
    pool = RefClientPool.random(ref_h.total_clients, seed=seed)
    if hetero:
        pool.mdatasize = np.random.default_rng(seed + 1).uniform(
            1.0, 40.0, ref_h.total_clients)
    ref = RefCostModel(ref_h, pool, memory_penalty=penalty)
    port = CostModel(Hierarchy(depth, width, tpl, n),
                     pool_from_numpy(pool.memcap, pool.pspeed, pool.mdatasize),
                     memory_penalty=penalty, device="cpu")
    return ref, port


def _np_leaf_loads(ps, mds32, C, L):
    """The reference's host prefix-sum (CostModel._make_pallas_tpd)."""
    P = ps.shape[0]
    p_off = np.arange(P)[:, None]
    unplaced = np.bincount((ps + C * p_off).ravel(),
                           minlength=P * C).reshape(P, C) == 0
    t_mds = np.where(unplaced, mds32[None], np.float32(0.0))
    leaf_of = (np.cumsum(unplaced, axis=1) - 1) % L
    return np.bincount((leaf_of + L * p_off).ravel(), weights=t_mds.ravel(),
                       minlength=P * L).reshape(P, L).astype(np.float32)


CASES = [(shape, hetero, penalty) for shape in SHAPES
         for hetero in (False, True) for penalty in (0.0, 2.5)]


def _shared_operands(shape, hetero, penalty):
    ref, port = _models(shape, hetero, penalty)
    h = ref.hierarchy
    ps = _swarm(h, 9, seed=shape[0] + shape[1])
    attrs = ref._attr_stack(np.float32)
    leaf = _np_leaf_loads(ps, attrs[0], h.total_clients, h.n_leaves)
    got = tpd_ref(torch.as_tensor(ps), torch.as_tensor(attrs),
                  torch.as_tensor(leaf),
                  *tpd_kernel_inputs(port.hierarchy, device="cpu"),
                  penalty=penalty)
    assert got.dtype == torch.float32 and got.shape == (9,)
    return ref, ps, attrs, leaf, got.numpy()


@pytest.mark.parametrize("shape,hetero,penalty", CASES)
def test_tpd_ref_matches_reference_numpy_exactly(shape, hetero, penalty):
    ref, ps, _, _, got = _shared_operands(shape, hetero, penalty)
    np.testing.assert_array_equal(got, ref.batch_tpd(ps, backend="np"))
    scalar = np.array([ref.tpd(p) for p in ps])
    np.testing.assert_allclose(got, scalar, rtol=2e-5, atol=0)


# two JAX cases: each new shape costs the interpreter seconds of compile
@pytest.mark.parametrize("shape,hetero,penalty",
                         [(SHAPES[0], True, 2.5), (SHAPES[1], False, 0.0)])
def test_tpd_ref_matches_jax_oracle_and_pallas_interpreter(shape, hetero,
                                                           penalty):
    ref, ps, attrs, leaf, got = _shared_operands(shape, hetero, penalty)
    ref_tables = ref_tpd_kernel_inputs(ref.hierarchy)
    jnp_ops = (jnp.asarray(ps), jnp.asarray(attrs), jnp.asarray(leaf))
    oracle = np.asarray(ref_tpd_ref(*jnp_ops, *ref_tables, penalty=penalty))
    interp = np.asarray(batch_tpd_pallas(*jnp_ops, *ref_tables,
                                         penalty=penalty, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, interp, rtol=1e-6, atol=0)


def _wide_payloads(C, seed):
    """float32 payloads spread over 2^-30..2^30: float64 sums of a few
    of them are not exact, so the order of the adds shows."""
    rng = np.random.default_rng(seed)
    return (2.0 ** rng.uniform(-30, 30, C)).astype(np.float32)


@pytest.mark.parametrize("shape,payloads", [
    (s, kind) for s in SHAPES for kind in ("uniform", "hetero", "wide")])
def test_leaf_loads_match_numpy_prefix_sum(shape, payloads):
    ref, _ = _models(shape, payloads == "hetero", 0.0)
    h = ref.hierarchy
    ps = _swarm(h, 11, seed=3, dup_rows=4)
    mds32 = ref._attr_stack(np.float32)[0]
    if payloads == "wide":
        mds32 = _wide_payloads(h.total_clients, seed=shape[0])
    got = leaf_loads(torch.as_tensor(ps), torch.as_tensor(mds32), h.n_leaves)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), _np_leaf_loads(ps, mds32, h.total_clients, h.n_leaves))


@pytest.mark.parametrize("shape,hetero,penalty", CASES[::3])
def test_cost_model_matches_reference(shape, hetero, penalty):
    ref, port = _models(shape, hetero, penalty)
    ps = _swarm(ref.hierarchy, 8, seed=7)
    want = ref.batch_tpd(ps, backend="np")
    for backend in ("np", "torch", None):
        got = port.batch_tpd(ps, backend=backend)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.batch_fitness(ps), -want)
    for p in ps:
        assert port.tpd(p) == ref.tpd(p)
        assert port.tpd_fast(p) == ref.tpd_fast(p)
        assert port.fitness(p) == ref.fitness(p)


def test_cpu_auto_selection_follows_the_fast_path_threshold():
    ref, port = _models((3, 4, 2, 60), True, 0.0)
    small = _swarm(ref.hierarchy, 4, seed=1)
    big = _swarm(ref.hierarchy, 600, seed=2)  # 600 * 60 > 32768 entries
    assert small.shape[0] * 60 <= CostModel._NP_FASTPATH_ELEMS < big.shape[0] * 60
    np.testing.assert_array_equal(port.batch_tpd(small),
                                  ref.batch_tpd(small, backend="np"))
    np.testing.assert_array_equal(port.batch_tpd(big),
                                  ref.batch_tpd(big, backend="np"))
    assert getattr(port, "_batch_tpd_np", None) is not None
    assert getattr(port, "_batch_tpd_torch", None) is not None
    port.set_default_backend("np")
    np.testing.assert_array_equal(port.batch_tpd(big),
                                  ref.batch_tpd(big, backend="np"))


def test_cost_model_caches_follow_pool_and_topology_versions():
    ref, port = _models((3, 3, 2, 40), False, 0.0)
    ps = _swarm(ref.hierarchy, 5, seed=4)
    before = port.batch_tpd(ps, backend="torch")
    for cm in (ref, port):
        cm.clients.pspeed[3:9] *= 0.5
        cm.clients.touch()
    after = port.batch_tpd(ps, backend="torch")
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, ref.batch_tpd(ps, backend="np"))


def test_kernel_backend_refuses_the_cpu():
    _, port = _models((3, 4, 2, 60), False, 0.0)
    ps = _swarm(port.hierarchy, 3, seed=0)
    with pytest.raises(ValueError, match="CUDA device"):
        port.batch_tpd(ps, backend="kernel")
    with pytest.raises(ValueError, match="unknown batch_tpd backend"):
        port.batch_tpd(ps, backend="pallas")
    with pytest.raises(ValueError, match="unknown batch_tpd backend"):
        port.set_default_backend("jit")
    bad = ps.copy()
    bad[0, 0] = port.hierarchy.total_clients
    with pytest.raises(ValueError, match="out of range"):
        port.batch_tpd(bad, backend="torch")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card error cannot show")
    h = Hierarchy(3, 4, 2)
    pool = pool_from_numpy(*(np.ones(h.total_clients),) * 3)
    with pytest.raises(RuntimeError, match="cuda"):
        CostModel(h, pool)
    with pytest.raises(RuntimeError, match="cuda"):
        tpd_kernel_inputs(h)


def test_wrapper_hands_cpu_tensors_to_the_plain_version():
    _, port = _models((4, 3, 2, 200), True, 2.5)
    h = port.hierarchy
    ps = torch.as_tensor(_swarm(h, 6, seed=5))
    attrs = torch.as_tensor(port._attr_stack(np.float32))
    leaf = leaf_loads(ps, attrs[0], h.n_leaves)
    tables = tpd_kernel_inputs(h, device="cpu")
    before = batch_tpd_cuda.launches
    got = batch_tpd_cuda(ps, attrs, leaf, *tables, penalty=2.5)
    assert batch_tpd_cuda.launches == before  # no launch on the CPU
    assert torch.equal(got, tpd_ref(ps, attrs, leaf, *tables, penalty=2.5))
    with pytest.raises(ValueError, match="leaf_out"):
        batch_tpd_cuda(ps, attrs, leaf, *tables, leaf_out=leaf.clone())


# ---------------------------------------------------------------------------
# leaf_load=None: the one launch that also builds the leaf loads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,penalty", [(s, pen) for s in SHAPES
                                           for pen in (0.0, 2.5)])
def test_built_leaf_mode_matches_reference_and_pallas_interpreter(shape,
                                                                  penalty):
    """Without leaf loads the wrapper's CPU path equals the reference's
    numpy ``batch_tpd`` and its Pallas kernel (interpret mode) fed with
    the reference's host leaf loads, exactly."""
    ref, ps, attrs, leaf, given = _shared_operands(shape, True, penalty)
    tables = tpd_kernel_inputs(Hierarchy(*shape), device="cpu")
    out_leaf = torch.empty(leaf.shape, dtype=torch.float32)
    before = batch_tpd_cuda.launches
    got = batch_tpd_cuda(torch.as_tensor(ps), torch.as_tensor(attrs), None,
                         *tables, penalty=penalty, leaf_out=out_leaf)
    assert batch_tpd_cuda.launches == before   # no launch on the CPU
    np.testing.assert_array_equal(out_leaf.numpy(), leaf)
    np.testing.assert_array_equal(got.numpy(), ref.batch_tpd(ps,
                                                             backend="np"))
    np.testing.assert_array_equal(got.numpy(), given)
    interp = np.asarray(batch_tpd_pallas(
        jnp.asarray(ps), jnp.asarray(attrs), jnp.asarray(leaf),
        *ref_tpd_kernel_inputs(ref.hierarchy), penalty=penalty,
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), interp)


def _emulate_leaf_stage(ps, mds32, C, L, threads):
    """numpy emulation of ``csrc/tpd.cu``'s leaf stage, one block a row
    of ``threads`` threads: the bitmap of placed ids; each thread's run
    of consecutive words counted and ranked by an exclusive scan (warp
    scans, then one value a warp); each free id's payload written at its
    word's rank plus the free bits below its lane; leaf j adding ranks
    j, j + L, ... in float64 and rounding to float32."""
    NW = -(-C // 32)
    lanes = np.arange(32)
    out = np.empty((ps.shape[0], L), np.float32)
    for p, row in enumerate(ps):
        placed = np.zeros(NW, np.int64)
        for i in row:
            placed[i >> 5] |= 1 << (i & 31)
        valid = np.minimum(C - 32 * np.arange(NW), 32)
        free = ~placed & ((1 << valid) - 1)              # (NW,) bit sets
        bits = (free[:, None] >> lanes) & 1              # (NW, 32)
        per = -(-NW // threads)
        counts = np.array([bits[t * per:(t + 1) * per].sum()
                           for t in range(threads)])
        warp_incl = counts.reshape(-1, 32).cumsum(axis=1)
        warp_base = np.concatenate([[0], warp_incl[:, -1].cumsum()[:-1]])
        thread_rank = (warp_base[:, None] + warp_incl).reshape(-1) - counts
        word_rank = np.empty(NW, np.int64)
        for t in range(threads):
            run = np.arange(t * per, min((t + 1) * per, NW))
            word_rank[run] = thread_rank[t] + np.concatenate(
                [[0], bits[run].sum(axis=1).cumsum()[:-1]])[:len(run)]
        unplaced = int(bits.sum())
        pay = np.full(C, np.nan, np.float32)
        below = np.cumsum(bits, axis=1) - bits          # free bits below
        wd, lane = np.nonzero(bits)
        pay[word_rank[wd] + below[wd, lane]] = mds32[32 * wd + lane]
        for j in range(L):
            acc = 0.0                                     # float64
            for r in range(j, unplaced, L):
                acc = acc + float(pay[r])
            out[p, j] = np.float32(acc)
    return out


# (depth, width, trainers/leaf, clients, P, duplicate rows, clients in
# the pool when fewer than the tree needs): wide payloads everywhere
LEAF_STAGE_CASES = [
    ((3, 4, 2, 60), 9, 2, None),
    ((4, 3, 2, 200), 1, 0, None),        # P = 1
    ((5, 5, 2, None), 4, 4, None),       # 64 words: 1024 threads, 1 each
    ((3, 4, 2, None), 5, 5, 30),         # C - D = 9 < L = 16
    ((3, 4, 2, 40000), 2, 1, None),      # 1250 words: 2 a thread
]


@pytest.mark.parametrize("shape,P,dups,pool", LEAF_STAGE_CASES)
def test_leaf_stage_design_equals_bincount(shape, P, dups, pool):
    """The kernel's leaf stage, emulated with its own thread count, gives
    np.bincount's float64 sums rounded to float32 bit for bit, for
    payloads over 2^-30..2^30 whose float64 sums are not exact, and so
    does the plain ``leaf_loads``."""
    h = Hierarchy(*shape)
    C = pool or h.total_clients
    L = h.n_leaves
    rng = np.random.default_rng(C + P)
    ps = np.stack([rng.permutation(C)[:h.dimensions]
                   for _ in range(P)]).astype(np.int32)
    for i in range(1, dups + 1):
        ps[-i, 1::3] = ps[-i, 0]
    mds32 = _wide_payloads(C, seed=P)
    plan = ktpd.launch_plan(P, h.dimensions, C, L, build=True)
    want = _np_leaf_loads(ps, mds32, C, L)
    got = _emulate_leaf_stage(ps, mds32, C, L, plan.threads)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(leaf_loads(torch.as_tensor(ps), torch.as_tensor(mds32),
                                  L), torch.as_tensor(want))


def test_level_key_design_orders_floats():
    """The kernel reduces level maxima as unsigned keys: the key order is
    the float order (negatives, zeros, infinities, a positive NaN above
    +inf), and a key maps back to its float's bits."""
    x = np.array([-np.inf, -3e38, -1.5, -1e-40, -0.0, 0.0, 1e-45, 1e-40,
                  1.0, 1.0000001, 3e38, np.inf], np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    assert np.all(np.diff(key.astype(np.int64)) > 0)
    back = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    assert np.array_equal(back.astype(np.uint32), x.view(np.uint32))
    nan_key = np.uint64(0x7FC00000) | np.uint64(0x80000000)
    assert nan_key > key.max()


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
def test_launch_plan_at_the_main_path_shapes():
    """large-10k (D 1365, C 10,000, L 1024): 1024 threads, mdatasize and
    the leaf work area in shared memory beside the placement row, 4 (1365
    + 10,000 + 1024 + 2 x 313 + 10,000) bytes; past two particles an SM
    (P = 1000) 512 threads, 256 with the leaf loads given; the Fig. 3
    d3w4 tree (D 21, C 53): two warps; leaf loads given: the placement
    row only."""
    smem = 4 * (1365 + 10000 + 1024 + 626 + 10000)
    assert ktpd.launch_plan(10, 1365, 10000, 1024, build=True) == \
        ktpd.LaunchPlan("shared", 1024, smem, 0)
    assert ktpd.launch_plan(2 * 132, 1365, 10000, 1024, build=True) == \
        ktpd.LaunchPlan("shared", 1024, smem, 0)
    assert ktpd.launch_plan(1000, 1365, 10000, 1024, build=True) == \
        ktpd.LaunchPlan("shared", 512, smem, 0)
    assert ktpd.launch_plan(10, 1365, 10000, 1024, build=False) == \
        ktpd.LaunchPlan("given", 1024, 4 * 1365, 0)
    assert ktpd.launch_plan(1000, 1365, 10000, 1024, build=False) == \
        ktpd.LaunchPlan("given", 256, 4 * 1365, 0)
    assert ktpd.launch_plan(10, 21, 53, 16, build=True) == \
        ktpd.LaunchPlan("shared", 64, 4 * (21 + 53 + 16 + 4 + 53), 0)
    assert ktpd.launch_plan(10, 21, 53, 16, build=False).threads == 32


@pytest.mark.parametrize("D,L", [(21, 16), (364, 243), (1365, 1024),
                                 (781, 625)])
def test_launch_plan_takes_scratch_only_past_shared_memory(D, L):
    """mdatasize and the leaf work area stay in shared memory up to the
    largest C that fits beside the placement row and the static arrays;
    one client more and the work area moves to a scratch row of
    ``work_words`` words, the block keeping the placement row only."""
    room = ktpd.SMEM_PER_BLOCK - ktpd.STATIC_SMEM
    fits = max(C for C in range(D, 70000)
               if 4 * (D + C + ktpd.work_words(C, L)) <= room)
    inside = ktpd.launch_plan(10, D, fits, L, build=True)
    past = ktpd.launch_plan(10, D, fits + 1, L, build=True)
    assert inside.route == "shared" and inside.scratch_words == 0
    assert inside.smem_bytes == 4 * (D + fits + ktpd.work_words(fits, L)) \
        <= room
    assert past == ktpd.LaunchPlan("scratch", inside.threads, 4 * D,
                                   ktpd.work_words(fits + 1, L))


@pytest.mark.parametrize("P,D,C,L,build", [
    (1, 1, 1, 1, True), (3, 21, 30, 16, True), (10, 200, 5000, 100, True),
    (7, 40000, 60000, 20000, False), (7, ktpd.MAX_SLOTS, 10 ** 6, 9, True),
    (2, 33, 10 ** 6, 8, False), (265, 1365, 10000, 1024, True),
    (5000, 85, 213, 64, False), (5000, 21, 60000, 16, True)])
def test_launch_plan_blocks_fit_the_card(P, D, C, L, build):
    """Threads: whole warps, at least one a slot (and, building the leaf
    loads, a warp a bitmap word) up to 1024, and past two particles an SM
    at most the route's crowded size; every block's shared memory within
    what a block may take, up to ``MAX_SLOTS`` slots."""
    plan = ktpd.launch_plan(P, D, C, L, build)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    need = max(D, 32 * -(-C // 32)) if build else D
    cap = ktpd.CROWDED_THREADS[plan.route] if P > 2 * ktpd.H100_SMS \
        else 1024
    assert plan.threads == min(cap, 32 * -(-need // 32))
    assert plan.smem_bytes + ktpd.STATIC_SMEM <= ktpd.SMEM_PER_BLOCK
    assert plan.route == ("given" if not build else
                          "scratch" if plan.scratch_words else "shared")
