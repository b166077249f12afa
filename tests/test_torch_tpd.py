"""Port vs reference: the batched TPD (eqs. 6-7) — the plain torch
version of the kernel, the on-device trainer leaf loads, and the port's
CostModel backends.

Tolerances: the port's ``tpd_ref`` adds kids left to right and level
maxima deepest first, numpy's order for W < 8, so it equals the
reference's float32 numpy evaluator exactly (atol 0). XLA may sum the
kids in another order, so the jnp oracle and the Pallas interpreter are
held at rtol 1e-6 (a few f32 ulps). Against the float64 scalar model
the f32 paths keep the reference's documented rtol 2e-5.
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


@pytest.mark.parametrize("shape,hetero", [(s, h) for s in SHAPES
                                          for h in (False, True)])
def test_leaf_loads_match_numpy_prefix_sum(shape, hetero):
    ref, _ = _models(shape, hetero, 0.0)
    h = ref.hierarchy
    ps = _swarm(h, 11, seed=3, dup_rows=4)
    mds32 = ref._attr_stack(np.float32)[0]
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
