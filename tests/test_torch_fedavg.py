"""The port's FedAvg reductions against the reference's, on the CPU.

The reference side runs as its own tests run it: the Pallas kernels in
interpret mode (``fedavg_pallas`` / ``fedavg_batched_pallas`` with
``interpret=True``) and the JAX aggregator. The port side runs the plain
torch versions, which is what its wrappers hand every CPU tensor to (the
kernel itself runs on the card only: tests/test_torch_cuda.py).

Tolerances: float32 atol 1e-6 for one reduction (the Pallas body sums
with ``jnp.sum``, the port term by term); bf16 the reference's own
(tests/test_kernels.py: rtol = atol = 2e-2); the aggregator rtol 2e-5,
atol 2e-6, as tests/test_round_engine.py holds the reference's own
segment path to its sequential oracle.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.fl.aggregation import SegmentAggregator as RefAggregator
from repro.fl.aggregation import hierarchical_fedavg as ref_hierarchical_fedavg
from repro.kernels import ops as ref_ops
from repro.kernels.fedavg import fedavg_batched_pallas, fedavg_pallas
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.fl.aggregation import (
    SegmentAggregator,
    batched_hierarchical_fedavg,
    fedavg,
    hierarchical_fedavg,
)
from repro_torch.kernels import ops
from repro_torch.kernels import fedavg as kfedavg
from repro_torch.kernels.ref import fedavg_batched_ref, fedavg_ref, fedavg_rows_ref
from repro_torch.utils.trees import tree_leaves

F32 = dict(rtol=1e-7, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
AGG = dict(rtol=2e-5, atol=2e-6)


def _t(a, dtype=torch.float32):
    if dtype == torch.bfloat16:
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.tensor(np.asarray(a, np.float32))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("k,n", [(1, 7), (2, 64), (3, 2049), (5, 5000),
                                 (16, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_ref_matches_pallas(k, n, dtype):
    rng = np.random.default_rng(k * 1000 + n)
    x = rng.standard_normal((k, n)).astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x_j = jnp.asarray(x, jdt)
    want = fedavg_pallas(x_j, jnp.asarray(w, jdt), interpret=True)
    # the same (rounded) inputs on both sides
    got = fedavg_ref(_t(np.asarray(x_j, np.float32), tdt),
                     _t(np.asarray(jnp.asarray(w, jdt), np.float32)))
    assert got.dtype == tdt and tuple(got.shape) == (n,)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BF16 if dtype == "bfloat16" else F32))


@pytest.mark.parametrize("g,k,n", [(1, 2, 64), (4, 8, 2048), (3, 5, 5000),
                                   (2, 3, 7)])
def test_fedavg_batched_ref_matches_pallas(g, k, n):
    rng = np.random.default_rng(g * 100 + k)
    x = rng.standard_normal((g, k, n)).astype(np.float32)
    w = rng.dirichlet(np.ones(k), size=g).astype(np.float32)
    w[-1] = 0.0 if g > 1 else w[-1]   # a zero-weight padding cluster
    want = fedavg_batched_pallas(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True)
    got = fedavg_batched_ref(_t(x), _t(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    if g > 1:
        assert not got[-1].any()


def test_fedavg_batched_bf16_matches_pallas():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((3, 4, 3000)), jnp.bfloat16)
    w = jnp.asarray(rng.dirichlet(np.ones(4), size=3), jnp.float32)
    want = fedavg_batched_pallas(x, w, interpret=True)
    got = fedavg_batched_ref(_t(np.asarray(x, np.float32), torch.bfloat16),
                             _t(np.asarray(w)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **BF16)


def test_row_form_matches_pallas_on_the_gathered_stack():
    """The kernel's row-indexed operands: clusters of unequal fan-in
    reading rows of one pool, -1 padded, and a padding cluster with no
    rows at all — against the TPU kernel on the gathered dense stack with
    zero weights on the padding."""
    rng = np.random.default_rng(11)
    R, N = 9, 2051
    pool = rng.standard_normal((R, N)).astype(np.float32)
    rows = np.array([[4, 0, 7, -1, -1],
                     [2, 8, 1, 3, 5],
                     [-1, -1, -1, -1, -1],
                     [6, -1, -1, -1, -1]], np.int32)
    w = rng.uniform(0.1, 1.0, rows.shape).astype(np.float32)
    dense = pool[np.maximum(rows, 0)]
    w_dense = np.where(rows >= 0, w, 0.0).astype(np.float32)
    want = fedavg_batched_pallas(jnp.asarray(dense), jnp.asarray(w_dense),
                                 interpret=True)
    got = fedavg_rows_ref(_t(pool), torch.from_numpy(rows), _t(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert not got[2].any()
    # the row form is the dense form exactly when rows = arange(G * K)
    stack = torch.from_numpy(dense)
    G, K = rows.shape
    assert torch.equal(
        fedavg_rows_ref(stack.reshape(G * K, N),
                        torch.arange(G * K, dtype=torch.int32).view(G, K),
                        _t(w_dense)),
        fedavg_batched_ref(stack, _t(w_dense)))


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((4, 5, 1001)))
    w = _t(rng.dirichlet(np.ones(5), size=4))
    before = (kfedavg.fedavg_batched.launches, kfedavg.fedavg.launches)
    assert torch.equal(kfedavg.fedavg_batched(x, w), fedavg_batched_ref(x, w))
    assert torch.equal(kfedavg.fedavg(x[0], w[0]), fedavg_ref(x[0], w[0]))
    rows = torch.tensor([[3, 1, -1]], dtype=torch.int32)
    out = torch.full((1, 1001), 7.0)
    pool = x.reshape(20, 1001)
    res = kfedavg.fedavg_rows(pool, rows, w[0, :3].reshape(1, 3), out=out)
    assert res is out
    assert torch.equal(out, fedavg_rows_ref(pool, rows, w[0, :3].view(1, 3)))
    # a CPU tensor never launches anything
    assert (kfedavg.fedavg_batched.launches,
            kfedavg.fedavg.launches) == before


@pytest.mark.parametrize("bad,err,match", [
    (dict(rows=torch.tensor([[0, 9]], dtype=torch.int32)), ValueError,
     "rows must lie"),
    (dict(rows=torch.tensor([[0, -2]], dtype=torch.int32)), ValueError,
     "rows must lie"),
    (dict(rows=torch.tensor([[0, 1]], dtype=torch.int64)), TypeError,
     "int32"),
    (dict(w=torch.ones((1, 2), dtype=torch.float64)), TypeError, "float32"),
    (dict(pool=torch.zeros((4, 6), dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (dict(pool=torch.zeros((6, 4)).t()), ValueError, "contiguous"),
    (dict(rows=torch.zeros((1, 0), dtype=torch.int32),
          w=torch.zeros((1, 0))), ValueError, "K must be"),
    (dict(out=torch.zeros((2, 6))), ValueError, "out must be"),
])
def test_wrapper_rejects_malformed_operands(bad, err, match):
    ops_ = dict(pool=torch.zeros((4, 6)),
                rows=torch.tensor([[0, 1]], dtype=torch.int32),
                w=torch.ones((1, 2)))
    ops_.update(bad)
    out = ops_.pop("out", None)
    with pytest.raises(err, match=match):
        kfedavg.fedavg_rows(ops_["pool"], ops_["rows"], ops_["w"], out=out)


def test_fedavg_tree_matches_reference():
    rng = np.random.default_rng(2)
    trees = [{"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(11).astype(np.float32)]}
             for _ in range(5)]
    w = list(rng.dirichlet(np.ones(5)).astype(np.float32))
    want = ref_ops.fedavg_tree(jax.tree.map(jnp.asarray, trees), w,
                               use_pallas=True, interpret=True)
    got = ops.fedavg_tree(
        [{"a": _t(t["a"]), "b": [_t(t["b"][0])]} for t in trees], w)
    assert tuple(got["a"].shape) == (4, 3)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32)


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------
def _case(seed, depth, width, tpl, n=None):
    rng = np.random.default_rng(seed)
    h = Hierarchy(depth, width, tpl, n)
    C = h.total_clients
    stacked = {"w": rng.standard_normal((C, 3, 4)).astype(np.float32),
               "b": rng.standard_normal((C, 5)).astype(np.float32)}
    w = rng.dirichlet(np.ones(C)).astype(np.float32)
    placement = rng.permutation(C)[:h.dimensions]
    return h, RefHierarchy(depth, width, tpl, n), stacked, w, placement


def _port_stack(stacked):
    return {k: torch.from_numpy(v.copy()) for k, v in stacked.items()}


CASES = [(0, 1, 2, 2, None), (1, 2, 2, 2, 11), (2, 3, 2, 2, None),
         (3, 2, 3, 4, 40), (4, 3, 3, 1, None)]


@pytest.mark.parametrize("case", CASES)
def test_aggregator_matches_reference(case):
    h, rh, stacked, w, placement = _case(*case)
    ref = RefAggregator(rh)
    plan_r = rh.round_plan(placement)
    jstack = jax.tree.map(jnp.asarray, stacked)
    want_fused = ref.aggregate_fused(jstack, w, plan_r)
    want = ref.aggregate(ref.weighted(jstack, w), plan_r)
    agg = SegmentAggregator(h)
    plan = h.round_plan(placement)
    got_fused = agg.aggregate_fused(_port_stack(stacked), w, plan)
    got = agg.aggregate(agg.weighted(_port_stack(stacked), w), plan)
    for k in ("w", "b"):
        np.testing.assert_allclose(got_fused[k].numpy(),
                                   np.asarray(want_fused[k]), **AGG)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **AGG)
    # level by level, as measured timing runs it
    weighted = agg.weighted(_port_stack(stacked), w)
    vals = None
    for idx in range(len(plan.levels)):
        vals = agg.run_level(idx, weighted, vals, plan)
        assert vals["w"].shape[0] == plan.levels[idx].n_clusters
    for k in ("w", "b"):
        np.testing.assert_allclose(vals[k][0].numpy(), got[k].numpy(),
                                   **AGG)


@pytest.mark.parametrize("case", CASES)
def test_hierarchical_equals_flat_and_reference(case):
    h, rh, stacked, w, placement = _case(*case)
    C = h.total_clients
    updates = [{k: torch.from_numpy(v[c].copy()) for k, v in stacked.items()}
               for c in range(C)]
    tree = hierarchical_fedavg(updates, list(w), h, placement)
    flat = fedavg(updates, list(w))
    batched = batched_hierarchical_fedavg(_port_stack(stacked), w, h,
                                          placement)
    want = ref_hierarchical_fedavg(
        [jax.tree.map(jnp.asarray, {k: v[c] for k, v in stacked.items()})
         for c in range(C)], list(w), rh, placement)
    for k in ("w", "b"):
        np.testing.assert_allclose(tree[k].numpy(), flat[k].numpy(), **AGG)
        np.testing.assert_allclose(batched[k].numpy(), tree[k].numpy(),
                                   **AGG)
        np.testing.assert_allclose(tree[k].numpy(), np.asarray(want[k]),
                                   **AGG)


def test_client_stack_is_read_in_place_and_result_is_a_copy():
    h, _, stacked, w, placement = _case(*CASES[2])
    agg = SegmentAggregator(h)
    template = {k: torch.zeros(v.shape[1:]) for k, v in stacked.items()}
    stack = agg.client_stack(template)
    for k in stack:
        stack[k].copy_(torch.from_numpy(stacked[k]))
    plan = h.round_plan(placement)
    got = agg.aggregate_fused(stack, w, plan)
    want = SegmentAggregator(h).aggregate_fused(_port_stack(stacked), w,
                                                plan)
    for k in ("w", "b"):
        assert torch.equal(got[k], want[k])
    got_w = got["w"].clone()
    agg.aggregate_fused(stack, np.zeros_like(w), plan)  # reuses the buffer
    assert torch.equal(got["w"], got_w)


def test_retarget_reports_shape_changes():
    agg = SegmentAggregator(Hierarchy(2, 2, 2))
    assert not agg.retarget(Hierarchy(2, 2, 2, n_clients=12))
    assert agg.retarget(Hierarchy(3, 2, 2))


def test_bf16_stack_rounds_weights_like_the_reference():
    h, rh, stacked, w, placement = _case(*CASES[1])
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in stacked.items()}
    jbf = {k: jnp.asarray(v.astype(ml_dtypes.bfloat16))
           for k, v in stacked.items()}
    got = SegmentAggregator(h).aggregate_fused(bf, w, h.round_plan(placement))
    want = RefAggregator(rh).aggregate_fused(jbf, w, rh.round_plan(placement))
    for k in ("w", "b"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k], np.float32),
                                   **BF16)
