"""The port's kernels on the card, held to their plain torch versions.

Every test here is marked ``cuda`` and skips on a host without a card.
This file imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch for CUDA and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.experiments import get_scenario, run_single
from repro_torch.kernels import fedavg as kfedavg
from repro_torch.kernels.ref import fedavg_batched_ref, fedavg_ref, fedavg_rows_ref, tpd_ref
from repro_torch.kernels.tpd import batch_tpd_cuda, launch_plan, leaf_loads, tpd_kernel_inputs

# (depth, width, trainers/leaf, clients)
SHAPES = [(3, 4, 2, 60), (4, 3, 2, 200), (2, 5, 3, None), (5, 5, 2, None),
          (6, 4, 2, 10000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _operands(shape, P, penalty, device):
    depth, width, tpl, n = shape
    h = Hierarchy(depth, width, tpl, n)
    C = h.total_clients
    rng = np.random.default_rng(depth * 10 + width)
    pool = ClientPool.random(C, seed=depth)
    pool.mdatasize = rng.uniform(1.0, 40.0, C)
    ps = np.stack([rng.permutation(C)[:h.dimensions]
                   for _ in range(P)]).astype(np.int32)
    ps[-1, 1] = ps[-1, 0]  # a duplicate-id row
    cm = CostModel(h, pool, memory_penalty=penalty, device=device)
    return h, cm, ps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("penalty", [0.0, 3.0])
def test_kernel_equals_plain_version(cuda_device, shape, penalty):
    h, cm, ps = _operands(shape, 33, penalty, cuda_device)
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    leaf = leaf_loads(p, attrs[0], h.n_leaves)
    tables = tpd_kernel_inputs(h, device=cuda_device)
    before = batch_tpd_cuda.launches
    got = batch_tpd_cuda(p, attrs, leaf, *tables, penalty=penalty)
    torch.cuda.synchronize()
    assert batch_tpd_cuda.launches == before + 1
    want = tpd_ref(p, attrs, leaf, *tables, penalty=penalty)
    assert torch.equal(got, want)  # atol 0
    np.testing.assert_allclose(got.cpu().numpy()[:3],
                               [cm.tpd(row) for row in ps[:3]], rtol=2e-5)


@pytest.mark.cuda
def test_cost_model_kernel_backend_matches_torch_backend(cuda_device):
    h, cm, ps = _operands(SHAPES[1], 12, 3.0, cuda_device)
    np.testing.assert_array_equal(cm.batch_tpd(ps),  # auto: the kernel
                                  cm.batch_tpd(ps, backend="torch"))
    np.testing.assert_array_equal(cm.batch_tpd(ps, backend="kernel"),
                                  cm.batch_tpd(ps, backend="np"))


@pytest.mark.cuda
def test_wrapper_rejects_malformed_operands(cuda_device):
    h, cm, ps = _operands(SHAPES[0], 4, 0.0, cuda_device)
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    leaf = leaf_loads(p, attrs[0], h.n_leaves)
    kids, starts = tpd_kernel_inputs(h, device=cuda_device)
    before = batch_tpd_cuda.launches
    with pytest.raises(ValueError, match="level_starts"):
        batch_tpd_cuda(p, attrs, leaf, kids, starts[:-1] + (starts[-1] + 1,))
    with pytest.raises(TypeError, match="placements"):
        batch_tpd_cuda(p.long(), attrs, leaf, kids, starts)
    with pytest.raises(ValueError, match="leaf_load"):
        batch_tpd_cuda(p, attrs, leaf[:, 1:].contiguous(), kids, starts)
    with pytest.raises(ValueError, match="leaf_out"):
        batch_tpd_cuda(p, attrs, None, kids, starts,
                       leaf_out=leaf[:, 1:].contiguous())
    with pytest.raises(ValueError, match="leaf_out"):
        batch_tpd_cuda(p, attrs, leaf, kids, starts, leaf_out=leaf.clone())
    assert batch_tpd_cuda.launches == before


def _np_leaf_loads(ps, mds32, C, L):
    """The reference's host prefix-sum of trainer loads (float64
    bincount in ascending client id, rounded to float32)."""
    P = ps.shape[0]
    p_off = np.arange(P)[:, None]
    unplaced = np.bincount((ps + C * p_off).ravel(),
                           minlength=P * C).reshape(P, C) == 0
    t_mds = np.where(unplaced, mds32[None], np.float32(0.0))
    leaf_of = (np.cumsum(unplaced, axis=1) - 1) % L
    return np.bincount((leaf_of + L * p_off).ravel(), weights=t_mds.ravel(),
                       minlength=P * L).reshape(P, L).astype(np.float32)


def _built_case(h, P, penalty, device, seed, wide=True):
    """A swarm with duplicate-id rows over a pool whose payloads spread
    over 2^-30..2^30 (float64 leaf sums that are not exact)."""
    C = h.total_clients
    rng = np.random.default_rng(seed)
    pool = ClientPool.random(C, seed=seed)
    if wide:
        pool.mdatasize = 2.0 ** rng.uniform(-30, 30, C)
    ps = np.stack([rng.permutation(C)[:h.dimensions]
                   for _ in range(P)]).astype(np.int32)
    for i in range(1, min(3, P - 1) + 1):
        ps[-i, 1::4] = ps[-i, 0]
    cm = CostModel(h, pool, memory_penalty=penalty, device=device)
    return cm, ps


BUILT_TREES = {"fig3 d3w4": lambda: Hierarchy(3, 4, 2),
               "fig3 d5w5": lambda: Hierarchy(5, 5, 2),
               "large-1k": lambda: get_scenario("large-1k").make_hierarchy(),
               "large-10k": lambda: get_scenario("large-10k").make_hierarchy()}


@pytest.mark.cuda
@pytest.mark.parametrize("tree", list(BUILT_TREES))
@pytest.mark.parametrize("P", [1, 10, 1000])
@pytest.mark.parametrize("penalty", [0.0, 3.0])
def test_built_leaf_mode_equals_plain_versions(cuda_device, tree, P,
                                               penalty):
    """One launch builds the leaf loads and scores the swarm: its leaf
    loads equal np.bincount's, its TPDs tpd_ref's on them and the
    leaf-given route's, bit for bit; a rerun is bit-equal."""
    h = BUILT_TREES[tree]()
    cm, ps = _built_case(h, P, penalty, cuda_device, seed=P + len(tree))
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    tables = tpd_kernel_inputs(h, device=cuda_device)
    want_leaf = torch.as_tensor(_np_leaf_loads(
        ps, cm._attr_stack(np.float32)[0], h.total_clients, h.n_leaves),
        device=cuda_device)
    got_leaf = torch.empty_like(want_leaf)
    before = dict(batch_tpd_cuda.routes)
    got = batch_tpd_cuda(p, attrs, None, *tables, penalty=penalty,
                         leaf_out=got_leaf)
    again = batch_tpd_cuda(p, attrs, None, *tables, penalty=penalty)
    given = batch_tpd_cuda(p, attrs, want_leaf, *tables, penalty=penalty)
    torch.cuda.synchronize()
    assert batch_tpd_cuda.routes["shared"] == before["shared"] + 2
    assert batch_tpd_cuda.routes["given"] == before["given"] + 1
    assert torch.equal(got_leaf, want_leaf)
    assert torch.equal(leaf_loads(p, attrs[0], h.n_leaves), want_leaf)
    want = tpd_ref(p, attrs, want_leaf, *tables, penalty=penalty)
    assert torch.equal(got, want) and torch.equal(given, want)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_built_leaf_mode_on_the_scratch_route(cuda_device):
    """60,000 clients: the leaf work area (~255 KB) leaves shared memory
    for a scratch tensor; the results are the same bits."""
    h = Hierarchy(3, 4, 2, 60000)
    cm, ps = _built_case(h, 5, 3.0, cuda_device, seed=11)
    plan = launch_plan(5, h.dimensions, h.total_clients, h.n_leaves, True)
    assert plan.route == "scratch"
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    tables = tpd_kernel_inputs(h, device=cuda_device)
    got_leaf = torch.empty((5, h.n_leaves), device=cuda_device)
    before = batch_tpd_cuda.routes["scratch"]
    got = batch_tpd_cuda(p, attrs, None, *tables, penalty=3.0,
                         leaf_out=got_leaf)
    torch.cuda.synchronize()
    assert batch_tpd_cuda.routes["scratch"] == before + 1
    want_leaf = _np_leaf_loads(ps, cm._attr_stack(np.float32)[0],
                               h.total_clients, h.n_leaves)
    assert np.array_equal(got_leaf.cpu().numpy(), want_leaf)
    want = tpd_ref(p, attrs, torch.as_tensor(want_leaf, device=cuda_device),
                   *tables, penalty=3.0)
    assert torch.equal(got, want)
    assert torch.equal(batch_tpd_cuda(p, attrs, None, *tables, penalty=3.0),
                       got)


@pytest.mark.cuda
def test_kernel_backend_is_one_launch_a_call(cuda_device):
    """``batch_tpd(backend="kernel")`` launches the kernel once a call,
    on the route that builds the leaf loads, and equals the numpy
    backend."""
    h = get_scenario("large-1k").make_hierarchy()
    cm, ps = _built_case(h, 10, 0.0, cuda_device, seed=4)
    before, shared = batch_tpd_cuda.launches, batch_tpd_cuda.routes["shared"]
    got = cm.batch_tpd(ps, backend="kernel")
    assert batch_tpd_cuda.launches == before + 1
    assert batch_tpd_cuda.routes["shared"] == shared + 1
    np.testing.assert_array_equal(got, cm.batch_tpd(ps, backend="np"))
    np.testing.assert_array_equal(got, cm.batch_tpd(ps, backend="torch"))


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------
# (R, N, G, K): ragged tails (N = 7, 2049, 1001), odd row alignment, K = 1
FEDAVG_SHAPES = [(9, 7, 2, 5), (12, 2049, 3, 4), (5, 1001, 1, 1),
                 (40, 4096, 4, 10)]


def _fedavg_operands(shape, dtype, device):
    R, N, G, K = shape
    rng = np.random.default_rng(R * N)
    pool = torch.as_tensor(rng.standard_normal((R, N)).astype(np.float32),
                           device=device).to(dtype)
    rows = rng.integers(-1, R, size=(G, K)).astype(np.int32)
    rows[:, 0] = rng.integers(0, R, size=G)
    w = rng.uniform(0.0, 1.0, size=(G, K)).astype(np.float32)
    return pool, torch.from_numpy(rows), torch.from_numpy(w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FEDAVG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_kernel_equals_plain_version(cuda_device, shape, dtype):
    pool, rows, w = _fedavg_operands(shape, dtype, cuda_device)
    before = kfedavg.fedavg_batched.launches
    got = kfedavg.fedavg_rows(pool, rows, w)
    torch.cuda.synchronize()
    assert kfedavg.fedavg_batched.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, fedavg_rows_ref(pool, rows, w))   # atol 0
    # the dense forms
    R, N, G, K = shape
    dense = pool[: (R // K) * K].reshape(R // K, K, N)
    wd = torch.rand((R // K, K), generator=torch.Generator().manual_seed(R))
    assert torch.equal(kfedavg.fedavg_batched(dense, wd.to(cuda_device)),
                       fedavg_batched_ref(dense, wd.to(cuda_device)))
    assert torch.equal(kfedavg.fedavg(dense[0], wd[0]),
                       fedavg_ref(dense[0], wd[0].to(cuda_device)))


@pytest.mark.cuda
def test_fedavg_wrapper_rejects_malformed_operands(cuda_device):
    pool, rows, w = _fedavg_operands(FEDAVG_SHAPES[1], torch.float32,
                                     cuda_device)
    before = kfedavg.fedavg_batched.launches
    with pytest.raises(TypeError, match="int32"):
        kfedavg.fedavg_rows(pool, rows.long(), w)
    with pytest.raises(ValueError, match="rows must lie"):
        kfedavg.fedavg_rows(pool, rows + 100, w)
    with pytest.raises(ValueError, match="rows must lie"):
        kfedavg.fedavg_rows(pool, (rows + 100).to(cuda_device), w)
    with pytest.raises(ValueError, match="contiguous"):
        kfedavg.fedavg_rows(pool.t(), rows, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kfedavg.fedavg_rows(pool.half(), rows, w)
    assert kfedavg.fedavg_batched.launches == before


@pytest.mark.cuda
def test_fig4_smoke_model_same_tpds_on_cuda_and_cpu(cuda_device):
    spec = get_scenario("paper-fig4").with_overrides(model="mlp-smoke")
    runs = {dev: run_single(spec, "pso", seed=0, rounds=4, device=dev)
            for dev in ("cuda", "cpu")}
    assert runs["cuda"].tpds == runs["cpu"].tpds
    np.testing.assert_allclose(runs["cuda"].metrics["loss"],
                               runs["cpu"].metrics["loss"], rtol=1e-4)


@pytest.mark.cuda
def test_two_tier_batch_tpd_on_cuda_launches_no_kernel(cuda_device):
    """The TPD kernel does not price pod edges: on the card a two-tier
    model's swarms go through the pod-aware torch build, never the
    kernel, within rtol 2e-5 of the float64 scalar model."""
    from repro_torch.core.cost_model import TwoTierCostModel
    h = Hierarchy(depth=5, width=3, trainers_per_leaf=2, n_clients=1024)
    rng = np.random.default_rng(0)
    pool = ClientPool.random(1024, seed=0)
    pool.mdatasize = rng.uniform(1.0, 40.0, 1024)
    tt = TwoTierCostModel(h, pool, memory_penalty=2.0, device=cuda_device,
                          pod_of=rng.integers(0, 8, 1024))
    ps = np.stack([rng.permutation(1024)[:h.dimensions] for _ in range(64)])
    ps[0, 1] = ps[0, 0]
    before = batch_tpd_cuda.launches
    got = tt.batch_tpd(ps)
    torch.cuda.synchronize()
    assert batch_tpd_cuda.launches == before
    assert getattr(tt, "_batch_tpd_torch", None) is not None
    np.testing.assert_allclose(got, [tt.tpd(p) for p in ps], rtol=2e-5)
    with pytest.raises(ValueError, match="pod"):
        tt.batch_tpd(ps, backend="kernel")
    assert batch_tpd_cuda.launches == before


@pytest.mark.cuda
def test_emulated_fault_path_same_on_cuda_and_cpu(cuda_device, tmp_path):
    """The chaos preset's faults on the emulated track: placements, TPDs
    and fault series exactly, losses within rtol 1e-4; a resumed cuda
    run equals the uninterrupted one byte for byte."""
    import json
    spec = get_scenario("chaos").with_overrides(model="mlp-smoke") \
        .for_env("emulated")
    runs = {dev: run_single(spec, "pso", seed=0, rounds=8, device=dev)
            for dev in ("cuda", "cpu")}
    a, b = runs["cuda"], runs["cpu"]
    assert a.tpds == b.tpds and a.event_log == b.event_log
    for k in ("merged", "down", "partitioned", "faults", "failovers",
              "dropped_updates", "degraded_flushes"):
        assert a.metrics[k] == b.metrics[k]
    np.testing.assert_allclose(a.metrics["loss"], b.metrics["loss"],
                               rtol=1e-4)
    run_single(spec, "pso", seed=0, rounds=4, device="cuda",
               checkpoint_dir=str(tmp_path))
    resumed = run_single(spec, "pso", seed=0, rounds=8, device="cuda",
                         checkpoint_dir=str(tmp_path), resume=True)
    assert json.dumps(resumed.to_dict(), sort_keys=True) == \
        json.dumps(a.to_dict(), sort_keys=True)


# ---------------------------------------------------------------------------
# flash attention and the RG-LRU scan
# ---------------------------------------------------------------------------
# (b, hq, hkv, s, hd, causal, window, kv_len): recurrentgemma's MQA at hd
# 256 (group 10), GQA group 2 at hd 64, hd 128; ragged S, windows, kv_len;
# hd 80 (stablelm-3b's: padded to 128 on the bf16 route, native on f32)
FLASH_CASES = [(2, 10, 1, 200, 256, True, None, None),
               (2, 10, 1, 200, 256, True, 48, None),
               (1, 10, 1, 97, 256, True, 32, 90),
               (1, 4, 2, 129, 64, True, None, None),
               (1, 4, 2, 129, 64, False, 40, 100),
               (2, 2, 2, 64, 128, False, None, None),
               (1, 2, 1, 33, 64, True, 1, 0),
               (1, 4, 2, 129, 80, True, None, None),
               (2, 8, 8, 200, 80, False, 48, 150)]
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _flash_operands(case, dtype, device):
    b, hq, hkv, s, hd = case[:5]
    g = torch.Generator().manual_seed(s * hq + hd)
    return [torch.randn(shape, generator=g).to(device, dtype)
            for shape in ((b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda_device, case, dtype):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_operands(case, dtype, cuda_device)
    causal, window, kv_len = case[5:]
    before = kflash.flash_attention.launches
    got = kflash.flash_attention(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len)
    torch.cuda.synchronize()
    assert kflash.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


# (B, T, D): ragged D (the cp.async route: 280-byte f32 rows), a model
# width, a narrow one; recurrentgemma-2b's training shape; T not a
# multiple of the ring's 64-step stages; odd D (bf16 rows of 5,122 bytes)
RGLRU_SHAPES = [(2, 100, 70), (1, 33, 2560), (3, 16, 64), (1, 2048, 2560),
                (1, 1000, 2560), (2, 77, 2561)]


def _rglru_operands(shape, dtype, device, n, seed, offset=0):
    """``n`` (B, T, D) operands, a in [0.8, 1] then standard normals;
    ``offset`` elements into a fresh buffer (a misaligned base)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n):
        x = torch.rand(shape, generator=g).mul(0.2).add(0.8) if i == 0 \
            else torch.randn(shape, generator=g)
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=device)
        view = buf[offset:].view(shape)
        view.copy_(x)
        out.append(view)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_equals_plain_version(cuda_device, shape, dtype):
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import rglru_scan_ref
    a, u = _rglru_operands(shape, dtype, cuda_device, 2, shape[1])
    route = krglru.copy_route(shape[2], a.element_size(),
                              (a.data_ptr(), u.data_ptr()))
    before = (krglru.rglru_scan.launches,
              krglru.rglru_scan.routes.get(route, 0))
    got = krglru.rglru_scan(a, u)
    torch.cuda.synchronize()
    assert (krglru.rglru_scan.launches,
            krglru.rglru_scan.routes.get(route, 0)) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, rglru_scan_ref(a, u))   # atol 0


@pytest.mark.cuda
@pytest.mark.parametrize("route,offset", [("tma", 0), ("cp_async", 1)])
@pytest.mark.parametrize("t,depth", [(100, 2), (150, 3), (1000, 4)])
def test_rglru_kernel_at_every_route_and_depth(cuda_device, route, offset,
                                               t, depth):
    """Both walks at one TMA-able width (D 80, a partial group of 32; B
    2) through each route, the cp.async one reached by operands one
    element past an aligned base, at T whose plan picks ring depths 2, 3
    and 4 for the f32 scan (bf16 and the adjoint take their own, up to
    7: ``tests/test_torch_rglru.py::DEPTH_CASES``), bit-equal to the
    plain versions."""
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    for dtype in (torch.float32, torch.bfloat16):
        a, u, dh = _rglru_operands((2, t, 80), dtype, cuda_device, 3, t,
                                   offset=offset)
        plan = krglru.plan_for((a, u))
        assert plan.route == route
        if dtype == torch.float32:
            assert plan.stages == depth
        before = (krglru.rglru_scan.routes.get(route, 0),
                  krglru.rglru_scan_bwd.routes.get(route, 0))
        h = krglru.rglru_scan(a, u)
        da, du = krglru.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        assert (krglru.rglru_scan.routes.get(route, 0),
                krglru.rglru_scan_bwd.routes.get(route, 0)) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(h, rglru_scan_ref(a, u))
        want = rglru_scan_bwd_ref(a, h, dh)
        assert torch.equal(da, want[0]) and torch.equal(du, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_rglru_kernel_on_misaligned_bf16_operands(cuda_device, offset):
    """bf16 operands 2 (or 4) bytes past an aligned base take the
    cp.async route, whose 4-byte words then hold each element in the
    other half: both walks still bit-equal to the plain versions."""
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    for shape in [(1, 130, 2560), (2, 77, 2561)]:
        a, u, dh = _rglru_operands(shape, torch.bfloat16, cuda_device, 3,
                                   offset, offset=offset)
        assert krglru.copy_route(shape[2], 2, (a.data_ptr(),)) == "cp_async"
        before = krglru.rglru_scan.routes.get("cp_async", 0)
        h = krglru.rglru_scan(a, u)
        da, du = krglru.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        assert krglru.rglru_scan.routes["cp_async"] == before + 1
        assert torch.equal(h, rglru_scan_ref(a, u))
        want = rglru_scan_bwd_ref(a, h, dh)
        assert torch.equal(da, want[0]) and torch.equal(du, want[1])


@pytest.mark.cuda
def test_rglru_reaches_both_copy_routes(cuda_device):
    """A model width launches the TMA route and a 280-byte row the
    cp.async route, for the scan and for its adjoint, and neither
    launches the other."""
    from repro_torch.kernels import rglru as krglru
    for shape, route in (((1, 300, 2560), "tma"), ((2, 100, 70), "cp_async")):
        before = (dict(krglru.rglru_scan.routes),
                  dict(krglru.rglru_scan_bwd.routes))
        a, u = _rglru_operands(shape, torch.float32, cuda_device, 2, 1)
        krglru.rglru_scan(a.clone().requires_grad_(), u).sum().backward()
        torch.cuda.synchronize()
        for fn, was in zip((krglru.rglru_scan, krglru.rglru_scan_bwd),
                           before, strict=True):
            went = {r: n - was.get(r, 0) for r, n in fn.routes.items()
                    if n != was.get(r, 0)}
            assert went == {route: 1}, (fn.__name__, went)


@pytest.mark.cuda
def test_attention_and_scan_wrappers_reject_malformed_operands(cuda_device):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import rglru as krglru
    q, k, v = _flash_operands(FLASH_CASES[3], torch.float32, cuda_device)
    before = (kflash.flash_attention.launches, krglru.rglru_scan.launches)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kflash.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        kflash.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    with pytest.raises(ValueError, match="is on cpu"):
        kflash.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        kflash.flash_attention(q[:, :3].contiguous(), k, v)
    a = torch.rand((2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        krglru.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(TypeError, match="both be float32"):
        krglru.rglru_scan(a, a.bfloat16())
    assert (kflash.flash_attention.launches,
            krglru.rglru_scan.launches) == before


@pytest.mark.cuda
def test_hybrid_serving_on_cuda_matches_cpu(cuda_device):
    """recurrentgemma-2b reduced to one triple and two tails, float32:
    prefill and a decode step on the card (through both kernels) against
    the same params on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import rglru as krglru
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype="float32", local_attn_window=16)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    params_dev = tree_map(lambda x: x.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_dev)):
        before = (kflash.flash_attention.launches, krglru.rglru_scan.launches)
        logits, st = model.prefill_fn(p, {"tokens": toks[:, :40].to(dev)})
        step, _ = model.decode_fn(p, st, {"token": toks[:, 40:].to(dev)})
        launched = (kflash.flash_attention.launches - before[0],
                    krglru.rglru_scan.launches - before[1])
        assert launched == ((1, 4) if dev == "cuda" else (0, 0))
        out[dev] = (logits.cpu(), step.cpu())
    for got, want in zip(out["cuda"], out["cpu"], strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---- training: fused AdamW and the backward kernels ---------------------------
def _adamw_operands(n, dtype, device, seed, offset=0):
    """Flat p, g (dtype), m, v (float32) of n elements, each a view that
    starts ``offset`` elements into its buffer."""
    g = torch.Generator().manual_seed(seed)

    def buf(scale, dt, positive=False):
        x = torch.randn(n, generator=g) * scale
        x = x.abs() if positive else x
        full = torch.zeros(offset + n, dtype=dt, device=device)
        full[offset:] = x.to(device, dt)
        return full[offset:]

    return (buf(1.0, dtype), buf(1e-2, dtype), buf(1e-3, torch.float32),
            buf(1e-5, torch.float32, positive=True))


def _adamw_scalars(step):
    bc1 = np.float32(1) - np.float32(0.9) ** np.float32(step)
    bc2 = np.float32(1) - np.float32(0.95) ** np.float32(step)
    return np.float32(3e-4), bc1, bc2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4097, 2 ** 20 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("offset", [0, 1])      # 1: misaligned, scalar path
def test_adamw_kernel_equals_plain_version(cuda_device, n, dtype, step,
                                           offset):
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels.ref import fused_adamw_ref
    p, g, m, v = _adamw_operands(n, dtype, cuda_device, seed=n, offset=offset)
    scalars = _adamw_scalars(step)
    want = fused_adamw_ref(p, g, m, v, *scalars)
    before = kadamw.fused_adamw.launches
    got = kadamw.fused_adamw(p, g, m, v, *scalars)
    torch.cuda.synchronize()
    assert kadamw.fused_adamw.launches == before + 1
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)                    # bit for bit


@pytest.mark.cuda
def test_adamw_kernel_beyond_element_2_31(cuda_device):
    """One launch over N = 2^31 + 2^20 + 5 bfloat16 params (float32
    moments: 26 GB in all): a window past element 2^31 equals the plain
    version run on copies of it (64-bit indices)."""
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels.ref import fused_adamw_ref
    n = 2 ** 31 + 2 ** 20 + 5
    p = torch.zeros(n, dtype=torch.bfloat16, device=cuda_device)
    g = torch.zeros_like(p)
    m = torch.zeros(n, dtype=torch.float32, device=cuda_device)
    v = torch.zeros_like(m)
    lo = 2 ** 31 + 3
    win = slice(lo, n)
    for dst, src in zip((p, g, m, v), _adamw_operands(
            n - lo, torch.bfloat16, cuda_device, seed=7), strict=True):
        dst[win] = src
    scalars = _adamw_scalars(10)
    want = fused_adamw_ref(p[win].clone(), g[win].clone(), m[win].clone(),
                           v[win].clone(), *scalars)
    kadamw.fused_adamw(p, g, m, v, *scalars)
    torch.cuda.synchronize()
    for x, y in zip((p[win], m[win], v[win]), want, strict=True):
        assert torch.equal(x, y)
    assert not p[:lo].any()      # zero state and grads leave zeros
    del p, g, m, v
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_adamw_wrapper_rejects_malformed_operands(cuda_device):
    from repro_torch.kernels import fused_adamw as kadamw
    p, g, m, v = _adamw_operands(64, torch.float32, cuda_device, seed=1)
    before = kadamw.fused_adamw.launches
    for args, err in (((p, g.bfloat16(), m, v), TypeError),
                      ((p, g, m.double(), v), TypeError),
                      ((p.half(), g.half(), m, v), TypeError),
                      ((p, g, m, v[:10]), ValueError),
                      ((p, g.cpu(), m, v), ValueError),
                      ((p.view(8, 8), g.view(8, 8), m.view(8, 8),
                        v.view(8, 8)), ValueError),
                      ((p[::2], g[::2], m[::2], v[::2]), ValueError)):
        with pytest.raises(err):
            kadamw.fused_adamw(*args, 1e-3, 0.1, 0.05)
    assert kadamw.fused_adamw.launches == before


# (B, Hq, Hkv, S, hd, causal, window, kv_len)
FLASH_GRAD_CASES = [(1, 10, 1, 130, 256, True, None, None),
                    (2, 4, 2, 100, 64, True, 32, None),
                    (1, 4, 1, 77, 128, False, 20, 60),
                    (1, 2, 2, 64, 64, True, None, 40),
                    (1, 4, 2, 129, 80, True, 48, None)]
# f32: against autograd of the dense plain version, relative to each
# gradient's scale (P recomputed from lse, sums in other orders); bf16:
# one bf16 rounding of each gradient and of the output D is formed from
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain_autograd(cuda_device, case, dtype):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_operands(case, dtype, cuda_device)
    causal, window, kv_len = case[5:]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)
                       ).to(cuda_device, dtype)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (kflash.flash_attention.launches,
                  kflash.flash_attention_bwd.launches)
        out = kflash.flash_attention(*leaves, causal=causal, window=window,
                                     kv_len=kv_len)
        out.backward(dout)
        torch.cuda.synchronize()
        # both routes: dq, partial dk and dv, their sum
        assert (kflash.flash_attention.launches - before[0],
                kflash.flash_attention_bwd.launches - before[1]) == (1, 3)
        runs.append([t.grad for t in leaves])
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)                   # no atomics: repeatable
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, causal=causal, window=window,
                        kv_len=kv_len).backward(dout)
    for name, got, want in zip("qkv", runs[0], (t.grad for t in leaves),
                               strict=True):
        assert got.dtype == dtype
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= FLASH_GRAD_TOL[dtype] * scale, (name, err, scale)


# bf16 tensor-core kernels at every tile edge: (B, Hq, Hkv, S, hd, causal,
# window, kv_len), S in {1, 63, 64, 65, 127, 128, 129, 2049} (64-row
# tiles, 128-row forward blocks), windows 1, 16, 64, 2048, kv_len 0, on a
# tile edge (64, 128, 192) and off it, hd 64, 128, 256, groups 1, 2, 10
BF16_EDGE_CASES = [(1, 2, 1, 1, 64, True, None, None),
                   (1, 1, 1, 63, 128, True, None, None),
                   (2, 2, 2, 64, 256, True, None, None),
                   (1, 10, 1, 65, 256, True, 16, None),
                   (1, 4, 2, 127, 64, False, None, 64),
                   (1, 2, 1, 128, 128, True, 64, None),
                   (1, 10, 1, 129, 256, False, None, 100),
                   (1, 2, 1, 129, 64, True, 1, None),
                   (1, 4, 2, 100, 128, True, None, 0),
                   (2, 1, 1, 200, 64, True, None, 192),
                   (1, 2, 1, 2049, 64, False, None, 128),
                   (1, 10, 1, 2049, 256, True, 2048, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_EDGE_CASES)
def test_flash_bf16_forward_at_tile_edges(cuda_device, case):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_operands(case, torch.bfloat16, cuda_device)
    causal, window, kv_len = case[5:]
    got, lse = kflash._forward(q, k, v, (causal, window, q.shape[-1] ** -0.5,
                                         kv_len), with_lse=True)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, kv_len=kv_len,
                                         return_lse=True)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])
    # lse: float32 on both sides, from bf16 products summed in f32
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_EDGE_CASES)
def test_flash_bf16_backward_at_tile_edges(cuda_device, case):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_operands(case, torch.bfloat16, cuda_device)
    causal, window, kv_len = case[5:]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)
                       ).to(cuda_device, torch.bfloat16)
    grads = []
    for fn in (kflash.flash_attention, flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=causal, window=window, kv_len=kv_len
           ).backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    scales = [float(w.float().abs().max()) for w in grads[1]]
    if case[3] == 1 or case[6] == 1:
        # S 1 or window 1, one key per row: P = 1 and dS = do.v - D = 0
        # in exact arithmetic, so dq and dk are rounding noise with no
        # scale of their own; they are held to dv's
        scales = [scales[2]] * 3
    for name, got, want, scale in zip("qkv", *grads, scales, strict=True):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - want.float()).abs().max())
        assert err <= FLASH_GRAD_TOL[torch.bfloat16] * scale, (name, err,
                                                               scale)


@pytest.mark.cuda
def test_flash_bf16_backward_is_bit_reproducible(cuda_device):
    """The training shape (group 10 split over blocks, float32 partials
    summed in a fixed order): two runs give bit-equal dq, dk and dv."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    case = (1, 10, 1, 2048, 256, True, None, None)
    q, k, v = _flash_operands(case, torch.bfloat16, cuda_device)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(7)
                       ).to(cuda_device, torch.bfloat16)
    out, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    assert kflash.launch_geometry(1, 10, 1, 2048).split > 1
    runs = [kflash.flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


# f32 split-TF32 kernels at every tile edge: (B, Hq, Hkv, S, hd, causal,
# window, kv_len), S in {1, 31, 32, 33, 63, 64, 65, 129, 2049} (32-key
# tiles, 64-row blocks, 32-row dk/dv tiles), windows 1, 16, 64, 2048,
# kv_len 0, on a tile edge and off it, groups 1, 2 and 10, hd 64, 80,
# 128, 256 (resident rows), 320 and 512 (two column blocks, streamed)
F32_EDGE_CASES = [(1, 2, 1, 1, 64, True, None, None),
                  (1, 1, 1, 31, 80, True, None, None),
                  (2, 2, 2, 32, 128, True, None, None),
                  (1, 10, 1, 33, 256, True, 16, None),
                  (1, 4, 2, 63, 64, False, None, 32),
                  (1, 2, 1, 64, 320, True, 64, None),
                  (1, 10, 1, 65, 512, False, None, 40),
                  (1, 2, 1, 129, 80, True, 1, None),
                  (1, 4, 2, 100, 128, True, None, 0),
                  (2, 1, 1, 200, 256, True, None, 192),
                  (1, 2, 2, 129, 320, False, 16, 100),
                  (1, 10, 1, 2049, 256, True, 2048, None),
                  (1, 2, 1, 2049, 64, False, None, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_flash_f32_forward_at_tile_edges(cuda_device, case):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_operands(case, torch.float32, cuda_device)
    causal, window, kv_len = case[5:]
    before = kflash.flash_attention.routes.get(kflash.SOURCE.stem, 0)
    got, lse = kflash._forward(q, k, v, (causal, window, q.shape[-1] ** -0.5,
                                         kv_len), with_lse=True)
    torch.cuda.synchronize()
    assert kflash.flash_attention.routes[kflash.SOURCE.stem] == before + 1
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, kv_len=kv_len,
                                         return_lse=True)
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_flash_f32_backward_at_tile_edges(cuda_device, case):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_operands(case, torch.float32, cuda_device)
    causal, window, kv_len = case[5:]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                       ).to(cuda_device)
    grads = []
    for fn in (kflash.flash_attention, flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=causal, window=window, kv_len=kv_len
           ).backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    scales = [float(w.abs().max()) for w in grads[1]]
    if case[3] == 1 or case[6] == 1:
        # one key per row: dq and dk are rounding noise (see the bf16
        # test above), held to dv's scale
        scales = [scales[2]] * 3
    for name, got, want, scale in zip("qkv", *grads, scales, strict=True):
        assert got.dtype == torch.float32
        err = float((got - want).abs().max())
        assert err <= FLASH_GRAD_TOL[torch.float32] * scale, (name, err,
                                                              scale)


@pytest.mark.cuda
def test_flash_f32_backward_is_bit_reproducible(cuda_device):
    """The training shape in float32 (group 10 split over blocks,
    partials summed in a fixed order): two runs give bit-equal dq, dk
    and dv."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    case = (1, 10, 1, 2048, 256, True, None, None)
    q, k, v = _flash_operands(case, torch.float32, cuda_device)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(7)
                       ).to(cuda_device)
    out, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    assert kflash.f32_geometry(1, 10, 1, 2048, 256).split > 1
    runs = [kflash.flash_attention_bwd(q, k, v, out, dout, lse, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0x7FC00000, 0x7F800001,
                                  0xFFFFF001])
def test_flash_f32_forward_keeps_a_nan_operand(cuda_device, bits):
    """A NaN in one query row makes that row NaN and no other, as in the
    plain version, whatever its payload: the split into TF32 halves must
    not round it to a number (0x7fffffff, the NaN the card's arithmetic
    makes, would round to -0)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    case = (1, 2, 1, 65, 80, True, None, None)
    q, k, v = _flash_operands(case, torch.float32, cuda_device)
    q.view(torch.int32)[0, 1, 40, 3] = int(np.uint32(bits).view(np.int32))
    assert torch.isnan(q).sum() == 1
    got = kflash.flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.isnan(want[0, 1, 40]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    finite = ~torch.isnan(want)
    torch.testing.assert_close(got[finite], want[finite],
                               **FLASH_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [320, 512])
def test_flash_bf16_above_256_on_the_f32_kernels(cuda_device, hd):
    """bf16 operands above hd 256 run the f32 kernels on their float32
    values, the result cast back: within bf16's tolerance of the plain
    version, forward and backward."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    case = (1, 4, 2, 129, hd, True, 48, None)
    q, k, v = _flash_operands(case, torch.bfloat16, cuda_device)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                       ).to(cuda_device, torch.bfloat16)
    outs, grads = [], []
    for fn in (kflash.flash_attention, flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True, window=48)
        out.backward(dout)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.bfloat16
    torch.testing.assert_close(outs[0].float(), outs[1].float(),
                               **FLASH_TOL[torch.bfloat16])
    for name, got, want in zip("qkv", *grads, strict=True):
        assert got.dtype == torch.bfloat16
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= FLASH_GRAD_TOL[torch.bfloat16] * scale, (name, err)


@pytest.mark.cuda
def test_each_dtype_reaches_only_its_own_kernel(cuda_device):
    """bf16 operands launch the sm90 sources and never the float32 ones,
    float32 operands the reverse, and bf16 above hd 256 the float32 ones
    (the per-source counters)."""
    from repro_torch.kernels import flash_attention as kflash
    case = (1, 4, 2, 129, 64, True, 40, None)
    sources = {torch.bfloat16: (kflash.SM90_SOURCE.stem,
                                kflash.BWD_SM90_SOURCE.stem),
               torch.float32: (kflash.SOURCE.stem, kflash.BWD_SOURCE.stem)}
    for dtype, (fwd, bwd) in sources.items():
        other = sources[torch.float32 if dtype == torch.bfloat16
                        else torch.bfloat16]
        before = (dict(kflash.flash_attention.routes),
                  dict(kflash.flash_attention_bwd.routes))
        leaves = [t.requires_grad_() for t in
                  _flash_operands(case, dtype, cuda_device)]
        kflash.flash_attention(*leaves, causal=True, window=40).sum().backward()
        torch.cuda.synchronize()
        after = (kflash.flash_attention.routes,
                 kflash.flash_attention_bwd.routes)
        assert after[0].get(fwd, 0) - before[0].get(fwd, 0) == 1
        assert after[1].get(bwd, 0) - before[1].get(bwd, 0) == 3
        assert after[0].get(other[0], 0) == before[0].get(other[0], 0)
        assert after[1].get(other[1], 0) == before[1].get(other[1], 0)
    # bf16 above hd 256 reaches the float32 sources and nothing else
    f32 = sources[torch.float32]
    before = (dict(kflash.flash_attention.routes),
              dict(kflash.flash_attention_bwd.routes))
    leaves = [t.requires_grad_() for t in _flash_operands(
        (1, 4, 2, 129, 320, True, 40, None), torch.bfloat16, cuda_device)]
    kflash.flash_attention(*leaves, causal=True, window=40).sum().backward()
    torch.cuda.synchronize()
    went = [{r: n - was.get(r, 0) for r, n in fn.routes.items()
             if n != was.get(r, 0)}
            for fn, was in zip((kflash.flash_attention,
                                kflash.flash_attention_bwd), before,
                               strict=True)]
    assert went == [{f32[0]: 1}, {f32[1]: 3}]
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 100, 70), (1, 33, 2560), (3, 1, 64),
                                   (1, 2048, 2560), (1, 1000, 2561)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_equals_plain_autograd(cuda_device, shape, dtype):
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    g = torch.Generator().manual_seed(shape[1] + 1)
    a = torch.rand(shape, generator=g).mul(0.2).add(0.8).to(cuda_device, dtype)
    u = torch.randn(shape, generator=g).to(cuda_device, dtype)
    dh = torch.randn(shape, generator=g).to(cuda_device, dtype)
    ta, tu = a.clone().requires_grad_(), u.clone().requires_grad_()
    before = krglru.rglru_scan_bwd.launches
    h = krglru.rglru_scan(ta, tu)
    h.backward(dh)
    torch.cuda.synchronize()
    assert krglru.rglru_scan_bwd.launches == before + 1
    da, du = rglru_scan_bwd_ref(a, h.detach(), dh)
    assert torch.equal(ta.grad, da) and torch.equal(tu.grad, du)  # atol 0
    if dtype == torch.float32:     # and the plain forward's own autograd
        pa, pu = a.clone().requires_grad_(), u.clone().requires_grad_()
        rglru_scan_ref(pa, pu).backward(dh)
        assert torch.equal(ta.grad, pa.grad) and torch.equal(tu.grad, pu.grad)


@pytest.mark.cuda
def test_train_steps_on_cuda_match_cpu(cuda_device):
    """recurrentgemma-2b reduced to one triple and two tails, float32,
    96-token sequences (windowed attention), remat on: 3 TrainLoop steps
    on the card (both forward kernels, both backward kernels, fused
    AdamW) against the same loop on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import rglru as krglru
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.utils.trees import flat_buffer_of, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype="float32", remat=True)
    p0 = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    ds = SyntheticLMDataset(cfg.vocab_size, 96, seed=0)
    counters = (kflash.flash_attention, kflash.flash_attention_bwd,
                krglru.rglru_scan, krglru.rglru_scan_bwd, kadamw.fused_adamw)
    out = {}
    for dev in ("cpu", "cuda"):
        loop = TrainLoop(get_model(cfg), adamw(3e-3),
                         lambda s: ds.batch(2, s),
                         TrainLoopConfig(total_steps=3, log_every=1),
                         seed=0, device=dev)
        loop.params = tree_map(lambda x: x.to(dev), p0)   # the same start
        loop.opt_state = loop.optimizer.init(loop.params)
        before = [c.launches for c in counters]
        res = loop.run()
        torch.cuda.synchronize()
        launched = [c.launches - b for c, b in zip(counters, before)]
        # per step: flash fwd 1 + 1 recompute, bwd 3 launches; RG-LRU fwd
        # 4 + 4 recompute, adjoint 4; one AdamW launch
        assert launched == ([6, 9, 24, 12, 3] if dev == "cuda" else [0] * 5)
        out[dev] = ([m["loss"] for m in res["metrics_log"]],
                    flat_buffer_of(loop.params).cpu())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    # Adam steps a weight whose gradient is within rounding of 0 by +-lr
    # (tests/test_torch_train.py): bounded by 2 lr a step
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 6 * 3e-3


# ---------------------------------------------------------------------------
# the online track and the calibrated cost model on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_calibrated_model_on_cuda_never_reaches_the_kernel(cuda_device):
    from repro_torch.core.cost_model import CalibratedCostModel
    h, cm, ps = _operands(SHAPES[1], 40, 3.0, cuda_device)
    terms = dict(payload_scale=0.1, level_link=(0.002, 0.003),
                 train_scale=2.0)
    cal = CalibratedCostModel(h, cm.clients, memory_penalty=3.0,
                              device=cuda_device, **terms)
    host = CalibratedCostModel(h, cm.clients, memory_penalty=3.0,
                               device="cpu", **terms)
    before = batch_tpd_cuda.launches
    got = cal.batch_tpd(ps)        # auto: numpy, P * C under the threshold
    got_t = cal.batch_tpd(ps, backend="torch")
    torch.cuda.synchronize()
    assert batch_tpd_cuda.launches == before
    assert ps.shape[0] * h.total_clients <= cal._NP_FASTPATH_ELEMS
    assert getattr(cal, "_batch_tpd_np", None) is not None
    assert np.array_equal(got, host.batch_tpd(ps, backend="np"))
    assert np.array_equal(got_t, host.batch_tpd(ps, backend="torch"))
    scalar = [cal.tpd(p) for p in ps]
    np.testing.assert_allclose(got, scalar, rtol=2e-5)
    np.testing.assert_allclose(got_t, scalar, rtol=2e-5)
    with pytest.raises(ValueError, match="trace-calibrated"):
        cal.batch_tpd(ps, backend="kernel")
    neutral = CalibratedCostModel(h, cm.clients, memory_penalty=3.0,
                                  device=cuda_device)
    assert np.array_equal(neutral.batch_tpd(ps), cm.batch_tpd(ps))
    assert batch_tpd_cuda.launches == before + 2   # neutral: the kernel


def _kept(spec, envs):
    import dataclasses
    base = type(spec)

    class Kept(base):
        def make_environment(self, seed=0, eval_config=None, **kw):
            env = base.make_environment(self, seed, eval_config, **kw)
            envs.append(env)
            return env

    return Kept(**{f.name: getattr(spec, f.name)
                   for f in dataclasses.fields(spec)})


@pytest.mark.cuda
def test_online_sync_on_cuda_is_the_emulated_track(cuda_device):
    from repro_torch.utils.trees import tree_leaves
    envs, runs = [], []
    for name in ("online-sync", "paper-fig4"):
        spec = get_scenario(name).with_overrides(model="mlp-smoke")
        runs.append(run_single(_kept(spec, envs), "pso", seed=0, rounds=4,
                               device="cuda"))
    assert runs[0].tpds == runs[1].tpds
    assert runs[0].metrics["loss"] == runs[1].metrics["loss"]
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(envs[0].orchestrator.params),
        tree_leaves(envs[1].orchestrator.params), strict=True))


@pytest.mark.cuda
def test_online_resume_on_cuda_puts_the_store_back_on_the_card(
        cuda_device, tmp_path, monkeypatch):
    import json
    spec = get_scenario("chaos").with_overrides(model="mlp-smoke")
    full = run_single(spec, "pso", seed=0, rounds=6, device="cuda")
    cpu = run_single(spec, "pso", seed=0, rounds=6, device="cpu")
    assert full.tpds == cpu.tpds and full.event_log == cpu.event_log
    run_single(spec, "pso", seed=0, rounds=3, device="cuda",
               checkpoint_dir=str(tmp_path))
    from repro_torch.experiments.environments import OnlineEnvironment
    from repro_torch.utils.trees import tree_leaves
    restored = []
    restore = OnlineEnvironment.restore_state

    def spy(self, state, store):
        restored.extend(x.device.type for tree in store.values()
                        for x in tree_leaves(tree))
        return restore(self, state, store)

    monkeypatch.setattr(OnlineEnvironment, "restore_state", spy)
    resumed = run_single(spec, "pso", seed=0, rounds=6, device="cuda",
                         checkpoint_dir=str(tmp_path), resume=True)
    assert json.dumps(resumed.to_dict(), sort_keys=True) == \
        json.dumps(full.to_dict(), sort_keys=True)
    assert restored and set(restored) == {"cuda"}


@pytest.mark.cuda
def test_calibration_trace_on_cuda_equals_cpu(cuda_device):
    from repro_torch.calibration import fit_calibration, record_trace
    spec = get_scenario("paper-fig4").with_overrides(
        model="mlp-smoke", local_steps=1, batch_size=16)
    a = record_trace(spec, "pso", seed=0, rounds=3, device="cuda")
    b = record_trace(spec, "pso", seed=0, rounds=3, device="cpu")
    assert a.to_json() == b.to_json()
    assert fit_calibration(a).to_dict() == fit_calibration(b).to_dict()


# ---- the dense transformer family and federated language models ---------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [("float32", {}),
                                      ("float32", {"n_kv_heads": 2}),
                                      ("bfloat16", {})])
def test_dense_serving_on_cuda_matches_cpu(cuda_device, dtype, kw):
    """stablelm-1.6b reduced: prefill (300 tokens, padded to 512) and two
    decode steps on the card (the flash kernel of the dtype's route)
    against the same params on the CPU (plain versions), logits and
    caches; float32 at 1e-4, bfloat16 at the hybrid tests' 0.05 / 0.15."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("stablelm-1.6b").reduced().replace(dtype=dtype, **kw)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    params_dev = tree_map(lambda x: x.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 302),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=0.05, atol=0.15)
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_dev)):
        before = kflash.flash_attention.launches
        logits, st = model.prefill_fn(p, {"tokens": toks[:, :300].to(dev)})
        steps = []
        for i in (300, 301):
            step, st = model.decode_fn(p, st, {"token": toks[:, i:i + 1]
                                               .to(dev)})
            steps.append(step.cpu())
        launched = kflash.flash_attention.launches - before
        assert launched == (cfg.n_layers if dev == "cuda" else 0)
        assert st["pos"] == 301
        out[dev] = (logits.cpu(), *steps, st["cache"]["k"].cpu())
    for got, want in zip(out["cuda"], out["cpu"], strict=True):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_dense_batched_equals_serial_on_cuda(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, WaveScheduler
    cfg = get_config("stablelm-1.6b").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(3)]
    sched = WaveScheduler(model, params, max_batch=3)
    reqs = [Request(rid=i, tokens=t, max_new_tokens=6)
            for i, t in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    for r in reqs:
        one = WaveScheduler(model, params, max_batch=1)
        alone = Request(rid=r.rid, tokens=r.tokens, max_new_tokens=6)
        one.submit(alone)
        one.run()
        np.testing.assert_array_equal(alone.output, r.output)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stablelm-1.6b", "recurrentgemma-2b"])
def test_federated_lm_rounds_on_cuda_match_cpu(cuda_device, name):
    """Reduced LM federated through the batched engine (float32,
    deterministic timing) on the card and on the CPU from the same
    params: placements and TPDs exactly, losses within rtol 1e-4, and
    the flash forward/backward launches the rounds need."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import create_strategy
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_map
    cfg = get_config(name).reduced().replace(dtype="float32")
    runs, counts = {}, {}
    p0 = None
    for dev in ("cpu", "cuda"):
        h = Hierarchy(depth=2, width=2, trainers_per_leaf=1, n_clients=7)
        pool = ClientPool.random(h.total_clients, seed=1)
        orch = FederatedOrchestrator(
            get_model(cfg), h, pool,
            make_federated_dataset(cfg, h.total_clients, 1, 16),
            local_steps=2, batch_size=2, seed=1, timing="deterministic",
            device=dev)
        if p0 is None:
            p0 = orch.params
        orch.set_global(tree_map(lambda x: x.to(dev), p0))
        before = (kflash.flash_attention.launches,
                  kflash.flash_attention_bwd.launches)
        runs[dev] = orch.run(create_strategy("pso", h, seed=1), rounds=3)
        counts[dev] = (kflash.flash_attention.launches - before[0],
                       kflash.flash_attention_bwd.launches - before[1])
    assert [r.placement for r in runs["cuda"].rounds] == \
        [r.placement for r in runs["cpu"].rounds]
    assert runs["cuda"].tpds.tolist() == runs["cpu"].tpds.tolist()
    np.testing.assert_allclose([r.loss for r in runs["cuda"].rounds],
                               [r.loss for r in runs["cpu"].rounds],
                               rtol=1e-4)
    assert counts["cpu"] == (0, 0)
    if name == "stablelm-1.6b":
        assert counts["cuda"][0] > 0 and counts["cuda"][1] > 0


# ---- the moe family --------------------------------------------------------
def _routing_share(x2d_a, x2d_b, router_a, router_b, k):
    """Share of (token, expert) routing choices two devices agree on."""
    from repro_torch.models import moe
    _, _, a = moe.route(x2d_a, router_a, k)
    _, _, b = moe.route(x2d_b, router_b, k)
    a, b = a.cpu().sort(-1).values, b.cpu().sort(-1).values
    return float((a == b).float().mean())


@pytest.mark.cuda
def test_moe_ffn_on_cuda_matches_cpu_and_reruns_bit_equal(cuda_device):
    """One full-width granite-moe layer's ``moe_ffn`` (E 32, top 8, d 1024,
    F 512) on 2 x 256 float32 tokens: at least 99.9% of the routing
    choices equal to the CPU's, at least 99% of the tokens' outputs
    within 1e-4 (a token whose choice flips at a near-tie, or that a
    near-tie moves across an expert's capacity cut, moves by its gate's
    share), reruns on the card bit-equal (the combine is a gather, no
    atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m")
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe(g, cfg.d_model, cfg.moe, torch.float32, "cpu")
    x = torch.randn(2, 256, cfg.d_model, generator=g)
    dev_params = {k: v.to(cuda_device) for k, v in params.items()}
    out, aux = moe.moe_ffn(dev_params, x.to(cuda_device), cfg.moe)
    again, aux2 = moe.moe_ffn(dev_params, x.to(cuda_device), cfg.moe)
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    want, want_aux = moe.moe_ffn(params, x, cfg.moe)
    share = _routing_share(x.reshape(-1, cfg.d_model).to(cuda_device),
                           x.reshape(-1, cfg.d_model), dev_params["router"],
                           params["router"], cfg.moe.top_k)
    assert share >= 0.999
    err = (out.cpu() - want).abs().amax(-1)
    close = err <= 1e-4 + 1e-4 * want.abs().amax(-1)
    assert float(close.float().mean()) >= 0.99
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_moe_decode_with_pad_rows_on_cuda_matches_cpu(cuda_device):
    """Reduced granite-moe, float32: prefill 3 x 40 tokens and four decode
    steps at B = 3 (rows padded to 8, the moe routing the 3 real ones)
    on the card against the CPU: logits within 1e-4, the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m").reduced().replace(
        dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    for dev, p in (("cpu", params),
                   ("cuda", tree_map(lambda x: x.to(cuda_device), params))):
        logits, st = model.prefill_fn(p, {"tokens": toks.to(dev)})
        steps = [logits.cpu()]
        for _ in range(4):
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, st = model.decode_fn(p, st, {"token": tok})
            steps.append(logits.cpu())
        out[dev] = steps
    for got, want in zip(out["cuda"], out["cpu"], strict=True):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_training_gradient_on_cuda_matches_cpu(cuda_device, name):
    """One reduced moe config's loss and gradients (float32, remat on, 2 x
    48 tokens) on the card against the CPU: loss and ``moe_aux`` within
    1e-5, each gradient within 1e-4 of its largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced().replace(dtype="float32", remat=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 49),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        leaves, rebuild = tree_flatten(tree_map(lambda x: x.to(dev), params))
        live = [x.detach().requires_grad_() for x in leaves]
        loss, metrics = model.loss_fn(rebuild(live), {
            "tokens": toks[:, :48].to(dev), "labels": toks[:, 1:].to(dev)})
        grads = torch.autograd.grad(loss, live)
        out[dev] = (float(loss.detach()), float(metrics["moe_aux"].detach()),
                    [g.cpu() for g in grads])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-5)
    for got, want in zip(out["cuda"][2], out["cpu"][2], strict=True):
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got - want).abs().max()) <= 1e-4 * scale + 1e-6


# ---- the xLSTM (ssm) family ------------------------------------------------
@pytest.mark.cuda
def test_xlstm_on_cuda_matches_cpu_and_reruns_bit_equal(cuda_device):
    """Reduced xlstm-1.3b, float32: prefill 2 x 48 tokens (3 chunks of
    16) and four decode steps on the card against the CPU, logits and
    every state within 1e-4; a second card run bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-1.3b").reduced().replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 52),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)

    def run(p, dev):
        logits, st = model.prefill_fn(p, {"tokens": toks[:, :48].to(dev)})
        out = [logits.cpu()] + [x.cpu() for x in tree_leaves(st["states"])]
        for i in range(48, 52):
            logits, st = model.decode_fn(p, st, {"token": toks[:, i:i + 1]
                                                 .to(dev)})
            out.append(logits.cpu())
        return out + [x.cpu() for x in tree_leaves(st["states"])]

    dev_params = tree_map(lambda x: x.to(cuda_device), params)
    got, again = run(dev_params, cuda_device), run(dev_params, cuda_device)
    want = run(params, "cpu")
    for a, b, w in zip(got, again, want, strict=True):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_xlstm_batched_equals_serial_on_cuda(cuda_device):
    """Reduced xlstm-1.3b at its bf16 compute: a wave of 3 and each
    request served alone give the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, WaveScheduler
    cfg = get_config("xlstm-1.3b").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(3)]
    sched = WaveScheduler(model, params, max_batch=3)
    reqs = [Request(rid=i, tokens=t, max_new_tokens=6)
            for i, t in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    for r in reqs:
        one = WaveScheduler(model, params, max_batch=1)
        alone = Request(rid=r.rid, tokens=r.tokens, max_new_tokens=6)
        one.submit(alone)
        one.run()
        np.testing.assert_array_equal(alone.output, r.output)


@pytest.mark.cuda
def test_xlstm_training_gradient_on_cuda_matches_cpu(cuda_device):
    """Reduced xlstm-1.3b's loss and gradients (float32, remat on, 2 x 48
    tokens) on the card against the CPU: the loss within 1e-5, each
    gradient within 1e-4 of its largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-1.3b").reduced().replace(dtype="float32",
                                                      remat=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 49),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        leaves, rebuild = tree_flatten(tree_map(lambda x: x.to(dev), params))
        live = [x.detach().requires_grad_() for x in leaves]
        loss, _ = model.loss_fn(rebuild(live), {
            "tokens": toks[:, :48].to(dev), "labels": toks[:, 1:].to(dev)})
        grads = torch.autograd.grad(loss, live)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for got, want in zip(out["cuda"][1], out["cpu"][1], strict=True):
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got - want).abs().max()) <= 1e-4 * scale + 1e-6


# ---- the vlm and audio families --------------------------------------------
# (B, Hq, Hkv, S, hd): the encoder's bidirectional attention (causal=0)
# at hd 64 (seamless-m4t-large-v2's) and 128, GQA and ragged S
BIDIR_CASES = [(2, 4, 4, 200, 64), (1, 8, 2, 129, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIDIR_CASES)
def test_flash_bidirectional_matches_plain_version(cuda_device, case):
    """bf16 on the sm90 route with ``causal=False``: the forward and the
    backward against the dense plain version and its autograd, counted
    as bidirectional launches; two runs bit-equal."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.ref import flash_attention_ref
    full = case + (False, None, None)
    q, k, v = _flash_operands(full, torch.bfloat16, cuda_device)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                       ).to(cuda_device, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (dict(kflash.flash_attention.modes),
                  dict(kflash.flash_attention_bwd.modes))
        out = kflash.flash_attention(*leaves, causal=False)
        out.backward(dout)
        torch.cuda.synchronize()
        went = [{m: n - b.get(m, 0) for m, n in fn.modes.items()
                 if n != b.get(m, 0)}
                for fn, b in zip((kflash.flash_attention,
                                  kflash.flash_attention_bwd), before)]
        assert went == [{"bidirectional": 1}, {"bidirectional": 3}]
        runs.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_ref(*leaves, causal=False)
    want.backward(dout)
    torch.testing.assert_close(runs[0][0].float(), want.detach().float(),
                               **FLASH_TOL[torch.bfloat16])
    for name, got, w in zip("qkv", runs[0][1:], (t.grad for t in leaves),
                            strict=True):
        scale = float(w.float().abs().max())
        err = float((got.float() - w.float()).abs().max())
        assert err <= FLASH_GRAD_TOL[torch.bfloat16] * scale, (name, err,
                                                               scale)


def _mm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (b, s + 1)), dtype=torch.int32),
            "frontend": torch.as_tensor(rng.normal(
                scale=0.02, size=(b, cfg.frontend_len, cfg.frontend_dim)),
                dtype=torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_vlm_and_audio_on_cuda_match_cpu(cuda_device, name):
    """Reduced, float32: prefill (40 text tokens behind the stub frontend)
    and two decode steps on the card (the f32 flash route: causal, and
    the encoder's bidirectional) against the CPU within 1e-4; a second
    card run bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced().replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _mm_batch(cfg, 2, 42, 1)

    def run(p, dev):
        logits, st = model.prefill_fn(p, {
            "tokens": batch["tokens"][:, :40].to(dev),
            "frontend": batch["frontend"].to(dev)})
        out = [logits.cpu()]
        for i in (40, 41):
            logits, st = model.decode_fn(p, st, {
                "token": batch["tokens"][:, i:i + 1].to(dev)})
            out.append(logits.cpu())
        return out

    dev_params = tree_map(lambda x: x.to(cuda_device), params)
    kflash.flash_attention.modes.clear()
    got = run(dev_params, cuda_device)
    bidir = cfg.n_encoder_layers
    assert kflash.flash_attention.modes == (
        {"causal": cfg.n_layers, "bidirectional": bidir} if bidir
        else {"causal": cfg.n_layers})
    again = run(dev_params, cuda_device)
    want = run(params, "cpu")
    for a, b, w in zip(got, again, want, strict=True):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_vlm_and_audio_batched_equals_serial_on_cuda(cuda_device, name):
    """Reduced, at the config's bf16 compute: a wave of 3 behind one stub
    frontend and each request served alone give the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, WaveScheduler
    cfg = get_config(name).reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(5)
    front = rng.normal(scale=0.02, size=(cfg.frontend_len, cfg.frontend_dim))
    prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
               for _ in range(3)]
    sched = WaveScheduler(model, params, max_batch=3, frontend=front)
    reqs = [Request(rid=i, tokens=t, max_new_tokens=6)
            for i, t in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    for r in reqs:
        one = WaveScheduler(model, params, max_batch=1, frontend=front)
        alone = Request(rid=r.rid, tokens=r.tokens, max_new_tokens=6)
        one.submit(alone)
        one.run()
        np.testing.assert_array_equal(alone.output, r.output)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_vlm_and_audio_training_gradient_on_cuda_matches_cpu(cuda_device,
                                                            name):
    """Reduced, float32, remat on, 2 x 48 text tokens behind the stub
    frontend: the loss within 1e-5 and each gradient within 1e-4 of its
    largest value (the encoder's through the bidirectional backward)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced().replace(dtype="float32", remat=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _mm_batch(cfg, 2, 48, 2)
    out = {}
    for dev in ("cpu", "cuda"):
        leaves, rebuild = tree_flatten(tree_map(lambda x: x.to(dev), params))
        live = [x.detach().requires_grad_() for x in leaves]
        loss, _ = model.loss_fn(rebuild(live), {
            "tokens": batch["tokens"][:, :48].to(dev),
            "labels": batch["tokens"][:, 1:].to(dev),
            "frontend": batch["frontend"].to(dev)})
        grads = torch.autograd.grad(loss, live)
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for got, want in zip(out["cuda"][1], out["cpu"][1], strict=True):
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got - want).abs().max()) <= 1e-4 * scale + 1e-6


@pytest.mark.cuda
def test_model_axis_prefill_on_cuda_matches_unsharded(cuda_device):
    """A (1, 2) model axis of two gloo ranks on the one card: reduced
    granite-8b's bf16 prefill from the seeded init, each rank launching
    the sm90 flash kernel on its own 2 q and 2 kv heads, held to the
    unsharded prefill of the same init within 6e-2 (bf16: the ranks sum
    the row-parallel partials in float32, one rounding where the
    unsharded product rounds each; 4e-2 on the CPU)."""
    import sys
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    sys.path.insert(0, str(Path(__file__).parent))
    import _torch_world

    cfg = get_config("granite-8b").reduced()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)
    model = get_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    kflash.flash_attention.heads.clear()
    with torch.no_grad():
        want, _ = model.prefill_fn(params, {
            "tokens": torch.tensor(prompt, device=cuda_device)})
    assert kflash.flash_attention.heads == {"4x4": cfg.n_layers}
    ranks = run_world(_torch_world.tp_card_prefill, 2, (cfg, prompt),
                      timeout=300)
    for r in ranks:
        assert r["heads"] == {"2x2": cfg.n_layers}
        assert r["cache"] == (cfg.n_layers, 4, 40 + 64, 2, 64)
        np.testing.assert_allclose(r["logits"], want.float().cpu().numpy(),
                                   atol=6e-2, rtol=0)


@pytest.mark.cuda
def test_fsdp_adamw_step_on_cuda_matches_unsharded(cuda_device):
    """A (2, 2) data x model mesh of four gloo ranks on the one card,
    fsdp over the data axis (``make_policy(mesh, fsdp=True,
    seq_shard=True)``): reduced granite-8b at float32 compute, one
    ``make_train_step`` step of ``adamw(1e-3)`` on a batch of 4 (2 rows
    a data rank) from the seeded init, each rank launching the fused
    AdamW kernel once on its shard, held to the unsharded step on the
    card: loss within rtol 1e-5, each leaf's update within 1e-3 relative
    L2 (AdamW's first update is about lr * sign(g), so a gradient near
    0 moves it by up to 2 lr; 1.2e-4 on the CPU)."""
    import sys
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.core.state import params_to_numpy
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    from repro_torch.models.api import flat_params, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.utils.trees import tree_leaves
    sys.path.insert(0, str(Path(__file__).parent))
    import _torch_world

    cfg = get_config("granite-8b").reduced().replace(dtype="float32")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = get_model(cfg)
    init = flat_params(model.init(torch.Generator("cuda").manual_seed(0),
                                  "cuda"))
    before = params_to_numpy(init)
    opt = adamw(1e-3)
    params, _, metrics = make_train_step(model, opt)(
        init, opt.init(init),
        {k: torch.tensor(v, device=cuda_device) for k, v in batch.items()})
    want = params_to_numpy(params)
    ranks = run_world(_torch_world.fsdp_card_step, 4, (cfg, batch),
                      timeout=300)
    np.testing.assert_allclose(ranks[0]["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    for r in ranks:
        assert r["adamw"] == 1
    for a, b, p in zip(tree_leaves(ranks[0]["params"]), tree_leaves(want),
                       tree_leaves(before), strict=True):
        assert np.linalg.norm((a - p) - (b - p)) <= 1e-3 * np.linalg.norm(
            b - p)
