"""The port's RG-LRU scan against the reference's, on the CPU.

The reference side runs as its own tests run it: the Pallas kernel
``rglru_scan_pallas`` in interpret mode (a log-depth composition inside
each time tile), its sequential oracle ``repro.kernels.ref.rglru_scan_ref``
(with ``h0``), ``repro.kernels.ops.rglru_scan`` (which pads T and D) and
the model's own scan, ``repro.models.rglru.rglru_scan``, which uses
``jax.lax.associative_scan``. The port side runs its plain torch
version, the sequential recurrence the kernel wrapper hands every CPU
tensor to (the CUDA kernel, which equals it bit for bit, runs on the
card only: tests/test_torch_cuda.py).

Tolerances: against the sequential oracle the arithmetic is the same
step for step, so float32 is held at rtol 1e-6 (XLA may still contract
a multiply-add); against the log-depth scans rtol = atol = 1e-5, the
reference's own (tests/test_kernels.py); bfloat16 outputs at 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.rglru import rglru_scan_pallas
from repro.models import rglru as ref_rglru
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels.ref import rglru_scan_ref
from repro_torch.models import rglru as port_rglru

SEQ = dict(rtol=1e-6, atol=1e-6)
SCAN = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _au(b, t, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 1.0, (b, t, d)).astype(np.float32)
    u = rng.standard_normal((b, t, d)).astype(np.float32)
    return a, u


@pytest.mark.parametrize("b,t,d,bt,bd", [(2, 64, 128, 16, 64),
                                         (1, 256, 256, 256, 256),
                                         (3, 32, 8, 8, 8)])
def test_plain_version_matches_pallas_and_oracle(b, t, d, bt, bd):
    a, u = _au(b, t, d, seed=t + d)
    want = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(u), block_t=bt,
                             block_d=bd, interpret=True)
    oracle = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(u))
    got = rglru_scan_ref(torch.tensor(a), torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **SEQ)


def test_h0_matches_oracle():
    a, u = _au(2, 40, 24, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 24)).astype(np.float32)
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(u),
                               jnp.asarray(h0))
    got = rglru_scan_ref(torch.tensor(a), torch.tensor(u), torch.tensor(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SEQ)
    # the carry folded into the first input, as the kernel's callers do
    u_fold = u.copy()
    u_fold[:, 0] += a[:, 0] * h0
    assert torch.equal(got, rglru_scan_ref(torch.tensor(a),
                                           torch.tensor(u_fold)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(300, 200), (17, 5)])
def test_ops_ragged_matches_reference_ops(dtype, t, d):
    """Ragged T and D: the reference pads to its tiles, the port's kernel
    masks its own edge."""
    a, u = _au(2, t, d, seed=t)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja, ju = jnp.asarray(a, jdt), jnp.asarray(u, jdt)
    want = ref_ops.rglru_scan(ja, ju, use_pallas=True, interpret=True)
    got = ops.rglru_scan(torch.tensor(np.asarray(ja, np.float32)).to(tdt),
                         torch.tensor(np.asarray(ju, np.float32)).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, t, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16 if dtype == "bfloat16" else SCAN))


def _block(seed, d=32):
    """One recurrent block's gate params, the same on both sides."""
    rng = np.random.default_rng(seed)
    np_block = {
        "w_a": rng.standard_normal((d, d)).astype(np.float32) * 0.1,
        "b_a": rng.standard_normal(d).astype(np.float32) * 0.1,
        "w_x": rng.standard_normal((d, d)).astype(np.float32) * 0.1,
        "b_x": rng.standard_normal(d).astype(np.float32) * 0.1,
        "lam": np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, d))
                               / 8.0)).astype(np.float32),
    }
    return ({k: jnp.asarray(v) for k, v in np_block.items()},
            {k: torch.tensor(v) for k, v in np_block.items()})


@pytest.mark.parametrize("with_h0", [False, True])
def test_model_scan_matches_associative_scan(with_h0):
    """``models.rglru.rglru_scan`` (torch gates + the scan kernel's plain
    version) against the reference model's associative scan."""
    jb, tb = _block(7)
    rng = np.random.default_rng(8)
    xr = rng.standard_normal((2, 50, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 32)).astype(np.float32) if with_h0 else None
    want = ref_rglru.rglru_scan(jb, jnp.asarray(xr),
                                None if h0 is None else jnp.asarray(h0))
    before = krglru.rglru_scan.launches
    got = port_rglru.rglru_scan(tb, torch.tensor(xr),
                                None if h0 is None else torch.tensor(h0))
    assert krglru.rglru_scan.launches == before   # a CPU tensor: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    # one decode step continues the scan
    x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    y_j, h_j = ref_rglru.rglru_step(jb, jnp.asarray(x1),
                                    jnp.asarray(np.asarray(want)[:, -1]))
    y_t, h_t = port_rglru.rglru_step(tb, torch.tensor(x1), got[:, -1])
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **SCAN)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **SCAN)


def test_conv1d_matches_reference():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jblock = {"conv_w": jnp.asarray(w), "conv_b": jnp.asarray(bias)}
    tblock = {"conv_w": torch.tensor(w), "conv_b": torch.tensor(bias)}
    for state in (None, st):
        want, want_st = ref_rglru._conv1d(
            jblock, jnp.asarray(x), None if state is None else jnp.asarray(state))
        got, got_st = port_rglru._conv1d(
            tblock, torch.tensor(x), None if state is None else torch.tensor(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SEQ)
        np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, u = _au(2, 33, 7, seed=1)
    before = krglru.rglru_scan.launches
    got = krglru.rglru_scan(torch.tensor(a), torch.tensor(u))
    assert torch.equal(got, rglru_scan_ref(torch.tensor(a), torch.tensor(u)))
    assert krglru.rglru_scan.launches == before
    empty = krglru.rglru_scan(torch.zeros((2, 0, 7)), torch.zeros((2, 0, 7)))
    assert tuple(empty.shape) == (2, 0, 7)


@pytest.mark.parametrize("a,u,err,match", [
    (torch.zeros((2, 3, 4)), torch.zeros((2, 3, 5)), ValueError, "(B, T, D)"),
    (torch.zeros((2, 3)), torch.zeros((2, 3)), ValueError, "(B, T, D)"),
    (torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4), dtype=torch.bfloat16),
     TypeError, "both be float32"),
    (torch.zeros((2, 3, 4), dtype=torch.float16),
     torch.zeros((2, 3, 4), dtype=torch.float16), TypeError, "both be float32"),
    (torch.zeros((2, 4, 3)).transpose(1, 2), torch.zeros((2, 3, 4)),
     ValueError, "contiguous"),
])
def test_wrapper_rejects_malformed_operands(a, u, err, match):
    with pytest.raises(err, match=match):
        krglru.rglru_scan(a, u)


# ---- the adjoint ------------------------------------------------------------
@pytest.mark.parametrize("b,t,d", [(2, 64, 24), (1, 33, 7), (3, 1, 5)])
def test_backward_matches_jax_grad_of_reference(b, t, d):
    """The plain adjoint (``rglru_scan_bwd_ref``, what the autograd
    Function runs on CPU tensors) against jax.grad of the reference's
    sequential oracle, float32 within rtol = atol = 1e-5: the same
    recurrence, but XLA's transposed scan forms da from its own carry
    (gradients of size ~10 here, a few ulp apart)."""
    a, u = _au(b, t, d, seed=t * d)
    g = np.random.default_rng(t).standard_normal((b, t, d)).astype(np.float32)
    want = jax.grad(lambda a_, u_: jnp.sum(jref.rglru_scan_ref(a_, u_) * g),
                    argnums=(0, 1))(jnp.asarray(a), jnp.asarray(u))
    ta = torch.tensor(a, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    before = (krglru.rglru_scan.launches, krglru.rglru_scan_bwd.launches)
    (krglru.rglru_scan(ta, tu) * torch.tensor(g)).sum().backward()
    assert (krglru.rglru_scan.launches,
            krglru.rglru_scan_bwd.launches) == before   # CPU: no launch
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want[0]), **SCAN)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(want[1]), **SCAN)
    # and bit for bit the autograd of the plain forward
    a2 = torch.tensor(a, requires_grad=True)
    u2 = torch.tensor(u, requires_grad=True)
    (rglru_scan_ref(a2, u2) * torch.tensor(g)).sum().backward()
    assert torch.equal(ta.grad, a2.grad) and torch.equal(tu.grad, u2.grad)


def test_model_scan_gradient_with_h0_matches_reference():
    """Gradients through the model's scan (gates, the carry folded into
    the first input) against jax.grad of the reference model's
    associative scan: rtol = atol = 1e-5."""
    jb, tb = _block(12)
    rng = np.random.default_rng(13)
    xr = rng.standard_normal((2, 40, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 32)).astype(np.float32)
    g = rng.standard_normal((2, 40, 32)).astype(np.float32)
    want = jax.grad(lambda blk, x, h: jnp.sum(
        ref_rglru.rglru_scan(blk, x, h) * g), argnums=(0, 1, 2))(
        jb, jnp.asarray(xr), jnp.asarray(h0))
    leaves = {k: v.clone().requires_grad_() for k, v in tb.items()}
    x = torch.tensor(xr, requires_grad=True)
    h = torch.tensor(h0, requires_grad=True)
    (port_rglru.rglru_scan(leaves, x, h) * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want[1]), **SCAN)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want[2]), **SCAN)
    for k in ("w_a", "w_x", "lam"):
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   np.asarray(want[0][k]), **SCAN,
                                   err_msg=k)


@pytest.mark.parametrize("a,h,dh,err,match", [
    (torch.zeros((2, 3, 4)), torch.zeros((2, 3, 5)), torch.zeros((2, 3, 4)),
     ValueError, "(B, T, D)"),
    (torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4)),
     torch.zeros((2, 3, 4), dtype=torch.bfloat16), TypeError, "both be"),
])
def test_backward_wrapper_rejects_malformed_operands(a, h, dh, err, match):
    with pytest.raises(err, match=match):
        krglru.rglru_scan_bwd(a, h, dh)


# ---- the kernel's launch plan (computed on the host, no card) --------------
@pytest.mark.parametrize("d,elem,ptrs,route", [
    (2560, 4, (0, 256), "tma"),            # recurrentgemma-2b, float32
    (2560, 2, (0, 256), "tma"),            # and bfloat16
    (2500, 4, (), "tma"),                  # 10,000-byte rows
    (70, 4, (), "cp_async"),               # 280-byte rows
    (2561, 2, (), "cp_async"),             # 5,122-byte rows
    (2560, 2, (0, 2), "cp_async"),         # a misaligned operand
    (5, 4, (), "cp_async")])
def test_copy_route_follows_the_tensor_map_rules(d, elem, ptrs, route):
    assert krglru.copy_route(d, elem, ptrs) == route


# (b, t, d, element bytes, operands): the training and serving shapes of
# recurrentgemma-2b, both walks, bf16, ragged and small shapes, a grid
# many times the SMs
PLAN_SHAPES = [(1, 2048, 2560, 4, 2), (1, 2048, 2560, 4, 3),
               (4, 4096, 2560, 4, 2), (4, 4096, 2560, 2, 2),
               (1, 2048, 2560, 2, 3), (2, 1031, 2500, 4, 3),
               (3, 777, 2561, 2, 2), (1, 33, 70, 4, 2), (3, 1, 64, 4, 3),
               (64, 4096, 2560, 4, 3)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_keeps_every_block_resident(shape):
    """The ring is 2-8 stages, no deeper than the walk has tiles, fits a
    block's shared memory with every block of the grid resident at once
    on the H100's 132 SMs, and keeps about ``INFLIGHT_PER_SM`` of loads
    in flight an SM (stages - 1 tiles a block) where those bounds allow."""
    b, t, d, elem, ops = shape
    route = krglru.copy_route(d, elem)
    plan = krglru.launch_plan(b, t, d, elem, ops, route)
    tiles = -(-t // krglru.TILE_STEPS)
    assert plan.route == route
    assert plan.blocks == -(-d // krglru.GROUP) * b
    assert krglru.MIN_STAGES <= plan.stages <= krglru.MAX_STAGES
    assert plan.stages <= max(krglru.MIN_STAGES, tiles)
    assert plan.smem_bytes == krglru.ring_bytes(ops, elem, route,
                                                plan.stages)
    assert plan.smem_bytes <= krglru.SMEM_PER_BLOCK
    per_sm = -(-plan.blocks // krglru.H100_SMS)
    stage = krglru.ring_bytes(ops, elem, route, 1) - \
        krglru.ring_bytes(ops, elem, route, 0)
    if plan.stages > krglru.MIN_STAGES:
        assert per_sm * (plan.smem_bytes + krglru.SMEM_RESERVED) \
            <= krglru.SMEM_PER_SM
        assert (plan.stages - 2) * stage * per_sm < krglru.INFLIGHT_PER_SM
    deeper = krglru.ring_bytes(ops, elem, route, plan.stages + 1)
    assert plan.stages == min(krglru.MAX_STAGES, max(krglru.MIN_STAGES,
                                                     tiles)) \
        or plan.stages * stage * per_sm > krglru.INFLIGHT_PER_SM \
        or per_sm * (deeper + krglru.SMEM_RESERVED) > krglru.SMEM_PER_SM \
        or deeper > krglru.SMEM_PER_BLOCK


def test_launch_plan_at_the_training_shape():
    """recurrentgemma-2b training (1, 2048, 2560) f32: 80 blocks of 32
    channels, one a SM; the scan's 16 KB stages (a, u) 4 deep, 3
    loading, the adjoint's 24 KB (a, h, dh) 3 deep; the serving shape
    (4, 4096, 2560): 320 blocks, 3 a SM, 2 stages each."""
    fwd = krglru.launch_plan(1, 2048, 2560, 4, 2, "tma")
    bwd = krglru.launch_plan(1, 2048, 2560, 4, 3, "tma")
    # ring + two staging tiles of each output + the alignment slack
    assert (fwd.blocks, fwd.stages, fwd.smem_bytes) == \
        (80, 4, (4 * 2 + 2) * 8192 + 128)
    assert (bwd.blocks, bwd.stages, bwd.smem_bytes) == \
        (80, 3, (3 * 3 + 4) * 8192 + 128)
    serve = krglru.launch_plan(4, 4096, 2560, 4, 2, "tma")
    assert (serve.blocks, serve.stages) == (320, 2)
    # the cp.async route: 4-byte words and no staging tiles
    assert krglru.ring_bytes(2, 2, "cp_async", 3) == 3 * 2 * 2048 * 4 + 128


# (b, t, d, element bytes, operands, route) -> the ring depth the plan
# picks: the card tests reach depths 2, 3, 4, 5 and 7 through these
# shapes (B 2, D 80: 6 blocks), the model shapes theirs
DEPTH_CASES = [
    ((2, 100, 80, 4, 2, "tma"), 2),         # 2 tiles
    ((2, 150, 80, 4, 2, "tma"), 3),         # 3 tiles
    ((2, 1000, 80, 4, 2, "tma"), 4),        # 16 KB stages: 1 + 48 / 16
    ((2, 1000, 80, 2, 2, "tma"), 7),        # 8 KB stages
    ((2, 1000, 80, 4, 3, "tma"), 3),        # 24 KB stages
    ((2, 1000, 80, 2, 3, "tma"), 5),        # 12 KB stages
    ((2, 1000, 80, 2, 2, "cp_async"), 4),   # 4-byte words: 16 KB stages
    ((2, 1000, 80, 4, 3, "cp_async"), 3),
    ((2, 150, 80, 4, 3, "cp_async"), 3),
    ((1, 2048, 2560, 2, 2, "tma"), 7),      # training, bf16
    ((4, 4096, 2560, 4, 3, "tma"), 2),      # 3 blocks a SM
    ((64, 4096, 2560, 4, 3, "tma"), 2),     # blocks past residency
]


@pytest.mark.parametrize("shape,depth", DEPTH_CASES)
def test_launch_plan_ring_depth_follows_the_shape(shape, depth):
    assert krglru.launch_plan(*shape).stages == depth


@pytest.mark.parametrize("route", ["ldg", "TMA", "cp.async"])
def test_launch_plan_rejects_what_the_kernel_does_not_take(route):
    with pytest.raises(ValueError, match="route"):
        krglru.launch_plan(1, 64, 64, 4, 2, route)
