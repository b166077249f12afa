"""The port's optimizers, schedules, fused AdamW and LM data stream
against the reference's, on the CPU.

The reference side runs as its own tests run it: ``repro.optim`` (pure
jnp), ``repro.kernels.ref.fused_adamw_ref`` and the Pallas kernel
``fused_adamw_pallas`` in interpret mode. The port side runs the plain
torch version, which the kernel wrapper hands every CPU tensor to (the
CUDA kernel runs on the card only: tests/test_torch_cuda.py).

Tolerances. The port's fused AdamW does the reference oracle's float32
arithmetic in the same order; XLA's CPU code is still one float32 ulp
off on a few elements in 10^5 (rtol 2.4e-7). The
Pallas kernel forms (1 - b2) g g as ((1 - b2) g) g, the oracle as
(1 - b2) (g g), and XLA may fuse its multiply-adds: a few roundings
apart, rtol 1e-6 with atol 1e-9 (m and v are ~1e-3 and ~1e-5 here, and
an ulp of a sum that cancels is ~1e-10); a bfloat16 p one bf16 ulp
(rtol 2^-7). The schedules agree
within one float32 ulp (rtol 3e-7): numpy's cos and pow against
XLA's. ``adamw`` and ``sgd`` over several steps agree within rtol 1e-6,
atol 1e-8 (the global norm is summed in another order, which moves the
clipping scale by an ulp; the bias corrections use numpy's pow).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLMDataset as RefLMDataset
from repro.data.synthetic import _doc_seed as ref_doc_seed
from repro.kernels import ref as jref
from repro.kernels.fused_adamw import fused_adamw_pallas
from repro.optim import adamw as ref_adamw
from repro.optim import schedules as ref_schedules
from repro.optim import sgd as ref_sgd
from repro.utils.trees import tree_global_norm as ref_global_norm
from repro_torch.data.synthetic import SyntheticLMDataset, _doc_seed
from repro_torch.kernels import fused_adamw as kadamw
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_adamw_ref
from repro_torch.optim import adamw, clip_by_global_norm, schedules, sgd
from repro_torch.utils.trees import flat_buffer_of, tree_global_norm, tree_leaves

ULP = dict(rtol=3e-7, atol=0)
ORACLE = dict(rtol=2.4e-7, atol=1e-12)
PALLAS = dict(rtol=1e-6, atol=1e-9)
BF16_ULP = dict(rtol=2.0 ** -7, atol=0)
STEPS = dict(rtol=1e-6, atol=1e-8)
_DATA_STREAM = 11


def _adamw_operands(n, dtype, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    if dtype == "bfloat16":       # both sides see the same bf16 values
        p = np.asarray(jnp.asarray(p, jnp.bfloat16), np.float32)
        g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-5).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 4097, 70001])
@pytest.mark.parametrize("step", [1, 1000])
def test_fused_adamw_plain_version_matches_oracle_and_pallas(dtype, n, step):
    p, g, m, v = _adamw_operands(n, dtype, seed=n + step)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    lr = np.float32(3e-4)
    bc1 = np.float32(1) - np.float32(0.9) ** np.float32(step)
    bc2 = np.float32(1) - np.float32(0.95) ** np.float32(step)
    jargs = (jnp.asarray(p, jdt), jnp.asarray(g, jdt), jnp.asarray(m),
             jnp.asarray(v))
    oracle = jref.fused_adamw_ref(*jargs, lr, bc1, bc2)
    pallas = fused_adamw_pallas(*jargs, lr, bc1, bc2, interpret=True)
    got = fused_adamw_ref(torch.tensor(p).to(tdt), torch.tensor(g).to(tdt),
                          torch.tensor(m), torch.tensor(v), lr, bc1, bc2)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for name, x, y, z in zip("pmv", got, oracle, pallas, strict=True):
        x = x.float().numpy()
        np.testing.assert_allclose(x, np.asarray(y, np.float32), **ORACLE,
                                   err_msg=name)
        tol = BF16_ULP if (name == "p" and dtype == "bfloat16") else PALLAS
        np.testing.assert_allclose(x, np.asarray(z, np.float32), **tol,
                                   err_msg=name)


def test_fused_adamw_wrapper_updates_in_place_on_the_cpu():
    p, g, m, v = (torch.tensor(x) for x in _adamw_operands(4099, "float32",
                                                           seed=5))
    want = fused_adamw_ref(p, g, m, v, 1e-3, 0.1, 0.05)
    ptrs = [t.data_ptr() for t in (p, m, v)]
    before = kadamw.fused_adamw.launches
    got = ops.fused_adamw(p, g, m, v, 1e-3, 0.1, 0.05)
    assert kadamw.fused_adamw.launches == before       # a CPU tensor
    assert [t.data_ptr() for t in got] == ptrs
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adamw_cpu_chunks_equal_one_pass(dtype, monkeypatch):
    """The CPU path's chunks (a ragged last one too) change no bit."""
    monkeypatch.setattr(kadamw, "CPU_CHUNK", 1000)
    p, g, m, v = (torch.tensor(x) for x in _adamw_operands(4099, dtype,
                                                           seed=7))
    if dtype == "bfloat16":
        p, g = p.bfloat16(), g.bfloat16()
    want = fused_adamw_ref(p, g, m, v, 1e-3, 0.1, 0.05)
    got = ops.fused_adamw(p, g, m, v, 1e-3, 0.1, 0.05)
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad,err,match", [
    (dict(g=torch.zeros(8, dtype=torch.bfloat16)), TypeError, "g is"),
    (dict(m=torch.zeros(8, dtype=torch.bfloat16)), TypeError, "float32"),
    (dict(p=torch.zeros(8, dtype=torch.float16),
          g=torch.zeros(8, dtype=torch.float16)), TypeError, "bfloat16"),
    (dict(v=torch.zeros(9)), ValueError, "one"),
    (dict(p=torch.zeros((2, 4)), g=torch.zeros((2, 4)), m=torch.zeros((2, 4)),
          v=torch.zeros((2, 4))), ValueError, "one"),
    (dict(p=torch.zeros(16)[::2]), ValueError, "contiguous"),
])
def test_fused_adamw_wrapper_rejects_malformed_operands(bad, err, match):
    args = dict(p=torch.zeros(8), g=torch.zeros(8), m=torch.zeros(8),
                v=torch.zeros(8))
    args.update(bad)
    with pytest.raises(err, match=match):
        ops.fused_adamw(args["p"], args["g"], args["m"], args["v"], 1e-3,
                        0.1, 0.05)


SCHEDULES = [("constant_schedule", (3e-4,)),
             ("linear_schedule", (1e-3, 1e-5, 37)),
             ("cosine_schedule", (3e-4, 50, 1e-5)),
             ("warmup_cosine_schedule", (3e-4, 2, 8)),
             ("warmup_cosine_schedule", (1e-3, 10, 100, 1e-4))]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{n}{a}" for n, a in SCHEDULES])
def test_schedules_match_reference(name, args):
    ref = getattr(ref_schedules, name)(*args)
    port = getattr(schedules, name)(*args)
    for step in range(120):
        got = port(step)
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, np.asarray(ref(jnp.int32(step))),
                                   **ULP, err_msg=f"step {step}")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": [rng.standard_normal(13).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)]}


def _to_torch(tree):
    return jax.tree.map(torch.tensor, tree)


OPTIMIZERS = [
    ("adamw", lambda c: adamw(schedules.warmup_cosine_schedule(1e-2, 2, 8),
                              grad_clip=c),
     lambda c: ref_adamw(ref_schedules.warmup_cosine_schedule(1e-2, 2, 8),
                         grad_clip=c)),
    ("adamw-no-decay", lambda c: adamw(3e-3, weight_decay=0.0, grad_clip=c),
     lambda c: ref_adamw(3e-3, weight_decay=0.0, grad_clip=c)),
    ("sgd", lambda c: sgd(0.1, grad_clip=c), lambda c: ref_sgd(0.1, grad_clip=c)),
    ("sgd-momentum", lambda c: sgd(0.1, 0.9, grad_clip=c),
     lambda c: ref_sgd(0.1, 0.9, grad_clip=c)),
]


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("name,make,make_ref", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_steps_match_reference(name, make, make_ref, clip):
    opt, ref_opt = make(clip), make_ref(clip)
    params = _tree(1)
    tp, jp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    ts, js = opt.init(tp), ref_opt.init(jp)
    rng = np.random.default_rng(_DATA_STREAM)
    for _ in range(6):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        tp, ts = opt.update(tp, _to_torch(grads), ts)
        jp, js = ref_opt.update(jp, jax.tree.map(jnp.asarray, grads), js)
    assert int(ts.step) == int(js.step) == 6
    for x, y in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **STEPS)
    if name.startswith("adamw"):
        for x, y in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                        jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu),
                        strict=True):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **STEPS)


def test_adamw_state_is_flat_and_updates_flat_params_in_place():
    opt = adamw(1e-2)
    from repro_torch.models.api import flat_params
    params = flat_params(_to_torch(_tree(2)))
    flat = flat_buffer_of(params)
    state = opt.init(params)
    m, v = flat_buffer_of(state.mu), flat_buffer_of(state.nu)
    assert flat is not None and m is not None and v is not None
    before = flat.clone()
    grads = _to_torch(_tree(3))
    new_params, new_state = opt.update(params, grads, state)
    assert flat_buffer_of(new_params).data_ptr() == flat.data_ptr()
    assert flat_buffer_of(new_state.mu).data_ptr() == m.data_ptr()
    assert not torch.equal(flat, before)              # updated in place
    assert all(x is y for x, y in zip(tree_leaves(new_params),
                                      tree_leaves(params), strict=True))


def test_sgd_updates_flat_params_in_place():
    """Momentum-free SGD writes params that view one flat buffer in
    place (a federated rank keeps one copy of its model), with the same
    values as the new-tensor update of any other tree."""
    from repro_torch.models.api import flat_params
    params = flat_params(_to_torch(_tree(2)))
    flat = flat_buffer_of(params)
    grads = _to_torch(_tree(3))
    want, _ = sgd(0.1).update(_to_torch(_tree(2)), grads,
                              sgd(0.1).init(None))
    new_params, state = sgd(0.1).update(params, grads, sgd(0.1).init(None))
    assert int(state.step) == 1
    assert all(x is y for x, y in zip(tree_leaves(new_params),
                                      tree_leaves(params), strict=True))
    assert flat_buffer_of(new_params).data_ptr() == flat.data_ptr()
    for x, y in zip(tree_leaves(new_params), tree_leaves(want), strict=True):
        assert torch.equal(x, y)


def test_global_norm_and_clipping_match_reference():
    tree = _tree(4)
    got = tree_global_norm(_to_torch(tree))
    want = ref_global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    clipped, norm = clip_by_global_norm(_to_torch(tree), 1.0)
    np.testing.assert_allclose(float(tree_global_norm(clipped)), 1.0,
                               rtol=1e-6)
    assert float(norm) == float(got)


@pytest.mark.parametrize("vocab,seq,batch", [(512, 96, 2), (256000, 64, 3)])
def test_lm_dataset_bit_for_bit(vocab, seq, batch):
    ref, port = RefLMDataset(vocab, seq, seed=7), SyntheticLMDataset(
        vocab, seq, seed=7)
    for step in (0, 1, 41):
        a, b = ref.batch(batch, step), port.batch(batch, step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it_a, it_b = ref.batches(batch), port.batches(batch)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_a)["tokens"],
                                      next(it_b)["tokens"])


def test_doc_seed_matches_reference():
    for parts in [(0,), (7, "eval"), (3, 0xE7A1, "client", 12)]:
        assert _doc_seed(*parts) == ref_doc_seed(*parts)
