"""The ssm family (xlstm-1.3b): the port's ``models/xlstm.py`` against the
reference on the CPU.

Both packages run ``xlstm-1.3b`` at ``reduced()`` (2 layers: one mLSTM
block with 4 heads of 128, one sLSTM block with 4 heads of 64; d 256,
chunk 16, vocab 512), with the reference's params carried across by
``params_from_numpy``; inputs come from numpy seeds. Tolerances: the
cells and the float32 models at rtol = atol = 1e-4 (XLA and torch sum
the products in other orders); the bfloat16 models (the config's own
``dtype``) at ``tests/test_torch_transformer.py``'s rtol 0.05, atol 0.15;
the port's chunkwise cell against its own steps at
``tests/test_model_internals.py``'s 5e-4.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.hierarchy import ClientPool as RefClientPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.core.registry import create_strategy as ref_create_strategy
from repro.data.synthetic import make_federated_dataset as ref_make_dataset
from repro.fl.orchestrator import FederatedOrchestrator as RefOrchestrator
from repro.models import get_model as ref_get_model
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data import make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model
from repro_torch.models import xlstm
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils import trees

ARCH = "xlstm-1.3b"
_PARAM_STREAM = 3            # reference init key of the shared params
_TOKEN_STREAM = 0
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
TOL = {"float32": F32, "bfloat16": BF16}
STEPS_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the reduced models' ops are too small
    to gain from more, and spinning thread teams slow many fold when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype, **kw):
    return (ref_get_config(ARCH).reduced().replace(dtype=dtype, **kw),
            get_config(ARCH).reduced().replace(dtype=dtype, **kw))


def _models(dtype, **kw):
    ref_cfg, cfg = _cfgs(dtype, **kw)
    return ref_get_model(ref_cfg), get_model(cfg)


def _ref_params(**kw):
    ref_cfg, _ = _cfgs("float32", **kw)
    np_params = jax.tree.map(np.asarray, ref_get_model(ref_cfg).init(
        jax.random.key(_PARAM_STREAM)))
    return np_params, params_from_numpy(np_params, device="cpu")


@pytest.fixture(scope="session")
def shared_params():
    return _ref_params()


@pytest.fixture(scope="session")
def tokens():
    return np.random.default_rng(_TOKEN_STREAM).integers(
        0, 512, (2, 48)).astype(np.int32)


def _jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _close_tree(got, want, tol, what):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = trees.tree_leaves(got)
    assert len(flat_got) == len(flat_want), what
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(np.shape(w)), (what, path)
        _close(g, w, tol, f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# config, registry, init
# ---------------------------------------------------------------------------
def test_config_is_copied_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(ref_get_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert cfg.family == "ssm" and cfg.citation == "arXiv:2405.04517"
    assert get_model(cfg.reduced()).prefill_fn is not None
    with pytest.raises(NotImplementedError, match="item 12"):
        get_model(cfg, ShardingPolicy(mesh=object(), model_axis="model")
                  ).loss_fn(None, None)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_layout_matches_reference(param_dtype):
    """The reference's tree (the mLSTM and sLSTM blocks stacked under
    ``mlstm`` and ``slstm``), shapes and dtypes; the gate biases and
    norm scales equal to the reference's values (the random leaves
    follow it in distribution only)."""
    ref_cfg, cfg = _cfgs("bfloat16", param_dtype=param_dtype,
                         n_layers=5)
    want = jax.tree.map(np.asarray, ref_get_model(ref_cfg).init(
        jax.random.key(0)))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert got["mlstm"]["wq"].shape[0] == 3 and got["slstm"]["r"].shape[0] == 2
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = trees.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    for block, key in (("mlstm", "b_if"), ("mlstm", "ln"), ("slstm", "b"),
                       ("slstm", "out_norm")):
        want_leaf = jax.tree.leaves(want[block][key])[0]
        got_leaf = trees.tree_leaves(got[block][key])[0]
        assert np.array_equal(got_leaf.float().numpy(),
                              np.asarray(want_leaf, np.float32)), key
    # the scales of the random leaves: w_if 0.01, r 0.02, w_in 1/sqrt(d)
    assert float(got["mlstm"]["w_if"].float().std()) == pytest.approx(
        0.01 * 0.986, rel=0.1)
    assert float(got["slstm"]["r"].float().std()) == pytest.approx(
        0.02 * 0.986, rel=0.05)


def test_init_decode_state_matches_reference():
    ref, port = _models("bfloat16")
    want = ref.init_decode_state(3, 40)
    got = port.init_decode_state(3, 40, "cpu")
    assert got["pos"] == int(want["pos"]) == 39
    _close_tree(got["states"], want["states"], dict(rtol=0, atol=0),
                "zero state")
    assert float(got["states"]["slstm"]["m"].max()) == np.float32(-1e30)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def test_cap_matches_reference():
    x = np.linspace(-80.0, 80.0, 2001, dtype=np.float32)
    _close(xlstm._cap(torch.tensor(x)), ref_xlstm._cap(jnp.asarray(x)),
           dict(rtol=1e-6, atol=1e-5), "cap")
    assert float(xlstm._cap(torch.tensor(1e6))) == pytest.approx(15.0)


def _identity_block(cfg):
    """An mLSTM block whose q projection is exact in any dtype: main = x
    on the first d lanes (w_up an identity), q = main (wq an identity)."""
    d, d_in, h = cfg.d_model, 2 * cfg.d_model, cfg.n_heads
    w_up = np.zeros((d, 2 * d_in), np.float32)
    w_up[:, :d] = np.eye(d)
    rng = np.random.default_rng(4)
    return {"w_up": w_up, "wq": np.eye(d_in, dtype=np.float32),
            "wk": (rng.standard_normal((d_in, d_in)) / 16).astype(np.float32),
            "wv": (rng.standard_normal((d_in, d_in)) / 16).astype(np.float32),
            "w_if": (rng.standard_normal((d_in, 2 * h)) * 0.3).astype(
                np.float32),
            "b_if": np.concatenate([np.zeros(h), np.linspace(3, 6, h)]
                                   ).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_qkvif_matches_reference(dtype):
    """``_mlstm_qkvif`` on (2, 12) tokens: q, k, v in ``dtype``, the gates
    in float32. With exact q projections, q equals the reference's bit
    for bit: the reference divides by sqrt(128) rounded to the dtype
    first (11.3125 in bfloat16), and a division by the float itself
    gives other bits."""
    ref_cfg, cfg = _cfgs(dtype)
    block = _identity_block(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = ref_xlstm._mlstm_qkvif(
        {k: jnp.asarray(v) for k, v in block.items()},
        jnp.asarray(x, jdt), ref_cfg)
    got = xlstm._mlstm_qkvif(_t(block), torch.tensor(x).to(tdt), cfg)
    assert got[0].dtype == tdt and got[3].dtype == torch.float32
    q_want = np.asarray(want[0].astype(jnp.float32))
    assert np.array_equal(got[0].float().numpy(), q_want)
    if dtype == "bfloat16":     # sqrt(128) not rounded first: other bits
        strong = (torch.tensor(x).to(tdt).float() / np.sqrt(128.0)).to(tdt)
        assert not np.array_equal(strong.float().numpy(),
                                  q_want.reshape(2, 12, -1)[..., :cfg.d_model])
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for name, g, w in zip(("q", "k", "v", "li", "lf", "z"), got, want,
                          strict=True):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, np.asarray(w.astype(jnp.float32)), tol, name)


def _cell_inputs(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) * 0.3
               for _ in range(3))
    li = (rng.standard_normal((b, s, h)) * 0.3).astype(np.float32)
    lf = (rng.standard_normal((b, s, h)) * 0.3 + 2.0).astype(np.float32)
    return q, k, v, li, -np.log1p(np.exp(-lf)).astype(np.float32)


@pytest.mark.parametrize("s,chunk,carry", [(32, 8, False), (32, 8, True),
                                           (23, 8, False), (8, 16, True)])
def test_mlstm_chunkwise_matches_reference(s, chunk, carry):
    """The chunkwise cell at 4 chunks, with and without a carried state,
    at an odd length (the reference runs it as one 23 x 23 chunk) and a
    prompt shorter than the chunk: outputs and final C, n."""
    b, h, dh = 2, 2, 8
    ins = _cell_inputs(s, b, s, h, dh)
    state = None
    if carry:
        rng = np.random.default_rng(9)
        state = {"C": (rng.standard_normal((b, h, dh, dh)) * 0.2).astype(
                     np.float32),
                 "n": np.abs(rng.standard_normal((b, h, dh))).astype(
                     np.float32)}
    want_y, want_st = ref_xlstm.mlstm_chunkwise(
        *map(jnp.asarray, ins), chunk=chunk,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    got_y, got_st = xlstm.mlstm_chunkwise(
        *map(torch.tensor, ins), chunk,
        state=None if state is None else _t(state))
    _close(got_y, want_y, F32, "y")
    _close_tree(got_st, want_st, F32, "final state")


def test_mlstm_step_matches_reference_and_ignores_m():
    """Three decode steps from a carried state that also holds an "m"
    (as ``tests/test_model_internals.py`` passes one), at B = 3."""
    b, h, dh = 3, 2, 8
    q, k, v, li, lf = _cell_inputs(1, b, 3, h, dh)
    rng = np.random.default_rng(2)
    state = {"C": (rng.standard_normal((b, h, dh, dh)) * 0.2).astype(
                 np.float32),
             "n": np.abs(rng.standard_normal((b, h, dh))).astype(np.float32),
             "m": np.full((b, h), -np.inf, np.float32)}
    want, got = jax.tree.map(jnp.asarray, state), _t(state)
    for i in range(3):
        sl = slice(i, i + 1)
        want_y, want = ref_xlstm.mlstm_step(
            *(jnp.asarray(a[:, sl]) for a in (q, k, v, li, lf)), want)
        got_y, got = xlstm.mlstm_step(
            *(torch.tensor(a[:, sl]) for a in (q, k, v, li, lf)), got)
        assert sorted(got) == ["C", "n"]
        _close(got_y, want_y, F32, f"step {i}")
        _close_tree(got, want, F32, f"state after step {i}")


def test_mlstm_chunkwise_matches_steps():
    """The port's twin of ``tests/test_model_internals.py::
    test_mlstm_chunkwise_matches_steps``: its chunkwise cell against its
    own step recurrence, the same draw and tolerance."""
    rng = np.random.default_rng(0)
    b, t, h, dh, chunk = 1, 32, 2, 8, 8
    q = torch.tensor(rng.standard_normal((b, t, h, dh)) * 0.3,
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((b, t, h, dh)) * 0.3,
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, t, h, dh)) * 0.3,
                     dtype=torch.float32)
    li = torch.tensor(rng.standard_normal((b, t, h)) * 0.3,
                      dtype=torch.float32)
    lf = torch.tensor(rng.standard_normal((b, t, h)) * 0.3 + 2.0,
                      dtype=torch.float32)
    out_chunk, final = xlstm.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
    state = {"C": torch.zeros((b, h, dh, dh)), "n": torch.zeros((b, h, dh)),
             "m": torch.full((b, h), -float("inf"))}
    outs = []
    for i in range(t):
        o, state = xlstm.mlstm_step(q[:, i:i + 1], k[:, i:i + 1],
                                    v[:, i:i + 1], li[:, i:i + 1],
                                    lf[:, i:i + 1], state)
        outs.append(o)
    torch.testing.assert_close(out_chunk, torch.cat(outs, dim=1),
                               **STEPS_TOL)
    torch.testing.assert_close(final["C"], state["C"], **STEPS_TOL)


def test_slstm_cell_matches_reference():
    """Five steps from the reference's initial state (m = -1e30) at B = 3,
    4 heads of 16."""
    b, h, dh = 3, 4, 16
    rng = np.random.default_rng(6)
    wx = rng.standard_normal((5, b, h, 4, dh)).astype(np.float32)
    r = (rng.standard_normal((h, dh, 4 * dh)) * 0.2).astype(np.float32)
    want = ref_xlstm.slstm_init_state(b, h, dh)
    got = xlstm.slstm_init_state(b, h, dh, device="cpu")
    _close_tree(got, want, dict(rtol=0, atol=0), "initial state")
    for t in range(5):
        want = ref_xlstm.slstm_cell(jnp.asarray(wx[t]), jnp.asarray(r), want)
        got = xlstm.slstm_cell(torch.tensor(wx[t]), torch.tensor(r), got)
        _close_tree(got, want, F32, f"step {t}")


@pytest.mark.parametrize("start", ["initial", "carried"])
def test_slstm_scan_backward_matches_autograd(start):
    """``slstm_scan``'s own backward against autograd of the plain loop of
    ``slstm_cell`` (the same forward), float32, 9 steps at R = 3: the
    gradients of wx, r and the initial state within 1e-5 of their scale.
    From the initial state (m = -1e30), and from a carried one with a
    tie in the running max at one element and an n below the 1e-6
    floor at another."""
    r_, s, h, dh = 3, 9, 2, 5
    rng = np.random.default_rng(8)
    wx = torch.tensor(rng.standard_normal((r_, s, h, 4, dh)) * 2,
                      dtype=torch.float32, requires_grad=True)
    r = torch.tensor(rng.standard_normal((h, dh, 4 * dh)) * 0.5,
                     dtype=torch.float32, requires_grad=True)
    if start == "initial":
        st = xlstm.slstm_init_state(r_, h, dh, device="cpu")
    else:
        st = {k: torch.tensor(rng.standard_normal((r_, h, dh)),
                              dtype=torch.float32) for k in "hcnm"}
        st["n"] = st["n"].abs()
        st["h"][0] = 0.0              # row 0's first step: pre = wx
        st["m"][0, 0, 0] = 0.0
        st["n"][1, 0, 0] = 1e-9
        with torch.no_grad():
            wx[0, 0, 0, 2, 0] = wx[0, 0, 0, 1, 0]   # f_r + m == i_r
            wx[1, 0, 0, 1, 0] = -30.0               # n stays under 1e-6
        st = {k: v.requires_grad_() for k, v in st.items()}
    weights = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((r_, s, h, dh),) + ((r_, h, dh),) * 4]

    def loss(hs, final):
        return (hs * weights[0]).sum() + sum(
            (final[k] * w).sum() for k, w in zip("hcnm", weights[1:],
                                                  strict=True))

    if start == "carried":
        with torch.no_grad():
            first = xlstm.slstm_cell(wx[:, 0], r, st)
            assert float(first["m"][0, 0, 0]) == float(wx[0, 0, 0, 1, 0])
            assert float(first["n"][1, 0, 0]) < 1e-6
    ins = [wx, r] + ([] if start == "initial" else list(st.values()))
    got = torch.autograd.grad(loss(*xlstm.slstm_scan(wx, r, st)), ins)
    hs, final, _ = xlstm._scan(wx, r, st, keep=False)
    want = torch.autograd.grad(loss(hs, final), ins)
    for g, w in zip(got, want, strict=True):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale, scale


def _block_params(np_params, name):
    """The first block of a stack: (jax tree, torch tree)."""
    block = jax.tree.map(lambda a: a[0], np_params[name])
    return _jp(block), params_from_numpy(block, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_blocks_match_reference(shared_params, which, dtype):
    """Each block of the reduced model on (3, 20) activations (20 is no
    multiple of the chunk: one 20 x 20 chunk), then one decode step from
    the state it returns: outputs and states."""
    np_params, _ = shared_params
    ref_cfg, cfg = _cfgs(dtype)
    jblock, tblock = _block_params(np_params, which)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 21, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref_fn = getattr(ref_xlstm, f"{which}_block")
    port_fn = getattr(xlstm, f"{which}_block")
    want_y, want_st = ref_fn(jblock, jnp.asarray(x[:, :20], jdt), ref_cfg)
    got_y, got_st = port_fn(tblock, torch.tensor(x[:, :20]).to(tdt), cfg)
    assert got_y.dtype == tdt
    _close(got_y, np.asarray(want_y.astype(jnp.float32)), TOL[dtype],
           "prefill")
    _close_tree(got_st, want_st, TOL[dtype], "prefill state")
    want_y, want_st = ref_fn(jblock, jnp.asarray(x[:, 20:], jdt), ref_cfg,
                             want_st, decode=True)
    got_y, got_st = port_fn(tblock, torch.tensor(x[:, 20:]).to(tdt), cfg,
                            got_st, decode=True)
    _close(got_y, np.asarray(want_y.astype(jnp.float32)), TOL[dtype],
           "decode")
    _close_tree(got_st, want_st, TOL[dtype], "decode state")


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _grads(port, params, batch):
    leaves, rebuild = trees.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss, metrics = port.loss_fn(rebuild(live), _t(batch))
    return loss.detach(), metrics, torch.autograd.grad(loss, live)


def test_loss_and_gradients_match_reference(shared_params, tokens):
    """float32, (2, 32) tokens (2 chunks): the loss and every gradient,
    each within 1e-4 of its largest value."""
    np_params, params = shared_params
    ref, port = _models("float32")
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:33]}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref.loss_fn, has_aux=True))(_jp(np_params),
                                    jax.tree.map(jnp.asarray, batch))
    got, metrics, grads = _grads(port, params, batch)
    np.testing.assert_allclose(float(got), float(want), **F32)
    np.testing.assert_allclose(float(metrics["xent"].detach()),
                               float(want_m["xent"]),
                               **F32)
    flat_want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    for (path, w), g in zip(flat_want, grads, strict=True):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-6)
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-4 * scale + 1e-6, (path, err, scale)


def test_remat_gives_the_same_loss_and_gradients(shared_params, tokens):
    """``torch.utils.checkpoint`` around each block (``cfg.remat``)
    recomputes the same ops: the loss and every gradient bit for bit."""
    _, params = shared_params
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:33]}
    out = {}
    for remat in (False, True):
        _, port = _models("float32", remat=remat)
        out[remat] = _grads(port, params, batch)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][2], out[True][2], strict=True):
        assert torch.equal(a, b)


def test_bf16_loss_matches_reference(shared_params, tokens):
    np_params, params = shared_params
    ref, port = _models("bfloat16")
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:33]}
    want, _ = jax.jit(ref.loss_fn)(_jp(np_params),
                                   jax.tree.map(jnp.asarray, batch))
    got, _ = port.loss_fn(params, _t(batch))
    np.testing.assert_allclose(float(got), float(want), **BF16)


@pytest.mark.parametrize("dtype,s,n_layers", [
    ("float32", 32, 2), ("float32", 23, 2), ("bfloat16", 32, 2),
    ("float32", 32, 4)])
def test_prefill_and_four_decode_steps_match_reference(tokens, dtype, s,
                                                       n_layers):
    """Prefill (32 tokens: 2 chunks; 23: one odd chunk) and four decode
    steps: logits, every state and pos after each. At 4 layers the stack
    runs both mLSTM blocks, then both sLSTM blocks, as the reference
    does (interleaved, the logits part by more than 1e-2)."""
    np_params, params = _ref_params(n_layers=n_layers)
    ref, port = _models(dtype, n_layers=n_layers)
    jparams = _jp(np_params)
    want_logits, want = jax.jit(ref.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:, :s])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :s])})
    tol = TOL[dtype]
    _close(logits, want_logits, tol, "prefill logits")
    assert state["pos"] == int(want["pos"]) == s - 1
    _close_tree(state["states"], want["states"], tol, "prefill states")
    ref_step = jax.jit(ref.decode_fn)
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        want_logits, want = ref_step(jparams, want, {"token": jnp.asarray(tok)})
        logits, state = port.decode_fn(params, state,
                                       {"token": torch.tensor(tok)})
        _close(logits, want_logits, tol, f"decode step {i}")
        assert state["pos"] == int(want["pos"])
        _close_tree(state["states"], want["states"], tol,
                    f"states after step {i}")
    if n_layers == 4:      # the interleaved order gives other logits
        def interleaved(p, toks):
            x = ref_xlstm.common.embed(p["embed"], toks)
            cfg = ref.config
            for i in range(2):
                for name, fn in (("mlstm", ref_xlstm.mlstm_block),
                                 ("slstm", ref_xlstm.slstm_block)):
                    x, _ = fn(jax.tree.map(lambda a: a[i], p[name]), x, cfg)
            x = ref_xlstm.common.rmsnorm(p["ln_f"], x, cfg.norm_eps)
            return ref_xlstm.common.unembed_untied(p["lm_head"], x[:, -1:])
        other = interleaved(jparams, jnp.asarray(tokens[:, :s]))
        got, _ = port.prefill_fn(params, {"tokens": torch.tensor(
            tokens[:, :s])})
        assert float(np.abs(np.asarray(other) - got.numpy()).max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 32])
def test_prefill_plus_decode_equals_longer_prefill(shared_params, tokens,
                                                   dtype, n):
    """``tests/test_serve_consistency.py``'s property: prefill(t[:n]) +
    decode(t[n]) against prefill(t[:n + 1]) within its rtol = atol = 3e-2,
    greedy tokens equal outside its drift band."""
    _, params = shared_params
    _, port = _models(dtype)
    t = torch.tensor(tokens[:, :n + 1])
    longer, _ = port.prefill_fn(params, {"tokens": t})
    _, state = port.prefill_fn(params, {"tokens": t[:, :n]})
    stepped, _ = port.decode_fn(params, state, {"token": t[:, n:n + 1]})
    a, b = longer[:, -1].float().numpy(), stepped[:, -1].float().numpy()
    np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)
    for r in range(a.shape[0]):
        gap = np.sort(a[r])[-1] - np.sort(a[r])[-2]
        if gap > 6e-2:
            assert a[r].argmax() == b[r].argmax(), (r, gap)
        else:
            assert a[r].max() - a[r][b[r].argmax()] <= 6e-2, (r, gap)


def _serial(model, params, toks, max_new):
    sched = WaveScheduler(model, params, max_batch=1)
    r = Request(rid=0, tokens=toks, max_new_tokens=max_new)
    sched.submit(r)
    sched.run()
    return r.output


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batched_equals_serial(shared_params, dtype):
    """Five requests in waves of 3 and 2 (lengths 12 and 20): each
    request's tokens equal its batch-1 serial run's."""
    _, params = shared_params
    _, model = _models(dtype)
    rng = np.random.default_rng(5)
    sched = WaveScheduler(model, params, max_batch=3)
    reqs = []
    for rid in range(5):
        plen = 12 if rid % 2 == 0 else 20
        r = Request(rid=rid, tokens=rng.integers(0, 512, plen).astype(
            np.int32), max_new_tokens=6)
        reqs.append(r)
        sched.submit(r)
    assert len(sched.run()) == 5
    assert [s.batch for s in sched.stats] == [3, 2]
    for r in reqs:
        np.testing.assert_array_equal(
            r.output, _serial(model, params, r.tokens, r.max_new_tokens))


# ---------------------------------------------------------------------------
# federated rounds and the launchers
# ---------------------------------------------------------------------------
def test_federated_xlstm_rounds_match_reference():
    """Reduced xlstm-1.3b (float32) in both batched engines, 7 clients, 3
    rounds of pso at seed 0, deterministic timing, the port started from
    the reference's initial params: placements and TPDs exactly, losses
    within rtol 1e-4, final params within rtol 1e-3 / atol 1e-5."""
    ref_cfg, cfg = _cfgs("float32")
    seed, seq = 0, 16
    runs = []
    for pkg in ("ref", "port"):
        H, Pool = (RefHierarchy, RefClientPool) if pkg == "ref" else \
            (Hierarchy, ClientPool)
        h = H(depth=2, width=2, trainers_per_leaf=1, n_clients=7)
        pool = Pool.random(h.total_clients, seed=seed)
        if pkg == "ref":
            orch = RefOrchestrator(
                ref_get_model(ref_cfg), h, pool,
                ref_make_dataset(ref_cfg, h.total_clients, seed, seq),
                local_steps=2, batch_size=2, seed=seed,
                timing="deterministic", engine="batched")
            init = jax.tree.map(np.asarray, orch.params)
            strat = ref_create_strategy("pso", h, seed=seed, clients=pool)
        else:
            orch = FederatedOrchestrator(
                get_model(cfg), h, pool,
                make_federated_dataset(cfg, h.total_clients, seed, seq),
                local_steps=2, batch_size=2, seed=seed,
                timing="deterministic", engine="batched", device="cpu")
            orch.set_global(params_from_numpy(init, device="cpu"))
            strat = create_strategy("pso", h, seed=seed, clients=pool)
        runs.append((orch.run(strat, rounds=3), orch))
    (want, ref_orch), (got, orch) = runs
    assert [r.placement for r in got.rounds] == \
        [r.placement for r in want.rounds]
    assert got.tpds.tolist() == want.tpds.tolist()
    np.testing.assert_allclose([r.loss for r in got.rounds],
                               [r.loss for r in want.rounds], rtol=1e-4)
    for a, b in zip(trees.tree_leaves(params_to_numpy(orch.params)),
                    jax.tree.leaves(ref_orch.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)


def test_launch_train_federates_xlstm_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    out = tmp_path / "rounds.json"
    assert main(["--arch", ARCH, "--clients", "7", "--rounds", "1",
                 "--local-steps", "1", "--batch-size", "2", "--out",
                 str(out)], device="cpu") == 0
    record = json.loads(out.read_text())
    assert record["summary"]["rounds"] == 1
    assert all(np.isfinite(r["loss"]) for r in record["rounds"])
    assert '"strategy": "pso"' in capsys.readouterr().out


@pytest.mark.parametrize("launcher", ["serve", "decode_step"])
def test_xlstm_launchers_run_on_the_cpu(capsys, launcher):
    if launcher == "serve":
        from repro_torch.launch.serve import main
        argv = ["--arch", ARCH, "--new-tokens", "3"]
        want = f"arch={ARCH} (reduced)"
    else:
        from repro_torch.launch.decode_step import main
        argv = ["--arch", ARCH, "--reduced", "--batch", "3", "--prompt",
                "16"]
        want = "finite logits True [cpu]"
    assert main(argv, device="cpu") == 0
    assert want in capsys.readouterr().out
