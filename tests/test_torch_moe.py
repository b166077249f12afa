"""The moe family (granite-moe-1b-a400m, qwen3-moe-235b-a22b): the port's
``models/moe.py`` and the moe branch of ``models/transformer.py`` against
the reference on the CPU.

Params cross over from the reference's init through
``params_from_numpy``; inputs come from numpy seeds. Tolerances: the
routing's gate values within 1e-6 (XLA's and torch's float32 softmax
round the last bit differently; the routing choices, the nonzero
pattern, are held exactly) and exactly equal under a zero router, where
every prob ties and only the order of ``top_k`` decides; the expert FFN
at float32 rtol = atol = 1e-5; the reduced models at
``tests/test_torch_transformer.py``'s F32 (rtol = atol = 1e-4) and BF16
(rtol 0.05, atol 0.15) tolerances. Expert capacity spans the whole
batch, so a moe request's tokens depend on its wave: one test shows
batched and serial serving part at the same tokens in both packages.
"""
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
from repro.models import moe as ref_moe
from repro.models.sharding import UNSHARDED as REF_UNSHARDED
from repro.serving import Request as RefRequest
from repro.serving import WaveScheduler as RefScheduler
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data import make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import UNSHARDED, get_model
from repro_torch.models import moe
from repro_torch.models import transformer as port_transformer
from repro_torch.models.sharding import ShardingPolicy
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils import trees

MOE = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
_PARAM_STREAM = 3            # reference init key of the shared params
_TOKEN_STREAM = 0
_SERVE_STREAM = 0            # prompts of the batched-vs-serial test
GATE_ATOL = 1e-6
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
TOL = {"float32": F32, "bfloat16": BF16}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the reduced models' ops are too small
    to gain from more, and spinning thread teams slow many fold when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name, dtype, **kw):
    ref_cfg = ref_get_config(name).reduced().replace(dtype=dtype, **kw)
    cfg = get_config(name).reduced().replace(dtype=dtype, **kw)
    return ref_get_model(ref_cfg), get_model(cfg)


@pytest.fixture(scope="session")
def shared_params():
    """name -> (numpy params, port params) of each reduced moe config,
    drawn by the reference."""
    out = {}
    for name in MOE:
        np_params = jax.tree.map(np.asarray, ref_get_model(
            ref_get_config(name).reduced()).init(
                jax.random.key(_PARAM_STREAM)))
        out[name] = np_params, params_from_numpy(np_params, device="cpu")
    return out


@pytest.fixture(scope="session")
def tokens():
    return np.random.default_rng(_TOKEN_STREAM).integers(
        0, 512, (3, 310)).astype(np.int32)


def _jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _moe_cfgs(e=4, k=2, f=16):
    """A small MoEConfig of each package."""
    from repro.configs.base import MoEConfig as RefMoEConfig

    from repro_torch.configs.base import MoEConfig
    return (RefMoEConfig(n_experts=e, top_k=k, d_ff_expert=f),
            MoEConfig(n_experts=e, top_k=k, d_ff_expert=f))


def _np_moe_params(rng, d, e, f, router_scale=1.0):
    return {"router": (rng.standard_normal((d, e)) * router_scale
                       ).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                       ).astype(np.float32),
            "w_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                     ).astype(np.float32),
            "w_down": (rng.standard_normal((e, f, d)) / np.sqrt(f)
                       ).astype(np.float32)}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_init_layout_matches_reference(name):
    """The reference's tree (``moe`` in place of ``ffn``), shapes and
    dtypes, the router float32 whatever ``param_dtype`` says."""
    for dtype in ("float32", "bfloat16"):
        ref_cfg = ref_get_config(name).reduced().replace(param_dtype=dtype)
        cfg = get_config(name).reduced().replace(param_dtype=dtype)
        want = jax.eval_shape(ref_get_model(ref_cfg).init, jax.random.key(0))
        got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        assert "moe" in got["layers"] and "ffn" not in got["layers"]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_got = trees.tree_leaves(got)
        assert len(flat_got) == len(flat_want)
        for (path, w), g in zip(flat_want, flat_got, strict=True):
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def test_sharding_policy_sizes_and_mesh_refusal():
    assert UNSHARDED.model_size == 1 and UNSHARDED.batch_size_divisor == 1

    class _Mesh:
        shape = {"data": 2, "model": 4}
        axis_names = ("data", "model")

    meshed = ShardingPolicy(mesh=_Mesh(), model_axis="model")
    assert meshed.model_size == 4
    _, cfg = _moe_cfgs()
    params = _t(_np_moe_params(np.random.default_rng(0), 8, 4, 16))
    with pytest.raises(NotImplementedError, match="item 12"):
        moe.moe_ffn(params, torch.zeros(1, 4, 8), cfg, meshed)


# ---------------------------------------------------------------------------
# top-k and routing
# ---------------------------------------------------------------------------
def test_top_k_takes_the_lower_index_first_among_ties():
    """A row with ones at 5, 17 and 33 among zeros: jax.lax.top_k gives
    [5, 17, 33, 0, 1, 2], and so must the port (a plain torch.topk need
    not)."""
    row = np.zeros((1, 40), np.float32)
    row[0, [5, 17, 33]] = 1.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 6)
    got_v, got_i = moe.top_k(torch.tensor(row), 6)
    assert got_i.tolist() == np.asarray(want_i).tolist() == \
        [[5, 17, 33, 0, 1, 2]]
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    # many ties: values on a coarse grid
    x = np.random.default_rng(1).integers(0, 4, (50, 64)).astype(np.float32)
    for k in (1, 7, 64):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = moe.top_k(torch.tensor(x), k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234, 9999])
def test_route_matches_reference(seed):
    """The draw of ``tests/test_model_internals.py::
    test_route_gates_renormalized``: the same k experts per token, gates
    within 1e-6, aux within 1e-6."""
    rng = np.random.default_rng(seed)
    t, d, e, k = 12, 8, 6, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    want_g, want_aux = ref_moe._route(jnp.asarray(x), jnp.asarray(router), k)
    got_g, got_aux, _ = moe.route(torch.tensor(x), torch.tensor(router), k)
    want_g = np.asarray(want_g)
    assert np.array_equal(got_g.numpy() > 0, want_g > 0)
    assert ((got_g.numpy() > 0).sum(axis=1) == k).all()
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=GATE_ATOL)
    np.testing.assert_allclose(got_g.numpy().sum(axis=1), 1.0, rtol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) <= GATE_ATOL


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_match_reference(k):
    """``test_route_aux_balanced_vs_skewed``'s zero router: every prob
    is 1/E, so only top-k's order among equal values picks the experts;
    the gates are equal exactly (``torch.topk`` would pick others)."""
    t, d, e = 64, 8, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((t, d)).astype(np.float32)
    balanced = np.zeros((d, e), np.float32)
    collapsed = balanced.copy()
    collapsed[:, 0] = 10.0
    collapsed += (rng.standard_normal((d, e)) * 1e-3).astype(np.float32)
    want_b, want_aux_b = ref_moe._route(jnp.asarray(x), jnp.asarray(balanced),
                                        k)
    got_b, got_aux_b, _ = moe.route(torch.tensor(x), torch.tensor(balanced),
                                     k)
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert (got_b.numpy()[:, :k] > 0).all()     # the lowest experts
    assert abs(float(got_aux_b) - float(want_aux_b)) <= GATE_ATOL
    _, got_aux_c, _ = moe.route(torch.tensor(x), torch.tensor(collapsed), k)
    _, want_aux_c = ref_moe._route(jnp.asarray(x), jnp.asarray(collapsed), k)
    assert abs(float(got_aux_c) - float(want_aux_c)) <= GATE_ATOL
    if k == 1:    # the reference's own claim (at k 2 the tied router
        # sends every token to experts 0 and 1: aux 2.0, above collapsed)
        assert float(got_aux_c) > float(got_aux_b)


# ---------------------------------------------------------------------------
# the expert FFN
# ---------------------------------------------------------------------------
def _tied_gates(t, e, k, groups):
    """(T, E) gates with k nonzeros a row, rows repeated in ``groups``
    (equal gates), and each token's experts (T, k)."""
    rng = np.random.default_rng(11)
    base = []
    for _ in range(groups):
        row = np.zeros(e, np.float32)
        pick = rng.choice(e, k, replace=False)
        w = rng.uniform(0.2, 1.0, k).astype(np.float32)
        row[pick] = w / w.sum()
        base.append(row)
    gates = np.stack([base[i % groups] for i in range(t)])
    choices = np.stack([np.flatnonzero(r)[:k] for r in gates])
    return gates, choices


def test_expert_compute_with_ties_at_the_capacity_boundary():
    """Duplicate rows (equal gates) straddle every expert's capacity
    boundary: the same tokens are kept as the reference keeps (the
    lower token index first), the outputs within 1e-5."""
    t, d, e, k, f = 24, 8, 4, 2, 16
    gates, choices = _tied_gates(t, e, k, groups=3)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((t, d)).astype(np.float32)
    p = _np_moe_params(rng, d, e, f)
    ref_compute = jax.jit(ref_moe._expert_compute, static_argnums=5)
    for cap in (3, 5, 7, 24):
        want = ref_compute(jnp.asarray(x), jnp.asarray(gates), p["w_gate"],
                           p["w_up"], p["w_down"], cap)
        got = moe._expert_compute(
            torch.tensor(x), torch.tensor(gates), torch.tensor(choices),
            *(torch.tensor(p[n]) for n in ("w_gate", "w_up", "w_down")), cap)
        _close(got, want, FFN_TOL, f"capacity {cap}")
        # a token the capacity dropped from every expert it chose is 0
        kept = np.zeros(t, bool)
        _, gi = jax.lax.top_k(jnp.asarray(gates.T), min(cap, t))
        for ex, row in enumerate(np.asarray(gi)):
            kept[row[gates[row, ex] > 0]] = True
        assert not got.numpy()[~kept].any()
        assert cap == t or (~kept).any()


@pytest.mark.parametrize("case", ["drops", "mask", "bf16 activations"])
def test_moe_ffn_matches_reference(case):
    """``moe_ffn`` on a (2, 8) batch: a skewed router whose capacity
    (ceil(16 x 2 x 1.25 / 4) = 10) drops tokens; the pad mask over the
    last 3 positions; bf16 activations promoted to f32 products."""
    b, s, d, f = 2, 8, 16, 32
    ref_cfg, cfg = _moe_cfgs(e=4, k=2, f=f)
    rng = np.random.default_rng(21)
    p = _np_moe_params(rng, d, 4, f, router_scale=1.0)
    if case == "drops":
        p["router"][:, 0] += 3.0 * np.sign(p["router"][:, 0])
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = (np.arange(s) < s - 3) if case == "mask" else None
    jx = jnp.asarray(x, jnp.bfloat16 if case == "bf16 activations"
                     else jnp.float32)
    tx = torch.tensor(x).to(torch.bfloat16 if case == "bf16 activations"
                            else torch.float32)
    want, want_aux = ref_moe.moe_ffn(
        _jp(p), jx, ref_cfg, REF_UNSHARDED,
        mask=None if mask is None else jnp.asarray(mask))
    got, got_aux = moe.moe_ffn(_t(p), tx, cfg, UNSHARDED,
                               mask=None if mask is None
                               else torch.tensor(mask))
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, s, d)
    tol = FFN_TOL if case != "bf16 activations" else dict(rtol=1e-2,
                                                           atol=1e-2)
    _close(got, want, tol, case)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5
    gates, _, _ = moe.route(tx.reshape(b * s, d), _t(p)["router"], 2)
    routed = (gates > 0).sum(0)
    cap = moe.capacity_of(b * s, cfg)
    assert cap == 10
    if case == "drops":
        assert int(routed.max()) > cap     # some expert drops tokens
    if case == "mask":
        assert not got.reshape(b, s, d)[:, s - 3:].any()


def test_combine_reruns_are_bit_equal_and_match_a_scatter_add():
    """The gather combine against the reference's scatter-add, done here
    in float64 (unique slots per expert, ascending experts)."""
    t, d, e, k, f = 40, 8, 4, 2, 16
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((t, d)).astype(np.float32))
    p = _t(_np_moe_params(rng, d, e, f))
    gates, _, choices = moe.route(x, p["router"], k)
    gw, gi = moe.top_k(gates.t(), 13)
    ye = moe.expert_ffn(x[gi], gw, p["w_gate"], p["w_up"], p["w_down"])
    got = moe.combine(ye, gi, choices, t)
    assert torch.equal(got, moe.combine(ye, gi, choices, t))
    want = torch.zeros(t, d, dtype=torch.float64)
    for ex in range(e):
        want.index_add_(0, gi[ex], ye[ex].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_combine_gradient_is_the_plain_gathers():
    """The combine's own backward (a gather a slot) against autograd of
    the plain gather and sum, on a skewed router whose capacity drops
    most choices (many rows at the zero row)."""
    t, d, e, k, f = 48, 8, 4, 2, 16
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((t, d)).astype(np.float32))
    p = _t(_np_moe_params(rng, d, e, f))
    p["router"][:, 1] += 4.0 * torch.sign(p["router"][:, 1])
    gates, _, choices = moe.route(x, p["router"], k)
    gw, gi = moe.top_k(gates.t(), 5)
    ye = torch.tensor(rng.standard_normal((e, 5, d)).astype(np.float32),
                      requires_grad=True)
    g_out = torch.tensor(rng.standard_normal((t, d)).astype(np.float32))
    got = torch.autograd.grad(moe.combine(ye, gi, choices, t), ye, g_out)[0]
    slot = torch.full((e, t), e * 5, dtype=torch.long)
    slot.scatter_(1, gi, torch.arange(e * 5).view(e, 5))
    rows = slot[choices, torch.arange(t)[:, None]]
    assert int((rows == e * 5).sum()) > t // 2       # most choices dropped
    plain = torch.cat([ye.reshape(e * 5, d), ye.new_zeros(1, d)])[rows]
    want = torch.autograd.grad(plain.sum(dim=1), ye, g_out)[0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="session")
def reference_grads(shared_params, tokens):
    """name -> the reference's float32 (loss, metrics, path-keyed grads)
    on a 17-token batch (padded to 18), once per config (its remat only
    re-runs the forward, with the same values)."""
    out = {}
    batch = {"tokens": tokens[:2, :17], "labels": tokens[:2, 1:18]}
    for name in MOE:
        np_params, _ = shared_params[name]
        ref, _ = _models(name, "float32")
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            ref.loss_fn, has_aux=True))(_jp(np_params),
                                        jax.tree.map(jnp.asarray, batch))
        out[name] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     jax.tree_util.tree_flatten_with_path(grads)[0])
    return batch, out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_loss_and_gradients_match_reference(shared_params, reference_grads,
                                            name, remat):
    """float32, a 17-token batch (padded to 18: the pad masked out of
    routing): loss, ``moe_aux`` and every gradient, the port's forward
    with and without ``torch.utils.checkpoint``."""
    _, params = shared_params[name]
    batch, ref_out = reference_grads
    want, want_m, want_g = ref_out[name]
    _, port = _models(name, "float32", remat=remat)
    leaves, rebuild = trees.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    got, metrics = port.loss_fn(rebuild(live), _t(batch))
    grads = torch.autograd.grad(got, live)
    got = got.detach()
    np.testing.assert_allclose(float(got), want, **F32)
    for key in ("xent", "moe_aux"):
        np.testing.assert_allclose(float(metrics[key].detach()), want_m[key],
                                   **F32)
    assert float(got) == pytest.approx(
        float(metrics["xent"].detach())
        + 0.01 * float(metrics["moe_aux"].detach()), rel=1e-6)
    for (path, w), g in zip(want_g, grads, strict=True):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-6)
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-4 * scale + 1e-6, (path, err, scale)


@pytest.mark.parametrize("name", MOE)
def test_bf16_loss_matches_reference(shared_params, tokens, name):
    np_params, params = shared_params[name]
    ref, port = _models(name, "bfloat16")
    batch = {"tokens": tokens[:2, :32], "labels": tokens[:2, 1:33]}
    want, want_m = jax.jit(ref.loss_fn)(_jp(np_params),
                                        jax.tree.map(jnp.asarray, batch))
    got, metrics = port.loss_fn(params, _t(batch))
    np.testing.assert_allclose(float(got), float(want), **BF16)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(want_m["moe_aux"]), **BF16)


def _check_state(state, want, tol):
    assert state["pos"] == int(want["pos"])
    for key in ("k", "v"):
        got = state["cache"][key]
        assert tuple(got.shape) == tuple(want["cache"][key].shape), key
        _close(got, want["cache"][key], tol, f"cache/{key}")


@pytest.mark.parametrize("s", [17, 300])
@pytest.mark.parametrize("name", MOE)
def test_padded_prefill_and_four_decode_steps_match_reference(
        shared_params, tokens, name, s):
    """float32 prefill of a padded prompt (17 -> 18, 300 -> 512: the
    pads masked out of routing) and four decode steps: logits, caches
    and pos after each."""
    np_params, params = shared_params[name]
    ref, port = _models(name, "float32")
    jparams = _jp(np_params)
    want_logits, want = jax.jit(ref.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:2, :s])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:2, :s])})
    _close(logits, want_logits, F32, "prefill logits")
    _check_state(state, want, F32)
    ref_step = jax.jit(ref.decode_fn)
    for i in range(4):
        tok = tokens[:2, s + i:s + i + 1]
        want_logits, want = ref_step(jparams, want, {"token": jnp.asarray(tok)})
        logits, state = port.decode_fn(params, state,
                                       {"token": torch.tensor(tok)})
        _close(logits, want_logits, F32, f"decode step {i}")
        _check_state(state, want, F32)


def test_decode_routes_only_the_real_rows(shared_params, tokens,
                                          monkeypatch):
    """B = 3 decodes on 8 rows (``common.DECODE_ROWS``): the moe layers
    see T = 3 tokens (capacity ceil(3 x 2 x 1.25 / 4) = 2, not the 8
    rows' 5), and the tokens are the reference's."""
    name = MOE[0]
    np_params, params = shared_params[name]
    ref, port = _models(name, "float32")
    seen = []
    real = port_transformer.moe_ffn

    def spy(p, x, cfg, *args, **kw):
        seen.append(x.shape[0] * x.shape[1])
        return real(p, x, cfg, *args, **kw)

    jparams = _jp(np_params)
    _, want = jax.jit(ref.prefill_fn)(jparams, {"tokens": jnp.asarray(
        tokens[:, :20])})
    _, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :20])})
    monkeypatch.setattr(port_transformer, "moe_ffn", spy)
    ref_step = jax.jit(ref.decode_fn)
    tok = want_tok = tokens[:, 20:21]
    for i in range(4):
        want_logits, want = ref_step(jparams, want,
                                     {"token": jnp.asarray(want_tok)})
        logits, state = port.decode_fn(params, state,
                                       {"token": torch.tensor(tok)})
        assert tuple(logits.shape) == tuple(want_logits.shape)
        _close(logits, want_logits, F32, f"decode step {i}")
        want_tok = np.asarray(jnp.argmax(want_logits[:, -1], -1),
                              np.int32)[:, None]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].numpy()
        assert np.array_equal(tok, want_tok)
    cfg = port.config
    assert seen == [3] * (4 * cfg.n_layers)
    assert moe.capacity_of(3, cfg.moe) == 2 < moe.capacity_of(8, cfg.moe)


def _serve(pkg, model, params, prompts, max_batch, new):
    sched_cls, req_cls = (RefScheduler, RefRequest) if pkg == "ref" else \
        (WaveScheduler, Request)
    sched = sched_cls(model, params, max_batch=max_batch)
    reqs = [req_cls(rid=i, tokens=t, max_new_tokens=new)
            for i, t in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return np.stack([r.output for r in reqs])


def test_batched_and_serial_serving_part_at_the_same_tokens(shared_params):
    """Four 12-token prompts (seed 0), 8 new tokens each, float32: in the
    reference a wave of 4 is not 4 waves of 1 (capacity over the whole
    wave), and the port parts at the same tokens, equal to the
    reference at each batch."""
    name = MOE[0]
    np_params, params = shared_params[name]
    ref, port = _models(name, "float32")
    rng = np.random.default_rng(_SERVE_STREAM)
    prompts = [rng.integers(0, 512, 12).astype(np.int32) for _ in range(4)]
    out = {(pkg, mb): _serve(pkg, m, p, prompts, mb, 8)
           for pkg, m, p in (("ref", ref, _jp(np_params)),
                             ("port", port, params))
           for mb in (4, 1)}
    for mb in (4, 1):
        assert np.array_equal(out["port", mb], out["ref", mb]), mb
    ref_same = (out["ref", 4] == out["ref", 1]).all(axis=1)
    port_same = (out["port", 4] == out["port", 1]).all(axis=1)
    assert ref_same.tolist() == port_same.tolist() == \
        [True, False, False, True]


# ---------------------------------------------------------------------------
# federated rounds and the launchers
# ---------------------------------------------------------------------------
def _federated_pair(seed, seq=16):
    """Reduced granite-moe (float32) in both batched engines, 7 clients,
    pso, deterministic timing, the port started from the reference's
    initial params: [(orchestrator, strategy) of the reference, of the
    port]."""
    name = MOE[0]
    ref_cfg = ref_get_config(name).reduced().replace(dtype="float32")
    cfg = get_config(name).reduced().replace(dtype="float32")
    pair = []
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
        pair.append((orch, strat))
    return pair


def test_federated_moe_rounds_match_reference():
    """Both batched engines (``_federated_pair``), 3 rounds at seed 0:
    placements and TPDs exactly, losses within 1e-4, final params within
    rtol 1e-3 / atol 1e-5. Seed 0: at seed 1 two tokens sit 6e-7 apart
    in gate at an expert's capacity cut in round 2, and float32 rounding
    on either side swaps them (ROADMAP.md §3 logs it; the next test
    holds seed 1 on both sides of that cut); seeds 0, 2 and 3 agree to
    1e-7."""
    (ref_orch, ref_strat), (orch, strat) = _federated_pair(0)
    want = ref_orch.run(ref_strat, rounds=3)
    got = orch.run(strat, rounds=3)
    assert [r.placement for r in got.rounds] == \
        [r.placement for r in want.rounds]
    assert got.tpds.tolist() == want.tpds.tolist()
    np.testing.assert_allclose([r.loss for r in got.rounds],
                               [r.loss for r in want.rounds], rtol=1e-4)
    for a, b in zip(trees.tree_leaves(params_to_numpy(orch.params)),
                    jax.tree.leaves(ref_orch.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)


def test_federated_moe_seed1_parts_only_at_its_capacity_near_tie():
    """Seed 1, where the two packages part in round 2 at a capacity
    near-tie (ROADMAP.md §3): round 1 agrees within 1e-4, and round 2
    agrees within 1e-4 too once the port starts it from the reference's
    round-1 params, so nothing but that round's swapped tie parts
    them."""
    (ref_orch, ref_strat), (orch, strat) = _federated_pair(1)
    ref_orch.warmup()
    orch.warmup()
    for r in range(2):
        if r == 1:
            orch.set_global(params_from_numpy(
                jax.tree.map(np.asarray, ref_orch.params), device="cpu"))
        recs = []
        for o, s in ((ref_orch, ref_strat), (orch, strat)):
            placement = np.asarray(s.propose(r), np.int64)
            rec = o.run_round(r, placement)
            s.observe(placement, rec.tpd)
            recs.append(rec)
        want, got = recs
        assert got.placement == want.placement, r
        assert got.tpd == want.tpd, r
        np.testing.assert_allclose(got.loss, want.loss, rtol=1e-4,
                                   err_msg=f"round {r + 1}")


def test_launch_train_federates_granite_moe_on_the_cpu(tmp_path, capsys):
    import json

    from repro_torch.launch.train import main
    out = tmp_path / "rounds.json"
    assert main(["--arch", "granite-moe-1b-a400m", "--clients", "7",
                 "--rounds", "1", "--local-steps", "1", "--batch-size", "2",
                 "--out", str(out)], device="cpu") == 0
    record = json.loads(out.read_text())
    assert record["summary"]["rounds"] == 1
    assert all(np.isfinite(r["loss"]) for r in record["rounds"])
    assert '"strategy": "pso"' in capsys.readouterr().out


@pytest.mark.parametrize("launcher", ["serve", "decode_step",
                                      "moe_combine_ab"])
def test_moe_launchers_run_on_the_cpu(capsys, launcher):
    if launcher == "serve":
        from repro_torch.launch.serve import main
        argv = ["--arch", "granite-moe-1b-a400m", "--new-tokens", "3"]
        want = "arch=granite-moe-1b-a400m (reduced)"
    elif launcher == "moe_combine_ab":
        from repro_torch.launch.moe_combine_ab import main
        argv = ["--reduced", "--tokens", "16", "--pairs", "1"]
        want = "finite losses True [cpu]"
    else:
        from repro_torch.launch.decode_step import main
        argv = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--batch", "3",
                "--prompt", "16"]
        want = "finite logits True [cpu]"
    assert main(argv, device="cpu") == 0
    assert want in capsys.readouterr().out

