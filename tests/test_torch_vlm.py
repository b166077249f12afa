"""The vlm family (llava-next-mistral-7b): the decoder's stub vision
prefix in ``models/transformer.py``, and its serving and federated
paths, against the reference on the CPU.

Both packages run ``llava-next-mistral-7b`` at ``reduced()`` (2 layers,
d 256, 4 heads of 64, d_ff 1024, vocab 512, rope theta 1e6, a prefix of
8 patch embeddings x 256), with the reference's params carried across
by ``params_from_numpy``; tokens and frontends come from numpy seeds.
The flash kernel runs as its plain version here (CPU tensors). GQA
needs ``.replace(n_kv_heads=2)``: ``reduced()`` keeps as many kv heads
as heads.

Tolerances (as ``tests/test_torch_transformer.py``): float32 runs at
rtol = atol = 1e-4; bfloat16 runs (the config's own ``dtype``) at rtol
0.05, atol 0.15; gradients within 1e-4 of each one's largest value.
"""
import dataclasses
import json
import math

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
from repro.models import transformer as ref_transformer
from repro.serving import Request as RefRequest
from repro.serving import WaveScheduler as RefScheduler
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data import FederatedLMDataset, make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model
from repro_torch.models import transformer
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils import trees

ARCH = "llava-next-mistral-7b"
_PARAM_STREAM = 3            # reference init key of the shared params
_TOKEN_STREAM = 0
_FRONTEND_STREAM = 7
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
def gqa_params():
    return _ref_params(n_kv_heads=2)


@pytest.fixture(scope="session")
def tokens():
    return np.random.default_rng(_TOKEN_STREAM).integers(
        0, 512, (2, 300)).astype(np.int32)


def _frontend(b, seed=_FRONTEND_STREAM):
    cfg = get_config(ARCH).reduced()
    return np.random.default_rng(seed).normal(
        scale=0.02, size=(b, cfg.frontend_len, cfg.frontend_dim)
    ).astype(np.float32)


def _jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _check_state(state, want, tol, what):
    assert state["pos"] == int(want["pos"]), what
    for key in ("k", "v"):
        got = state["cache"][key]
        assert tuple(got.shape) == tuple(want["cache"][key].shape), \
            (what, key)
        _close(got, want["cache"][key], tol, f"{what} cache/{key}")


# ---------------------------------------------------------------------------
# config, registry, init
# ---------------------------------------------------------------------------
def test_config_is_copied_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(ref_get_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.frontend_len, cfg.frontend_dim) == \
        ("vlm", 2880, 4096)


def test_init_layout_matches_reference():
    """The dense decoder's tree: the vlm family adds no param (the
    vision tower and projector are the stub frontend)."""
    ref_cfg, cfg = _cfgs("bfloat16")
    want = jax.eval_shape(ref_get_model(ref_cfg).init, jax.random.key(0))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = trees.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("s", [5, 6, 250, 300])
def test_embed_inputs_puts_the_prefix_first(shared_params, tokens, s):
    """The frontend before the tokens, the whole padded by ``_pad_len``
    (8 + 5 = 13 -> 14; 8 + 250 = 258 -> 512): the embeddings, n_prefix
    and n_pad equal the reference's."""
    np_params, params = shared_params
    ref_cfg, cfg = _cfgs("float32")
    fe = _frontend(2)
    want, want_prefix, want_pad = ref_transformer.embed_inputs(
        _jp(np_params), {"tokens": jnp.asarray(tokens[:, :s]),
                         "frontend": jnp.asarray(fe)}, ref_cfg)
    got, n_prefix, n_pad = transformer.embed_inputs(
        params, {"tokens": torch.tensor(tokens[:, :s]),
                 "frontend": torch.tensor(fe)}, cfg)
    assert (n_prefix, n_pad) == (want_prefix, want_pad)
    assert n_prefix == cfg.frontend_len
    assert got.shape[1] == transformer._pad_len(s + n_prefix)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[:, :n_prefix].numpy(), fe)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _grads(model, params, batch):
    leaves, rebuild = trees.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    loss, metrics = model.loss_fn(rebuild(live), _t(batch))
    return loss.detach(), metrics, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(shared_params, tokens, remat):
    """float32, 8 patches + (2, 23) tokens (padded to 32): the loss reads
    the text positions only; it and every gradient within 1e-4 of its
    largest value, with and without remat."""
    np_params, params = shared_params
    ref, port = _models("float32", remat=remat)
    batch = {"tokens": tokens[:, :23], "labels": tokens[:, 1:24],
             "frontend": _frontend(2)}
    (want, _), want_g = jax.jit(jax.value_and_grad(
        ref.loss_fn, has_aux=True))(_jp(np_params),
                                    jax.tree.map(jnp.asarray, batch))
    got, metrics, grads = _grads(port, params, batch)
    np.testing.assert_allclose(float(got), float(want), **F32)
    assert float(metrics["xent"].detach()) == float(got)
    flat_want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    for (path, w), g in zip(flat_want, grads, strict=True):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-6)
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-4 * scale + 1e-6, (path, err, scale)


def test_bf16_loss_matches_reference(shared_params, tokens):
    np_params, params = shared_params
    ref, port = _models("bfloat16")
    batch = {"tokens": tokens[:, :24], "labels": tokens[:, 1:25],
             "frontend": _frontend(2)}
    want, _ = jax.jit(ref.loss_fn)(_jp(np_params),
                                   jax.tree.map(jnp.asarray, batch))
    got, _ = port.loss_fn(params, _t(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,s,gqa", [("float32", 16, False),
                                         ("float32", 17, True),
                                         ("float32", 250, False),
                                         ("bfloat16", 16, False)])
def test_prefill_and_four_decode_steps_match_reference(
        shared_params, gqa_params, tokens, dtype, s, gqa):
    """Prefill behind the 8-patch prefix (pos and the last-token logits
    count it; 8 + 250 pads to 512) and four decode steps continuing
    after it: logits, caches (the pads' and the 64 decode slots
    included) and pos after each."""
    np_params, params = gqa_params if gqa else shared_params
    kw = {"n_kv_heads": 2} if gqa else {}
    ref, port = _models(dtype, **kw)
    jparams = _jp(np_params)
    fe = _frontend(2)
    want_logits, want = jax.jit(ref.prefill_fn)(jparams, {
        "tokens": jnp.asarray(tokens[:, :s]), "frontend": jnp.asarray(fe)})
    logits, state = port.prefill_fn(params, {
        "tokens": torch.tensor(tokens[:, :s]), "frontend": torch.tensor(fe)})
    tol = TOL[dtype]
    n_prefix = port.config.frontend_len
    _close(logits, want_logits, tol, "prefill logits")
    assert state["pos"] == n_prefix + s - 1
    assert state["cache"]["k"].shape[2] == transformer._pad_len(
        n_prefix + s) + transformer.PREFILL_CACHE_MARGIN
    _check_state(state, want, tol, "prefill")
    ref_step = jax.jit(ref.decode_fn)
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        want_logits, want = ref_step(jparams, want,
                                     {"token": jnp.asarray(tok)})
        logits, state = port.decode_fn(params, state,
                                       {"token": torch.tensor(tok)})
        _close(logits, want_logits, tol, f"decode step {i}")
        assert state["pos"] == n_prefix + s + i
        _check_state(state, want, tol, f"decode step {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 300 - 9])
def test_prefill_plus_decode_equals_longer_prefill(shared_params, tokens,
                                                   dtype, n):
    """``tests/test_serve_consistency.py``'s property behind the prefix:
    prefill(t[:n]) + decode(t[n]) against prefill(t[:n + 1]) within its
    rtol = atol = 3e-2, greedy tokens equal outside its drift band."""
    _, params = shared_params
    _, port = _models(dtype)
    t = torch.tensor(tokens[:, :n + 1])
    fe = torch.tensor(_frontend(2))
    longer, _ = port.prefill_fn(params, {"tokens": t, "frontend": fe})
    _, state = port.prefill_fn(params, {"tokens": t[:, :n], "frontend": fe})
    stepped, _ = port.decode_fn(params, state, {"token": t[:, n:n + 1]})
    a, b = longer[:, -1].float().numpy(), stepped[:, -1].float().numpy()
    np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)
    for r in range(a.shape[0]):
        gap = np.sort(a[r])[-1] - np.sort(a[r])[-2]
        if gap > 6e-2:
            assert a[r].argmax() == b[r].argmax(), (r, gap)
        else:
            assert a[r].max() - a[r][b[r].argmax()] <= 6e-2, (r, gap)
    if dtype == "float32":
        _close(stepped[:, -1], a, F32, "float32 prefill + decode")


# ---------------------------------------------------------------------------
# the wave scheduler
# ---------------------------------------------------------------------------
def _serial(model, params, toks, max_new, frontend):
    sched = WaveScheduler(model, params, max_batch=1, frontend=frontend)
    r = Request(rid=0, tokens=toks, max_new_tokens=max_new)
    sched.submit(r)
    sched.run()
    return r.output


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batched_equals_serial(shared_params, dtype):
    """Five requests in waves of 3 and 2 (lengths 12 and 20), one stub
    frontend for all: each request's tokens equal its batch-1 serial
    run's."""
    _, params = shared_params
    _, model = _models(dtype)
    fe = _frontend(1)[0]
    rng = np.random.default_rng(5)
    sched = WaveScheduler(model, params, max_batch=3, frontend=fe)
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
            r.output, _serial(model, params, r.tokens, r.max_new_tokens, fe))


def test_scheduler_matches_the_reference_scheduler(shared_params):
    """The same requests and frontend through both schedulers (float32,
    greedy): the same waves, stops and tokens."""
    np_params, params = shared_params
    ref, port = _models("float32")
    fe = _frontend(1)[0]
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 512, 8 + 4 * (i % 2)).astype(np.int32)
            for i in range(5)]
    ours = WaveScheduler(port, params, max_batch=2, frontend=fe)
    theirs = RefScheduler(ref, _jp(np_params), max_batch=2, frontend=fe)
    for i, t in enumerate(toks):
        ours.submit(Request(rid=i, tokens=t, max_new_tokens=3 + i % 3))
        theirs.submit(RefRequest(rid=i, tokens=t, max_new_tokens=3 + i % 3))
    got, want = ours.run(), theirs.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want, strict=True):
        assert (g.wave, g.latency_steps) == (w.wave, w.latency_steps)
        np.testing.assert_array_equal(g.output, w.output)
    for key in ("waves", "decode_slot_steps", "mean_occupancy"):
        assert ours.summary()[key] == theirs.summary()[key]


def test_scheduler_needs_a_frontend(shared_params):
    _, params = shared_params
    _, model = _models("float32")
    sched = WaveScheduler(model, params, max_batch=2)
    sched.submit(Request(rid=0, tokens=np.arange(6, dtype=np.int32),
                         max_new_tokens=2))
    with pytest.raises(ValueError, match="vlm serving needs frontend"):
        sched.run()


# ---------------------------------------------------------------------------
# federated data, rounds and the launchers
# ---------------------------------------------------------------------------
def test_federated_lm_dataset_keys():
    """The port's twin of
    ``tests/test_checkpoint_data.py::test_federated_lm_dataset_keys``,
    and its batches equal the reference's bit for bit."""
    cfg = get_config(ARCH).reduced()
    data = make_federated_dataset(cfg, n_clients=5, seed=0, seq_len=8)
    assert isinstance(data, FederatedLMDataset)
    b = data.client_batch(2, 4, 0)
    assert set(b) == {"tokens", "labels", "frontend"}
    assert b["frontend"].shape == (4, cfg.frontend_len,
                                   cfg.frontend_dim or cfg.d_model)
    assert b["frontend"].dtype == np.float32
    w = data.client_weights()
    assert w.sum() == pytest.approx(1.0)
    want = ref_make_dataset(ref_get_config(ARCH).reduced(), n_clients=5,
                            seed=0, seq_len=8)
    for got, ref in ((b, want.client_batch(2, 4, 0)),
                     (data.eval_batch(3), want.eval_batch(3))):
        assert set(got) == set(ref)
        for k in got:
            assert np.array_equal(got[k], ref[k]), k


def test_federated_rounds_match_reference():
    """Reduced llava-next-mistral-7b (float32) in both batched engines, 7
    clients, 3 rounds of pso at seed 0, deterministic timing, the port
    started from the reference's initial params: placements and TPDs
    exactly, losses within rtol 1e-4, final params within rtol 1e-3 /
    atol 1e-5."""
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


def test_launch_train_federates_the_vlm_family_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    out = tmp_path / "rounds.json"
    assert main(["--arch", ARCH, "--clients", "7", "--rounds", "1",
                 "--local-steps", "1", "--batch-size", "2", "--out",
                 str(out)], device="cpu") == 0
    record = json.loads(out.read_text())
    assert record["summary"]["rounds"] == 1
    assert all(math.isfinite(r["loss"]) for r in record["rounds"])
    assert '"strategy": "pso"' in capsys.readouterr().out


@pytest.mark.parametrize("launcher", ["serve", "decode_step"])
def test_launchers_run_the_vlm_family_on_the_cpu(capsys, launcher):
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
