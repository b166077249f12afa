"""The audio family (seamless-m4t-large-v2): the port's ``models/encdec.py``
and its serving and federated paths against the reference on the CPU.

Both packages run ``seamless-m4t-large-v2`` at ``reduced()`` (2 encoder
and 2 decoder layers, d 256, 4 heads of 64, d_ff 1024, vocab 512, a
stub frontend of 8 frames x 256), with the reference's params carried
across by ``params_from_numpy``; tokens and frontends come from numpy
seeds. The encoder's bidirectional attention and the decoder's causal
attention run the flash kernel's plain version here (CPU tensors); the
cross-attention is plain torch ops in both packages. GQA needs
``.replace(n_kv_heads=2)``: ``reduced()`` keeps as many kv heads as
heads.

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
from repro.models import encdec as ref_encdec
from repro.models import get_model as ref_get_model
from repro.serving import Request as RefRequest
from repro.serving import WaveScheduler as RefScheduler
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data import make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import attention as attn_lib
from repro_torch.models import encdec, get_model
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils import trees

ARCH = "seamless-m4t-large-v2"
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


def _models(dtype, window=None, **kw):
    ref_cfg, cfg = _cfgs(dtype, **kw)
    return (ref_get_model(ref_cfg, window=window),
            get_model(cfg, window=window))


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
        0, 512, (2, 40)).astype(np.int32)


def _frontend(b, cfg=None, seed=_FRONTEND_STREAM):
    cfg = cfg or get_config(ARCH).reduced()
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
    for part in ("self", "cross"):
        for key in ("k", "v"):
            got = state[part][key]
            assert tuple(got.shape) == tuple(want[part][key].shape), \
                (what, part, key)
            _close(got, want[part][key], tol, f"{what} {part}/{key}")


# ---------------------------------------------------------------------------
# config, registry, init
# ---------------------------------------------------------------------------
def test_config_is_copied_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(ref_get_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert cfg.is_encoder_decoder and cfg.family == "audio"
    assert cfg.padded_vocab == 256_256


def test_init_layout_matches_reference():
    """Same tree, shapes and dtypes as the reference's init: encoder and
    decoder layers stacked on a leading dim."""
    ref_cfg, cfg = _cfgs("bfloat16")
    want = jax.eval_shape(ref_get_model(ref_cfg).init, jax.random.key(0))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = trees.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    assert got["encoder"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    assert got["decoder"]["cross_attn"]["wk"].shape[0] == cfg.n_layers


def test_init_decode_state_matches_reference():
    ref, port = _models("bfloat16")
    want = ref.init_decode_state(3, 40)
    got = port.init_decode_state(3, 40, "cpu")
    assert got["pos"] == int(want["pos"]) == 39
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tuple(got[part][key].shape) == \
                tuple(want[part][key].shape)
            assert got[part][key].dtype == torch.bfloat16
            assert not got[part][key].any()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,hq,hkv", [(2, 5, 9, 4, 4), (3, 7, 4, 4, 2),
                                            (1, 1, 12, 6, 3), (2, 1, 8, 4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_reference(b, sq, sk, hq, hkv, dtype):
    """Queries over keys of another length (the cross-attention), GQA
    groups of 1-4, one sequence at a time and a single position: the
    reference's ``_bidir_attention``."""
    rng = np.random.default_rng(sq * 10 + sk)
    q, k, v = (rng.normal(size=(b, s, h, 16)).astype(np.float32)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    jdt = jnp.dtype(dtype)
    want = ref_encdec._bidir_attention(*(jnp.asarray(x, jdt)
                                         for x in (q, k, v)))
    got = attn_lib.dense_attention(*(torch.tensor(x).to(getattr(
        torch, dtype)) for x in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32 if dtype == "float32" else
           dict(rtol=1e-2, atol=1e-2), "dense attention")
    # batched == each sequence alone, bit for bit
    alone = torch.cat([attn_lib.dense_attention(
        *(torch.tensor(x[i:i + 1]).to(getattr(torch, dtype))
          for x in (q, k, v))) for i in range(b)])
    assert torch.equal(got, alone)
    with pytest.raises(ValueError):
        attn_lib.dense_attention(torch.tensor(q), torch.tensor(k)[:, :, :1]
                                 .repeat(1, 1, 5, 1), torch.tensor(v))


def test_bidirectional_attention_matches_reference():
    """The encoder's self-attention (the flash kernel's plain version
    with ``causal=False`` here) against the reference's dense one."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 11, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = ref_encdec._bidir_attention(*(jnp.asarray(x) for x in (q, k, v)))
    got = attn_lib.bidirectional_attention(*(torch.tensor(x)
                                             for x in (q, k, v)))
    _close(got, want, F32, "bidirectional attention")
    causal = attn_lib.causal_attention(*(torch.tensor(x) for x in (q, k, v)))
    assert float((causal - got).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="aligned"):
        attn_lib.bidirectional_attention(torch.tensor(q)[:, :5],
                                         torch.tensor(k), torch.tensor(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(shared_params, dtype):
    np_params, params = shared_params
    ref_cfg, cfg = _cfgs(dtype)
    fe = _frontend(2)
    want = ref_encdec.encode(_jp(np_params), jnp.asarray(fe), ref_cfg)
    got = encdec.encode(params, torch.tensor(fe), cfg)
    assert got.dtype == torch.float32
    _close(got, want, TOL[dtype], "encoder output")


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
    """float32, (2, 24) tokens over 8 frames: the loss and every
    gradient (encoder, cross-attention, decoder), each within 1e-4 of its
    largest value, with and without remat."""
    np_params, params = shared_params
    ref, port = _models("float32", remat=remat)
    batch = {"tokens": tokens[:, :24], "labels": tokens[:, 1:25],
             "frontend": _frontend(2)}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
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


@pytest.mark.parametrize("window", [None, 8])
def test_bf16_loss_matches_reference(shared_params, tokens, window):
    """The config's bf16 compute; under window 8 the decoder's
    self-attention is sliding-window (the encoder's stays full)."""
    np_params, params = shared_params
    ref, port = _models("bfloat16", window=window)
    batch = {"tokens": tokens[:, :21], "labels": tokens[:, 1:22],
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
                                         ("bfloat16", 16, False)])
def test_prefill_and_four_decode_steps_match_reference(
        shared_params, gqa_params, tokens, dtype, s, gqa):
    """Prefill (the self caches with their 64 decode slots, the cross
    keys and values, pos) and four decode steps through each package's
    own state: logits and state after each."""
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
    assert tuple(logits.shape) == tuple(want_logits.shape)
    _close(logits, want_logits, tol, "prefill logits")
    assert state["pos"] == s - 1
    assert state["self"]["k"].shape[2] == s + encdec.CACHE_MARGIN
    _check_state(state, want, tol, "prefill")
    ref_step = jax.jit(ref.decode_fn)
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        want_logits, want = ref_step(jparams, want,
                                     {"token": jnp.asarray(tok)})
        logits, new = port.decode_fn(params, state,
                                     {"token": torch.tensor(tok)})
        assert new["self"]["k"] is state["self"]["k"]   # written in place
        state = new
        _close(logits, want_logits, tol, f"decode step {i}")
        assert state["pos"] == s + i
        _check_state(state, want, tol, f"decode step {i}")


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
    with pytest.raises(ValueError, match="audio serving needs frontend"):
        sched.run()


# ---------------------------------------------------------------------------
# federated rounds and the launchers
# ---------------------------------------------------------------------------
def test_federated_rounds_match_reference():
    """Reduced seamless-m4t-large-v2 (float32) in both batched engines, 7
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


def test_launch_train_federates_the_audio_family_on_the_cpu(tmp_path,
                                                           capsys):
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
def test_launchers_run_the_audio_family_on_the_cpu(capsys, launcher):
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


def test_launch_serve_batch_is_the_reference_batch(monkeypatch):
    """``launch/serve.py`` draws the frontend after the prompt from the
    same numpy generator, as the reference's: the prefill batch is
    bit-identical to the one the reference builds."""
    from repro_torch.launch import serve
    seen = {}
    real = get_model

    def spy(cfg, *a, **kw):
        model = real(cfg, *a, **kw)
        prefill = model.prefill_fn

        def wrapped(params, batch):
            seen.update({k: v.clone() for k, v in batch.items()})
            return prefill(params, batch)
        return dataclasses.replace(model, prefill_fn=wrapped)

    monkeypatch.setattr(serve, "get_model", spy)
    assert serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "5",
                       "--new-tokens", "1", "--seed", "4"], device="cpu") == 0
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 5))
    front = np.asarray(jnp.asarray(rng.normal(
        scale=0.02, size=(2, cfg.frontend_len, cfg.d_model)), jnp.float32))
    assert np.array_equal(seen["tokens"].numpy(), prompt)
    assert np.array_equal(seen["frontend"].numpy(), front)
