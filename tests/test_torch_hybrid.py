"""The hybrid family (recurrentgemma-2b) and its serving path: port vs
reference on the CPU.

Both packages run ``recurrentgemma-2b`` at ``reduced().replace(n_layers=5)``
(one (r, r, a) triple and two trailing recurrent blocks, so a
local-attention block runs; plain ``reduced()`` has none), with the
reference's params carried across by ``params_from_numpy``. The port's
kernels run as their plain torch versions here (CPU tensors).

Where the port parts from the reference on purpose (ROADMAP.md §3,
"Faults found"): the reference's decode writes the new token at
``state["pos"]`` (the last prompt token's position) and its prefill
sizes the ring cache ``min(window, S)``; the port decodes at ``pos + 1``
into a ``window``-slot ring. Prefill (logits and states) is held to the
reference; decode to the reference's decode fed ``pos + 1`` where that
is right (a prompt at least a window long); and the port's
``prefill(t[:n]) + decode(t[n])`` to its own ``prefill(t[:n+1])``.

Tolerances: float32 runs (``dtype="float32"``) at rtol = atol = 1e-4 on
logits of scale ~3 (XLA and torch sum the matrix products, the softmax
and the log-depth vs sequential scans in other orders); bfloat16 runs
(the config's own ``dtype``) at atol 0.15, rtol 0.05, the drift of
bfloat16 roundings taken at other points by XLA's excess-precision
fusion and torch's per-op rounding over five blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.serving import Request as RefRequest
from repro.serving import WaveScheduler as RefScheduler
from repro_torch.configs import get_config
from repro_torch.core.state import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils.trees import tree_leaves

_PARAM_STREAM = 3            # reference init key of the shared params
_TOKEN_STREAM = 0
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
TOL = {"float32": F32, "bfloat16": BF16}
WINDOW = 64                  # reduced()'s local_attn_window
SHORT, LONG = 24, 72         # prompts shorter and longer than the window


def _cfgs(dtype, **kw):
    ref = ref_get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype=dtype, **kw)
    port = get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype=dtype, **kw)
    return ref, port


@pytest.fixture(scope="module")
def shared_params():
    ref_cfg, _ = _cfgs("float32")
    np_params = jax.tree.map(np.asarray, ref_get_model(ref_cfg).init(
        jax.random.key(_PARAM_STREAM)))
    return np_params, params_from_numpy(np_params, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(_TOKEN_STREAM).integers(
        0, 512, (2, LONG + 1)).astype(np.int32)


def _models(dtype, **kw):
    ref_cfg, cfg = _cfgs(dtype, **kw)
    return ref_get_model(ref_cfg), get_model(cfg)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def test_config_is_copied_field_for_field():
    assert dataclasses.asdict(get_config("recurrentgemma-2b")) == \
        dataclasses.asdict(ref_get_config("recurrentgemma-2b"))


@pytest.mark.parametrize("n_layers", [5, 2])
def test_init_layout_matches_reference(n_layers):
    """Same tree, shapes and dtypes as the reference's init (2 layers:
    no triple, two trailing blocks)."""
    ref_cfg = ref_get_config("recurrentgemma-2b").reduced().replace(
        n_layers=n_layers)
    cfg = get_config("recurrentgemma-2b").reduced().replace(n_layers=n_layers)
    want = jax.eval_shape(ref_get_model(ref_cfg).init, jax.random.key(0))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [SHORT, LONG])
def test_prefill_matches_reference(shared_params, tokens, dtype, s):
    np_params, params = shared_params
    ref, port = _models(dtype)
    want_logits, want = jax.jit(ref.prefill_fn)(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tokens[:, :s])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :s])})
    tol = TOL[dtype]
    assert tuple(logits.shape) == tuple(want_logits.shape)
    _close(logits, want_logits, tol, "logits")
    assert state["pos"] == int(want["pos"]) == s - 1
    for blk in ("rec1", "rec2"):
        for key in ("h", "conv"):
            _close(state["triples"][blk][key], want["triples"][blk][key],
                   tol, f"{blk}/{key}")
    for key in ("h", "conv"):
        _close(state["tail"][key], want["tail"][key], tol, f"tail/{key}")
    # the ring caches: the port's has WINDOW slots; the reference's
    # min(WINDOW, s), the same slots where both have them
    for key in ("k", "v"):
        got = state["triples"]["attn"][key]
        assert got.shape[2] == WINDOW
        ref_cache = np.asarray(want["triples"]["attn"][key], np.float32)
        n = ref_cache.shape[2]
        _close(got[:, :, :n], ref_cache, tol, f"cache/{key}")
        assert not got[:, :, n:].any()


def test_decode_matches_reference_fed_the_next_position(shared_params,
                                                        tokens):
    """A prompt longer than the window, where the reference's ring cache
    is a full window: the reference's decode, given ``pos + 1``, is the
    port's decode."""
    np_params, params = shared_params
    ref, port = _models("float32")
    jparams = jax.tree.map(jnp.asarray, np_params)
    _, ref_state = jax.jit(ref.prefill_fn)(
        jparams, {"tokens": jnp.asarray(tokens[:, :LONG])})
    ref_state = dict(ref_state, pos=ref_state["pos"] + 1)
    want_logits, want = jax.jit(ref.decode_fn)(
        jparams, ref_state, {"token": jnp.asarray(tokens[:, LONG:LONG + 1])})
    _, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :LONG])})
    logits, new_state = port.decode_fn(
        params, state, {"token": torch.tensor(tokens[:, LONG:LONG + 1])})
    _close(logits, want_logits, F32, "decode logits")
    assert new_state["pos"] == int(want["pos"]) - 1 == LONG
    for key in ("k", "v"):
        _close(new_state["triples"]["attn"][key], want["triples"]["attn"][key],
               F32, f"cache/{key}")
    _close(new_state["triples"]["rec2"]["h"], want["triples"]["rec2"]["h"],
           F32, "rec2/h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [SHORT, LONG])
def test_prefill_plus_decode_equals_longer_prefill(shared_params, tokens,
                                                   dtype, n):
    _, params = shared_params
    _, port = _models(dtype)
    t = torch.tensor(tokens[:, :n + 1])
    longer, _ = port.prefill_fn(params, {"tokens": t})
    _, state = port.prefill_fn(params, {"tokens": t[:, :n]})
    stepped, _ = port.decode_fn(params, state, {"token": t[:, n:n + 1]})
    _close(stepped[:, -1], longer[:, -1].numpy(), TOL[dtype],
           "prefill + decode vs the longer prefill")
    if dtype == "float32":
        assert torch.equal(stepped.argmax(-1), longer.argmax(-1))


def _ref_gap(ref, jparams, toks, n, shift):
    prefill, decode = jax.jit(ref.prefill_fn), jax.jit(ref.decode_fn)
    _, st = prefill(jparams, {"tokens": toks[:, :n]})
    if shift:
        st = dict(st, pos=st["pos"] + 1)
    stepped, _ = decode(jparams, st, {"token": toks[:, n:n + 1]})
    longer, _ = prefill(jparams, {"tokens": toks[:, :n + 1]})
    return float(jnp.max(jnp.abs(stepped[:, -1] - longer[:, -1])))


def test_reference_serving_faults_and_the_port_fix(shared_params, tokens):
    """The two reference faults the port does not carry over, at a
    17-token prompt: (1) with window 8 (< prompt) the reference's decode
    is off by one position, which ``pos + 1`` repairs exactly; (2) with
    window 64 (> prompt) its ring cache has no free slot, so even
    ``pos + 1`` evicts position 0. The port is right in both."""
    np_params, params = shared_params
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = jnp.asarray(tokens[:, :18])
    n = 17
    ref8, port8 = _models("float32", local_attn_window=8)
    assert _ref_gap(ref8, jparams, toks, n, shift=False) > 1e-2
    assert _ref_gap(ref8, jparams, toks, n, shift=True) < 1e-4
    ref64, port64 = _models("float32")
    assert _ref_gap(ref64, jparams, toks, n, shift=True) > 1e-2
    t = torch.tensor(tokens[:, :18])
    for port in (port8, port64):
        longer, _ = port.prefill_fn(params, {"tokens": t})
        _, st = port.prefill_fn(params, {"tokens": t[:, :n]})
        stepped, _ = port.decode_fn(params, st, {"token": t[:, n:n + 1]})
        _close(stepped[:, -1], longer[:, -1].numpy(), F32, "port")


def test_loss_matches_reference(shared_params, tokens):
    np_params, params = shared_params
    ref, port = _models("float32")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    want, _ = jax.jit(ref.loss_fn)(jax.tree.map(jnp.asarray, np_params),
                                   jax.tree.map(jnp.asarray, batch))
    got, metrics = port.loss_fn(params, {k: torch.tensor(v)
                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["xent"]) == float(got)


# ---------------------------------------------------------------------------
# the wave scheduler
# ---------------------------------------------------------------------------
def _serial(model, params, toks, max_new):
    sched = WaveScheduler(model, params, max_batch=1)
    r = Request(rid=0, tokens=toks, max_new_tokens=max_new)
    sched.submit(r)
    sched.run()
    return r.output


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_logits_do_not_depend_on_the_rest_of_the_batch(shared_params,
                                                       tokens, dtype):
    """A sequence's prefill and decode logits are the same bits alone
    and inside a batch of three: the host's float32 products give a row
    other bits at M = 1 than at M = 3, which the model's fixed shapes
    (decode rows padded to a bucket, prefill per sequence) keep out."""
    _, params = shared_params
    _, model = _models(dtype)
    t = torch.tensor(np.concatenate([tokens, tokens[::-1, ::-1],
                                     tokens[:1] // 2]))[:, :30]
    outs = []
    for batch in (t[:1], t):
        logits, state = model.prefill_fn(params, {"tokens": batch[:, :29]})
        step, _ = model.decode_fn(params, state, {"token": batch[:, 29:]})
        outs.append((logits[0], step[0]))
    for alone, inside in zip(*outs, strict=True):
        assert torch.equal(alone, inside)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batched_equals_serial(shared_params, dtype):
    _, params = shared_params
    _, model = _models(dtype)
    rng = np.random.default_rng(5)
    sched = WaveScheduler(model, params, max_batch=3)
    reqs = []
    for rid in range(5):           # two buckets: lengths 12 and 70
        plen = 12 if rid % 2 == 0 else 70
        r = Request(rid=rid, tokens=rng.integers(0, 512, plen).astype(np.int32),
                    max_new_tokens=6)
        reqs.append(r)
        sched.submit(r)
    assert len(sched.run()) == 5
    assert [s.batch for s in sched.stats] == [3, 2]
    for r in reqs:
        np.testing.assert_array_equal(
            r.output, _serial(model, params, r.tokens, r.max_new_tokens))


def test_buckets_waves_and_stops_match_the_reference_scheduler(shared_params):
    """The same requests through both schedulers (float32, greedy): the
    same waves, EOS and budget stops, first tokens and summary counts.
    Later tokens part by design: they come from the reference's decode,
    which writes at the wrong position (the test above)."""
    np_params, params = shared_params
    ref, port = _models("float32")
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 512, 8).astype(np.int32) for _ in range(4)]
    first = _serial(port, params, toks[0], 1)[0]
    specs = [dict(rid=0, tokens=toks[0], max_new_tokens=5, eos_id=int(first)),
             dict(rid=1, tokens=toks[1], max_new_tokens=2),
             dict(rid=2, tokens=toks[2], max_new_tokens=3),
             dict(rid=3, tokens=toks[3], max_new_tokens=3)]
    ours = WaveScheduler(port, params, max_batch=2)
    theirs = RefScheduler(ref, jax.tree.map(jnp.asarray, np_params),
                          max_batch=2)
    for spec in specs:
        ours.submit(Request(**spec))
        theirs.submit(RefRequest(**spec))
    got, want = ours.run(), theirs.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert len(got[0].output) == 1              # stopped at EOS at once
    for g, w in zip(got, want, strict=True):
        assert (g.wave, g.latency_steps) == (w.wave, w.latency_steps)
        assert len(g.output) == len(w.output) and g.output[0] == w.output[0]
    s_ours, s_theirs = ours.summary(), theirs.summary()
    for key in ("waves", "decode_slot_steps", "mean_occupancy"):
        assert s_ours[key] == s_theirs[key]
