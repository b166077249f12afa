"""The dense transformer family (stablelm-1.6b, stablelm-3b, granite-8b,
minitron-8b) and its serving path: port vs reference on the CPU.

Both packages run ``stablelm-1.6b`` at ``reduced()`` (2 layers, d 256,
4 heads of 64, vocab 512), with the reference's params carried across by
``params_from_numpy``. The port's flash kernel runs as its plain torch
version here (CPU tensors). GQA needs ``.replace(n_kv_heads=2)``:
``reduced()`` keeps as many kv heads as heads.

Tolerances (as ``tests/test_torch_hybrid.py``): float32 runs
(``dtype="float32"``) at rtol = atol = 1e-4 (XLA and torch sum the
products and the softmax in other orders); bfloat16 runs (the config's
own ``dtype``) at rtol 0.05, atol 0.15 (bfloat16 roundings taken at
other points by XLA's fusion and torch's per-op rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_common
from repro.models import get_model as ref_get_model
from repro.models.api import make_serve_step as ref_make_serve_step
from repro.serving import Request as RefRequest
from repro.serving import WaveScheduler as RefScheduler
from repro.utils import trees as ref_trees
from repro_torch.configs import get_config
from repro_torch.core.state import params_from_numpy
from repro_torch.models import UNSHARDED, get_model, make_serve_step
from repro_torch.models import common
from repro_torch.models import transformer as port_transformer
from repro_torch.models.sharding import ShardingPolicy, shard_hint
from repro_torch.serving import Request, WaveScheduler
from repro_torch.utils import trees

DENSE = ("stablelm-1.6b", "stablelm-3b", "granite-8b", "minitron-8b")
ARCH = "stablelm-1.6b"
_PARAM_STREAM = 3            # reference init key of the shared params
_TOKEN_STREAM = 0
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
TOL = {"float32": F32, "bfloat16": BF16}
LENGTHS = (16, 17, 300)      # even, odd (padded to 18), >= 256 (to 512)


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


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the reduced models' ops are too small
    to gain from more, and spinning thread teams slow many fold when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def shared_params():
    return _ref_params()


@pytest.fixture(scope="session")
def gqa_params():
    return _ref_params(n_kv_heads=2)


@pytest.fixture(scope="session")
def tokens():
    return np.random.default_rng(_TOKEN_STREAM).integers(
        0, 512, (2, max(LENGTHS) + 5)).astype(np.int32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


# ---------------------------------------------------------------------------
# configs, registry, helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE + ("granite-moe-1b-a400m",
                                          "qwen3-moe-235b-a22b"))
def test_configs_are_copied_field_for_field(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(ref_get_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(ref_get_config(name).reduced())


@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_other_lm_families_still_raise(name):
    """The vlm and audio configs are carried field for field (their
    models: tests/test_torch_vlm.py, tests/test_torch_encdec.py); only an
    unknown name raises."""
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(ref_get_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(ref_get_config(name).reduced())
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config(name + "-x")


@pytest.mark.parametrize("name", DENSE)
def test_init_layout_matches_reference(name):
    """Same tree, shapes and dtypes as the reference's init, the layers
    stacked on a leading n_layers dim."""
    ref_cfg = ref_get_config(name).reduced()
    cfg = get_config(name).reduced()
    want = jax.eval_shape(ref_get_model(ref_cfg).init, jax.random.key(0))
    got = get_model(cfg, UNSHARDED, window=None).init(
        torch.Generator().manual_seed(0), "cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = trees.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got, strict=True):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


def test_common_helpers_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    table = rng.normal(size=(24, 16)).astype(np.float32)
    ffn = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in (
        ("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    mlp = {"w_up": ffn["w_up"], "w_down": ffn["w_down"]}
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}  # noqa: E731
    for got, want in (
            (common.unembed({"table": torch.tensor(table)}, torch.tensor(x)),
             ref_common.unembed({"table": table}, x)),
            (common.swiglu(t(ffn), torch.tensor(x)),
             ref_common.swiglu(ffn, x)),
            (common.gelu_mlp(t(mlp), torch.tensor(x)),
             ref_common.gelu_mlp(mlp, x))):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, dict(rtol=1e-5, atol=1e-5), "helper")
    # bf16 activations x f32 params promote to f32, as jnp.einsum does
    xb = torch.tensor(x).bfloat16()
    assert common.swiglu(t(ffn), xb).dtype == torch.float32
    init = common.init_mlp(torch.Generator().manual_seed(0), 16, 32,
                           torch.float32, "cpu")
    shapes = jax.eval_shape(lambda k: ref_common.init_mlp(k, 16, 32,
                                                          jnp.float32),
                            jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}


def test_tree_helpers_match_reference():
    tree = {"a": torch.ones(2, 3), "b": [torch.arange(4.0)]}
    z = trees.tree_zeros_like(tree)
    ref_z = ref_trees.tree_zeros_like(
        jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree))
    assert all(torch.equal(a, torch.tensor(np.asarray(b)))
               for a, b in zip(trees.tree_leaves(z),
                               jax.tree.leaves(ref_z), strict=True))
    c = trees.tree_cast(tree, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in trees.tree_leaves(c))
    stacked = trees.tree_stack([tree, z])
    assert tuple(stacked["a"].shape) == (2, 2, 3)
    back = trees.tree_unstack(stacked)
    assert torch.equal(back[0]["b"][0], tree["b"][0])
    assert torch.equal(back[1]["a"], z["a"])


def test_unsharded_policy_hints_are_no_ops():
    x = torch.ones(2, 3)
    assert shard_hint(x, UNSHARDED, "batch", None) is x

    class _Mesh:
        shape = {"data": 1, "model": 4}
        axis_names = ("data", "model")

        def axis_index(self, axis):
            return 0

    # on a mesh a hint returns the tensor its rank already lays out
    # (tests/test_torch_sharding.py holds the resolution to the
    # reference's); a mis-ranked hint raises, as the reference's
    meshed = ShardingPolicy(mesh=_Mesh(), model_axis="model")
    assert shard_hint(x, meshed, "batch", None) is x
    with pytest.raises(ValueError, match="rank mismatch"):
        shard_hint(x, meshed, "batch")
    # the layouts still to port name their item when run (the dense
    # family runs fsdp: tests/test_torch_fsdp.py)
    fsdp = ShardingPolicy(mesh=_Mesh(), model_axis="model",
                          fsdp_axes=("data",))
    with pytest.raises(NotImplementedError, match="item 12b-1b-2b"):
        get_model(get_config("xlstm-1.3b").reduced(),
                  fsdp).loss_fn(None, None)
    # the hybrid family's runs (tests/test_torch_hybrid_tp.py): its init
    # on this rank of the mesh keeps the rank's shards
    local = get_model(get_config("recurrentgemma-2b").reduced(),
                      fsdp).init(None, "meta")
    assert tuple(local["tail"]["w_main"].shape) == (2, 256, 64)
    assert tuple(local["tail"]["conv_w"].shape) == (2, 4, 256)
    assert tuple(local["lm_head"]["proj"].shape) == (256, 128)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(shared_params, tokens, remat):
    np_params, params = shared_params
    ref, port = _models("float32", remat=remat)
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:33]}
    (want, _), want_g = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        _jp(np_params), jax.tree.map(jnp.asarray, batch))
    leaves, rebuild = trees.tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    got, metrics = port.loss_fn(rebuild(live), {
        k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, live)
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["xent"].detach()) == float(got)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_g)[0],
                            grads, strict=True):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-6)
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-4 * scale + 1e-6, (path, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_reference_with_window_and_padding(shared_params,
                                                        tokens, dtype):
    """A 17-token batch (padded to 18) under window 8."""
    np_params, params = shared_params
    ref, port = _models(dtype, window=8)
    batch = {"tokens": tokens[:, :17], "labels": tokens[:, 1:18]}
    want, _ = jax.jit(ref.loss_fn)(_jp(np_params),
                                   jax.tree.map(jnp.asarray, batch))
    got, _ = port.loss_fn(params, {k: torch.tensor(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _check_state(state, want, tol):
    assert state["pos"] == int(want["pos"])
    for key in ("k", "v"):
        got = state["cache"][key]
        assert tuple(got.shape) == tuple(want["cache"][key].shape), key
        _close(got, want["cache"][key], tol, f"cache/{key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_prefill_matches_reference(shared_params, tokens, dtype, s):
    """Logits, caches (the pads' keys and values and the 64 decode slots
    included) and pos, at an even, an odd and a >= 256-token prompt."""
    np_params, params = shared_params
    ref, port = _models(dtype)
    want_logits, want = jax.jit(ref.prefill_fn)(
        _jp(np_params), {"tokens": jnp.asarray(tokens[:, :s])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :s])})
    assert tuple(logits.shape) == tuple(want_logits.shape)
    _close(logits, want_logits, TOL[dtype], "logits")
    assert state["pos"] == s - 1
    assert state["cache"]["k"].shape[2] == \
        port_transformer._pad_len(s) + port_transformer.PREFILL_CACHE_MARGIN
    _check_state(state, want, TOL[dtype])


@pytest.mark.parametrize("s", [17, 40])
def test_windowed_prefill_matches_reference(shared_params, tokens, s):
    np_params, params = shared_params
    ref, port = _models("float32", window=8)
    want_logits, want = jax.jit(ref.prefill_fn)(
        _jp(np_params), {"tokens": jnp.asarray(tokens[:, :s])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :s])})
    _close(logits, want_logits, F32, "logits")
    _check_state(state, want, F32)
    # the window is in force: without it the logits move
    full, _ = _models("float32")[1].prefill_fn(
        params, {"tokens": torch.tensor(tokens[:, :s])})
    assert float((full - logits).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_prefill_and_decode_match_reference(gqa_params, tokens, dtype):
    np_params, params = gqa_params
    ref, port = _models(dtype, n_kv_heads=2)
    want_logits, want = jax.jit(ref.prefill_fn)(
        _jp(np_params), {"tokens": jnp.asarray(tokens[:, :24])})
    logits, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :24])})
    _close(logits, want_logits, TOL[dtype], "prefill logits")
    assert state["cache"]["k"].shape[3] == 2
    _check_state(state, want, TOL[dtype])
    want_step, want = jax.jit(ref.decode_fn)(
        _jp(np_params), want, {"token": jnp.asarray(tokens[:, 24:25])})
    step, state = port.decode_fn(params, state, {
        "token": torch.tensor(tokens[:, 24:25])})
    _close(step, want_step, TOL[dtype], "decode logits")
    _check_state(state, want, TOL[dtype])


@pytest.mark.parametrize("s", [16, 300])
def test_four_decode_steps_match_reference(shared_params, tokens, s):
    """Four tokens decoded through each package's serve step from its own
    prefill state: logits, caches and pos after every step."""
    np_params, params = shared_params
    ref, port = _models("float32")
    jparams = _jp(np_params)
    _, want = jax.jit(ref.prefill_fn)(jparams, {
        "tokens": jnp.asarray(tokens[:, :s])})
    _, state = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :s])})
    ref_step = jax.jit(ref_make_serve_step(ref))
    step = make_serve_step(port)
    for i in range(4):
        tok = tokens[:, s + i:s + i + 1]
        want_logits, want = ref_step(jparams, want,
                                     {"token": jnp.asarray(tok)})
        logits, new = step(params, state, {"token": torch.tensor(tok)})
        assert new["cache"]["k"] is state["cache"]["k"]   # written in place
        state = new
        _close(logits, want_logits, F32, f"decode step {i}")
        assert state["pos"] == s + i
        _check_state(state, want, F32)


def test_init_decode_state_matches_reference():
    ref, port = _models("bfloat16")
    want = ref.init_decode_state(3, 40)
    got = port.init_decode_state(3, 40, "cpu")
    assert got["pos"] == int(want["pos"]) == 39
    for key in ("k", "v"):
        assert tuple(got["cache"][key].shape) == \
            tuple(want["cache"][key].shape)
        assert got["cache"][key].dtype == torch.bfloat16
        assert not got["cache"][key].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 300])
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


def test_tied_embeddings_match_reference(tokens):
    """``tie_embeddings=True`` (no lm_head; logits from the embedding
    table) through prefill and the loss."""
    np_params, params = _ref_params(tie_embeddings=True)
    assert "lm_head" not in params
    ref, port = _models("float32", tie_embeddings=True)
    want, _ = jax.jit(ref.prefill_fn)(_jp(np_params), {
        "tokens": jnp.asarray(tokens[:, :20])})
    got, _ = port.prefill_fn(params, {"tokens": torch.tensor(
        tokens[:, :20])})
    _close(got, want, F32, "tied logits")


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
def test_batched_equals_serial(shared_params, dtype):
    _, params = shared_params
    _, model = _models(dtype)
    rng = np.random.default_rng(5)
    sched = WaveScheduler(model, params, max_batch=3)
    reqs = []
    for rid in range(5):           # two buckets: lengths 12 and 20
        plen = 12 if rid % 2 == 0 else 20
        r = Request(rid=rid, tokens=rng.integers(0, 512, plen).astype(np.int32),
                    max_new_tokens=6)
        reqs.append(r)
        sched.submit(r)
    assert len(sched.run()) == 5
    assert [s.batch for s in sched.stats] == [3, 2]
    for r in reqs:
        np.testing.assert_array_equal(
            r.output, _serial(model, params, r.tokens, r.max_new_tokens))


def test_scheduler_matches_the_reference_scheduler(shared_params):
    """The same requests through both schedulers (float32, greedy): the
    same waves, stops and tokens (the dense decode writes at pos + 1 in
    both packages)."""
    np_params, params = shared_params
    ref, port = _models("float32")
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, 512, 8 + 4 * (i % 2)).astype(np.int32)
            for i in range(5)]
    ours = WaveScheduler(port, params, max_batch=2)
    theirs = RefScheduler(ref, _jp(np_params), max_batch=2)
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


def test_launch_serve_runs_the_dense_default_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--new-tokens", "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "arch=stablelm-1.6b (reduced)" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b"])
def test_launch_decode_step_times_a_reduced_model_on_the_cpu(capsys, arch):
    from repro_torch.launch.decode_step import main
    assert main(["--arch", arch, "--reduced", "--batch", "2", "--prompt",
                 "16"], device="cpu") == 0
    out = capsys.readouterr().out
    assert f"{arch} (reduced) decode step, batch 2 after 16 tokens" in out
    assert "(median of 20)" in out and "finite logits True [cpu]" in out
