"""The port's training path against the reference's, on the CPU: the
train and grad steps, ``TrainLoop``, remat, resume and checkpoints.

Both packages train ``recurrentgemma-2b`` at ``reduced().replace(
n_layers=5)`` (one (r, r, a) triple and two trailing recurrent blocks,
so a local-attention block runs; plain ``reduced()`` has none) on
96-token sequences, longer than the reduced window of 64, so the
windowed attention path is differentiated too. The port starts from the
reference loop's initial params, carried across by
``params_from_numpy``; its kernels run as their plain torch versions
(CPU tensors), backward passes included.

Tolerances.
- Gradients (float32): within 2e-5 of each leaf's largest gradient
  (XLA and torch sum the products, the softmax and the scans in other
  orders; measured 4e-6).
- Losses over 5 steps of ``adamw(3e-3)``: rtol 1e-4 in float32
  (measured 5e-6), rtol 5e-3 in the config's own bfloat16 compute
  (measured 1.3e-3: bf16 roundings taken at other points).
- Params after those steps: rtol 1e-3, atol 1e-5 for all but 0.2% of
  the elements, and every element within 10 lr. Adam's first step moves
  a weight by lr * g / (|g| + eps), so a gradient within rounding of 0
  steps by +lr on one side and -lr on the other, and the gap feeds the
  next steps. It is not the port's: the reference against itself, with
  its initial params moved by one float32 ulp, leaves 1,885 of 5.68M
  elements outside rtol 1e-3 / atol 1e-5 after 5 steps (the worst 589
  times outside), the port 3,502 (594 times). In bfloat16 every element
  within 10 lr, and the whole update (final minus initial params) within
  10% in norm: bf16 gradients carry ~1% noise, which Adam passes on to
  every element's step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.data.synthetic import SyntheticLMDataset as RefLMDataset
from repro.models import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.train import TrainLoop as RefTrainLoop
from repro.train import TrainLoopConfig as RefTrainLoopConfig
from repro_torch.checkpoint.store import leaves_with_paths, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.state import params_from_numpy
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import get_model
from repro_torch.models.api import flat_params, make_grad_step, make_train_step
from repro_torch.optim import adamw
from repro_torch.train import TrainLoop, TrainLoopConfig
from repro_torch.utils.trees import flat_buffer_of, tree_leaves

_PARAM_STREAM = 0            # reference loop seed of the shared params
_DATA_STREAM = 0
SEQ, BATCH, STEPS, LR = 96, 2, 5, 3e-3
GRAD_TOL = 2e-5
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_OUTSIDE = 2e-3
BF16_UPDATE_RTOL = 0.1


def _cfgs(dtype, **kw):
    ref = ref_get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype=dtype, **kw)
    port = get_config("recurrentgemma-2b").reduced().replace(
        n_layers=5, dtype=dtype, **kw)
    return ref, port


def _batch_fn(seq=SEQ):
    ds = SyntheticLMDataset(512, seq, seed=_DATA_STREAM)
    return lambda step: ds.batch(BATCH, step)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request):
    """Both loops, 5 steps from the same initial params."""
    dtype = request.param
    ref_cfg, cfg = _cfgs(dtype)
    ref_ds = RefLMDataset(512, SEQ, seed=_DATA_STREAM)
    ref = RefTrainLoop(ref_get_model(ref_cfg), ref_adamw(LR),
                       lambda s: ref_ds.batch(BATCH, s),
                       RefTrainLoopConfig(total_steps=STEPS, log_every=1),
                       seed=_PARAM_STREAM)
    p0 = jax.tree.map(np.asarray, ref.params)
    ref_res = ref.run()
    port = TrainLoop(get_model(cfg), adamw(LR), _batch_fn(),
                     TrainLoopConfig(total_steps=STEPS, log_every=1),
                     device="cpu")
    port.params = params_from_numpy(p0, "cpu")
    port.opt_state = port.optimizer.init(port.params)
    port_res = port.run()
    return dtype, p0, ref, ref_res, port, port_res


def test_train_loop_losses_match_reference(trained):
    dtype, _, _, ref_res, _, port_res = trained
    want = [m["loss"] for m in ref_res["metrics_log"]]
    got = [m["loss"] for m in port_res["metrics_log"]]
    assert len(got) == len(want) == STEPS
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[dtype])
    assert [m["step"] for m in port_res["metrics_log"]] == list(
        range(1, STEPS + 1))


def test_train_loop_params_match_reference(trained):
    dtype, p0, ref, _, port, _ = trained
    outside = total = 0
    gap = moved = 0.0
    for (key, got), want, init in zip(
            leaves_with_paths(port.params), jax.tree.leaves(ref.params),
            jax.tree.leaves(p0), strict=True):
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, key
        assert np.all(np.abs(got - want) <= 10 * LR), key
        far = np.abs(got - want) > PARAM_TOL["atol"] + \
            PARAM_TOL["rtol"] * np.abs(want)
        outside += int(far.sum())
        total += got.size
        gap += float(np.sum(np.square(got - want)))
        moved += float(np.sum(np.square(want - init)))
    if dtype == "float32":
        assert outside <= PARAM_OUTSIDE * total, (outside, total)
    else:
        assert np.sqrt(gap / moved) <= BF16_UPDATE_RTOL, np.sqrt(gap / moved)


def test_grad_step_matches_jax_grad():
    ref_cfg, cfg = _cfgs("float32")
    ref_model, model = ref_get_model(ref_cfg), get_model(cfg)
    p0 = jax.tree.map(np.asarray, ref_model.init(jax.random.key(
        _PARAM_STREAM)))
    batch = _batch_fn()(0)
    (want_loss, _), want = jax.value_and_grad(ref_model.loss_fn,
                                              has_aux=True)(
        jax.tree.map(jnp.asarray, p0),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(p0, "cpu")
    grads, loss = make_grad_step(model)(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for (key, g), w in zip(leaves_with_paths(grads), jax.tree.leaves(want),
                           strict=True):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * scale, key
    assert all(x.grad is None for x in tree_leaves(params))


def test_train_step_updates_flat_buffers_in_place():
    """The params stay views of one flat buffer and the grads of another,
    at the same addresses from step to step; backward accumulates into
    the grad views."""
    _, cfg = _cfgs("float32")
    model = get_model(cfg)
    params = flat_params(model.init(torch.Generator().manual_seed(
        _PARAM_STREAM), "cpu"))
    flat = flat_buffer_of(params)
    opt = adamw(LR)
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch_fn = _batch_fn(32)
    grad_ptr = None
    for s in range(2):
        batch = {k: torch.as_tensor(v) for k, v in batch_fn(s).items()}
        before = flat.clone()
        params, state, metrics = step(params, state, batch)
        assert flat_buffer_of(params).data_ptr() == flat.data_ptr()
        grads = [x.grad for x in tree_leaves(params)]
        g_flat = flat_buffer_of(grads)
        assert g_flat is not None and g_flat.data_ptr() != flat.data_ptr()
        assert grad_ptr in (None, g_flat.data_ptr())
        grad_ptr = g_flat.data_ptr()
        assert not torch.equal(before, flat) and np.isfinite(
            float(metrics["loss"]))
    assert int(state.step) == 2


def test_loop_learns_a_fixed_batch():
    """20 steps on one batch drive its loss from ~6 to ~0. (On the
    stream itself, batches of 2 x 32 tokens are too noisy to show
    learning in a few steps, and at lr 1e-2 both packages' losses turn
    NaN near step 25: ROADMAP.md §3.)"""
    _, cfg = _cfgs("float32")
    batch_fn = _batch_fn(32)
    loop = TrainLoop(get_model(cfg), adamw(LR, weight_decay=0.0),
                     lambda step: batch_fn(0),
                     TrainLoopConfig(total_steps=20, log_every=5),
                     seed=_PARAM_STREAM, device="cpu")
    res = loop.run()
    losses = [m["loss"] for m in res["metrics_log"]]
    assert losses[-1] < 0.05 and losses[-1] < losses[0]


def test_remat_equals_no_remat():
    """``cfg.remat`` recomputes each block in the backward: the same
    losses and params, bit for bit, on the CPU."""
    out = []
    for remat in (True, False):
        _, cfg = _cfgs("bfloat16", remat=remat)
        loop = TrainLoop(get_model(cfg), adamw(LR), _batch_fn(),
                         TrainLoopConfig(total_steps=2, log_every=1),
                         seed=_PARAM_STREAM, device="cpu")
        res = loop.run()
        out.append(([m["loss"] for m in res["metrics_log"]],
                    flat_buffer_of(loop.params).clone()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


def test_resume_is_bitwise_identical(tmp_path):
    _, cfg = _cfgs("float32")
    model = get_model(cfg)
    batch_fn = _batch_fn(32)

    def loop(total, directory):
        return TrainLoop(model, adamw(LR), batch_fn,
                         TrainLoopConfig(total_steps=total, save_every=total,
                                         log_every=total,
                                         checkpoint_dir=str(directory)),
                         seed=_PARAM_STREAM, device="cpu")

    loop(6, tmp_path / "a").run()
    loop(3, tmp_path / "b").run()            # interrupted after 3 steps
    resumed = loop(6, tmp_path / "b")         # a fresh loop resumes
    assert resumed.start_step == 3
    resumed.run()
    like = {"params": resumed.params, "opt": resumed.opt_state}
    a, _ = restore_checkpoint(str(tmp_path / "a"), like)
    b, _ = restore_checkpoint(str(tmp_path / "b"), like)
    for (key, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b),
                                strict=True):
        assert torch.equal(x, y), key
    assert int(b["opt"].step) == 6


def test_checkpoint_pruning(tmp_path):
    _, cfg = _cfgs("float32")
    loop = TrainLoop(get_model(cfg), adamw(1e-3), _batch_fn(16),
                     TrainLoopConfig(total_steps=10, save_every=2,
                                     keep_checkpoints=2,
                                     checkpoint_dir=str(tmp_path)),
                     seed=_PARAM_STREAM, device="cpu")
    loop.run()
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == ["step_00000008", "step_00000010"]


def test_checkpoint_keys_match_reference(tmp_path):
    """The same model and optimizer give the same key paths, shapes and
    dtypes in both packages' checkpoints."""
    import json
    ref_cfg, cfg = _cfgs("bfloat16")
    ref_params = ref_get_model(ref_cfg).init(jax.random.key(_PARAM_STREAM))
    ref_save(str(tmp_path / "ref"), 1, {
        "params": ref_params, "opt": ref_adamw(LR).init(ref_params)})
    params = get_model(cfg).init(torch.Generator().manual_seed(
        _PARAM_STREAM), "cpu")
    save_checkpoint(str(tmp_path / "port"), 1, {
        "params": params, "opt": adamw(LR).init(params)})
    metas, arrays = [], []
    for side in ("ref", "port"):
        d = tmp_path / side / "step_00000001"
        metas.append(json.loads((d / "meta.json").read_text()))
        with np.load(d / "arrays.npz") as npz:
            arrays.append({k: (npz[k].shape, npz[k].dtype) for k in npz.files})
    assert metas[0]["keys"] == metas[1]["keys"]
    assert "opt/step" in metas[1]["keys"]
    assert arrays[0] == arrays[1]
