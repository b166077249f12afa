"""The audio family (seamless-m4t-large-v2, reduced: 2 encoder and 2
decoder layers, 8 stub frames) over rank meshes of gloo ranks, held to
the port's unsharded path and to the reference's own sharded run.

* Float32 compute, on ``("data", "model")`` meshes (1, 4) and (1, 2)
  with sequence parallelism off and on (the encoder split over its
  frames, the decoder over its text positions), (1, 4) with remat,
  (1, 4) with 2 heads of 128 (the heads do not divide: attention
  replicated, the FFN split), (2, 2) with fsdp and sequence
  parallelism, and (1, 4) at vocab 500 (padded to 512), params from the
  reference's init cut by ``shard_params``: the global batch's loss
  within rtol 1e-5 of the unsharded loss, the gathered gradients within
  rtol 1e-4 / atol 1e-6, the prefill logits and 4 teacher-forced decode
  steps within rtol 1e-5 / atol 1e-5, gathered to every rank; every
  replicated leaf's gradient (the norms; with replicated heads the
  attention weights) is the unsharded one on every rank; the self and
  cross caches after prefill and after the steps, gathered by
  ``state_pspecs``, equal the unsharded ones, each rank holding its
  rows and its kv heads.
* The padded vocabulary: both packages' greedy schedulers take the
  argmax over the padded columns (``repro/serving/scheduler.py``, and
  the port's twin); with a padded column of ``lm_head`` raised (the
  other columns scaled by 1e-3, two padded columns set to +-w), both emit
  the same padded ids, and the sharded ``prefill_fn`` / ``decode_fn``
  gather the padded columns as the unsharded run has them.
* The clip on (2, 2) with fsdp, ``TrainLoop`` checkpoints across
  layouts and federated rounds of 2 tensor-parallel clients of 2 model
  ranks, as ``test_torch_hybrid_tp.py`` holds them.
* bf16 compute (the config's own) on (2, 2) with fsdp and sequence
  parallelism, against the reference's sharded run
  on a forged ``Auto`` mesh and its unsharded run
  (``_torch_family_tp.assert_in_band``), for the loss, each gradient
  leaf, the prefill logits and the decode steps' logits.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.fl.distributed import choose_fl_hierarchy
from repro_torch.utils.trees import tree_leaves

sys.path.insert(0, str(Path(__file__).parent))
import _torch_family_tp as fam  # noqa: E402  (the shared machinery)

ARCH = "seamless-m4t-large-v2"
SEED = 290
ROWS, SEQ, PROMPT, STEPS = 4, 32, 12, 4
F32, BF16 = ("float32",), ("float32", "bfloat16")
PADDED = {"vocab_size": 500}            # pads to 512 (a multiple of 64)
WINNERS = (505, 506)                    # the raised padded columns
# name -> (overrides, dims, seq, fsdp, dtypes)
CASES = {
    "m4-seq-off": ({}, (1, 4), False, False, F32),
    "m4-seq-on": ({}, (1, 4), True, False, F32),
    "m2-seq-off": ({}, (1, 2), False, False, F32),
    "m2-seq-on": ({}, (1, 2), True, False, F32),
    "m4-seq-on-remat": ({"remat": True}, (1, 4), True, False, F32),
    "m4-replicated-heads": ({"n_heads": 2, "n_kv_heads": 2,
                             "head_dim": 128}, (1, 4), True, False, F32),
    "m4-padded-vocab": (PADDED, (1, 4), True, False, F32),
    "2x2-fsdp-seq": ({}, (2, 2), True, True, BF16),
}
BF16_CASES = [n for n, c in CASES.items() if "bfloat16" in c[4]]
TRAIN_ROWS, TRAIN_SEQ = 4, 32
PAIR = choose_fl_hierarchy(2)
FL_TREE = ((PAIR.depth, PAIR.width, PAIR.trainers_per_leaf, PAIR.n_clients),
           [0])
FL_ROWS, FL_SEQ = 2, 32


def _over(name, dtype="float32"):
    return dict(CASES[name][0], dtype=dtype)


def _raised(params):
    """``params`` with ``lm_head``'s columns scaled by 1e-3 and two
    padded ones set to +-w (w of norm 4): one of them wins the
    argmax but where the stream is near orthogonal to w."""
    proj = params["lm_head"]["proj"].copy()
    w = np.random.default_rng(SEED).standard_normal(proj.shape[0])
    w = (4.0 * w / np.linalg.norm(w)).astype(np.float32)
    proj *= 1e-3
    proj[:, WINNERS[0]], proj[:, WINNERS[1]] = w, -w
    return dict(params, lm_head={"proj": proj})


def _inputs(name, dtype):
    params, batch, prompt, steps = fam.inputs(
        ARCH, _over(name, dtype), SEED, ROWS, SEQ, PROMPT, STEPS)
    if name == "m4-padded-vocab":
        params = _raised(params)
    return params, batch, prompt, steps


def _f32_cfg():
    return fam.config(ARCH, {"dtype": "float32"})


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """The unsharded clip and loop runs, and the inputs of their ranks."""
    root = tmp_path_factory.mktemp("encdec_loops")
    cfg = _f32_cfg()
    params = fam.ref_params(ARCH, {}, SEED)
    batches = fam.train_batches(cfg, 3, TRAIN_ROWS, TRAIN_SEQ, SEED)
    # client-stacked: (2 clients, rows, ...)
    fl_batch = {k: np.stack([b[k] for b in fam.train_batches(
        cfg, 2, FL_ROWS, FL_SEQ, SEED + 1)]) for k in batches[0]}
    return {"root": root, "params": params, "batches": batches,
            "clip": fam.unsharded_clip(cfg, params, batches),
            "loop": fam.unsharded_loop(cfg, batches, root),
            "fl_batch": fl_batch,
            "host": fam.host_round(cfg, *FL_TREE, "hierarchical", params,
                                   fl_batch)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's bf16 runs, started before the ranks."""
    return fam.start_reference(tmp_path_factory.mktemp("ref_encdec_tp"),
                               ARCH, CASES, _inputs, BF16_CASES)


@pytest.fixture(scope="module")
def worlds(reference, train):
    cfg = (ARCH, {"dtype": "float32"})
    common = dict(dims=(2, 2), axes=("data", "model"), cfg=cfg, fsdp=True)
    extra = [(("clip",), 4, ("clip_case", dict(
                common, params=train["params"], batches=train["batches"],
                lr=fam.CLIP_LR, clip=fam.CLIP, sgd_lr=fam.CLIP_SGD_LR)))]
    for name in ("sharded", "resume-sharded"):
        extra.append((("loop", name), 4, ("loop_case", dict(
            common, batches=train["batches"], lr=1e-3,
            ckpt=str(train["root"] / name)))))
    extra.append((("fl",), 4, ("fl_tp_round", dict(
        dims=(2, 2), cfg=cfg, seq=True, tree=FL_TREE[0],
        placement=FL_TREE[1], mode="hierarchical", lr=fam.FL_LR,
        local_steps=1, params=train["params"], batch=train["fl_batch"]))))
    return fam.run_worlds(ARCH, CASES, _inputs, extra)


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for name in CASES:
        over = _over(name)
        key = tuple(sorted(over.items()))
        if key not in out:
            out[key] = fam.unsharded(ARCH, over, *_inputs(name, "float32"))
    return {name: out[tuple(sorted(_over(name).items()))] for name in CASES}


@pytest.fixture(scope="module")
def ref_runs(reference):
    """The reference's bf16 runs and the port's unsharded bf16 runs."""
    port = {name: fam.unsharded(ARCH, _over(name, "bfloat16"),
                                *_inputs(name, "bfloat16"))
            for name in BF16_CASES}
    return fam.reference_runs(reference), port


# ---------------------------------------------------------------------------
# float32: the sharded path equals the unsharded one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_equal_the_unsharded_path(worlds, unsharded,
                                                     name):
    ranks, want = worlds[name, "float32"], unsharded[name]
    for r in ranks:                  # one loss, the global batch's
        assert r["loss"] == ranks[0]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"],
                               rtol=fam.LOSS_RTOL)
    got, exp = tree_leaves(ranks[0]["grads"]), tree_leaves(want["grads"])
    assert len(got) == len(exp)
    for a, b in zip(got, exp, strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **fam.GRAD_TOL)


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_carry_the_whole_gradient_on_every_rank(
        worlds, unsharded, name):
    ranks = worlds[name, "float32"]
    paths = set(ranks[0]["replicated"])
    norms = {"encoder/ln1/scale", "encoder/ln2/scale", "decoder/ln1/scale",
             "decoder/ln_x/scale", "decoder/ln2/scale", "ln_enc/scale",
             "ln_f/scale"}
    assert norms <= paths
    attn = {f"{s}/{w}" for s in ("encoder/attn", "decoder/self_attn",
                                 "decoder/cross_attn")
            for w in ("wq", "wk", "wv", "wo")}
    if name == "m4-replicated-heads":
        assert attn <= paths
    else:
        assert not attn & paths
    for r in ranks:
        for path, g in r["replicated"].items():
            np.testing.assert_allclose(
                g, _leaf(unsharded[name]["grads"], path), **fam.GRAD_TOL)
            np.testing.assert_array_equal(g, ranks[0]["replicated"][path])


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_equal_the_unsharded_path(worlds, unsharded,
                                                     name):
    want = unsharded[name]["logits"]
    for r in worlds[name, "float32"]:
        assert len(r["logits"]) == STEPS + 1
        for got, w in zip(r["logits"], want, strict=True):
            np.testing.assert_allclose(got, w, **fam.LOGIT_TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_decode_state_equals_the_unsharded_state(worlds, unsharded,
                                                          name):
    r0 = worlds[name, "float32"][0]
    for got, want in zip(r0["state"], unsharded[name]["states"],
                         strict=True):
        for (pa, a), (pb, b) in zip(sorted(_flat(got)), sorted(_flat(want)),
                                    strict=True):
            assert pa == pb and a.shape == b.shape
            np.testing.assert_allclose(a, b, **fam.LOGIT_TOL)
    cfg = fam.config(ARCH, _over(name))
    dims = CASES[name][1]
    m = dims[1]
    hkv = cfg.n_kv_heads // m if cfg.n_heads % m == 0 else cfg.n_kv_heads
    rows, hd = ROWS // dims[0], cfg.resolved_head_dim
    local = r0["local_state"]
    assert local["self/k"] == (cfg.n_layers, rows, PROMPT + 64, hkv, hd)
    assert local["cross/v"] == (cfg.n_layers, rows, cfg.frontend_len, hkv,
                                hd)


# ---------------------------------------------------------------------------
# the padded vocabulary
# ---------------------------------------------------------------------------
def test_schedulers_take_the_argmax_over_the_padded_vocabulary(worlds,
                                                              unsharded):
    """Both packages' greedy schedulers emit the raised padded ids, and
    the ranks' gathered logits pick them as the unsharded run does."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import get_model as ref_get_model
    from repro.serving import Request as RefRequest
    from repro.serving import WaveScheduler as RefScheduler
    from repro_torch.core.state import params_from_numpy
    from repro_torch.models import get_model
    from repro_torch.serving import Request, WaveScheduler

    params, _, prompt, _ = _inputs("m4-padded-vocab", "float32")
    cfg = fam.config(ARCH, _over("m4-padded-vocab"))
    assert cfg.padded_vocab == 512 and cfg.vocab_size == 500
    ref_cfg = ref_get_config(ARCH).reduced().replace(**_over(
        "m4-padded-vocab"))
    fe = prompt["frontend"][0]
    ours = WaveScheduler(get_model(cfg), params_from_numpy(params, "cpu"),
                         max_batch=2, frontend=fe)
    theirs = RefScheduler(ref_get_model(ref_cfg),
                          jax.tree.map(jnp.asarray, params), max_batch=2,
                          frontend=fe)
    with fam.one_thread():
        for i, toks in enumerate(prompt["tokens"][:2]):
            ours.submit(Request(rid=i, tokens=toks, max_new_tokens=3))
            theirs.submit(RefRequest(rid=i, tokens=toks, max_new_tokens=3))
        got, want = ours.run(), theirs.run()
    for g, w in zip(got, want, strict=True):
        assert set(g.output.tolist()) <= set(WINNERS)
        np.testing.assert_array_equal(g.output, w.output)
    # the ranks' logits, gathered, keep the padded columns: the prefill's
    # picks are the raised ids, and every pick of the teacher-forced steps
    # is the unsharded run's
    for r in worlds["m4-padded-vocab", "float32"]:
        assert set(r["logits"][0][:, -1].argmax(-1).tolist()) <= set(WINNERS)
        for logits, want_l in zip(r["logits"],
                                  unsharded["m4-padded-vocab"]["logits"],
                                  strict=True):
            assert logits.shape[-1] == 512
            np.testing.assert_array_equal(logits[:, -1].argmax(-1),
                                          want_l[:, -1].argmax(-1))
            np.testing.assert_allclose(logits[..., 500:], want_l[..., 500:],
                                       **fam.LOGIT_TOL)


# ---------------------------------------------------------------------------
# the clip, TrainLoop and federated rounds over ranks
# ---------------------------------------------------------------------------
def test_clip_reads_the_global_norm(worlds, train):
    want = train["clip"]["norm"]
    for r in worlds["clip",]:
        np.testing.assert_allclose(r["norm"], want, rtol=fam.NORM_RTOL)
    assert worlds["clip",][0]["local_norm"] < 0.9 * want


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_clipped_steps_equal_the_unsharded_steps(worlds, train, opt):
    ranks = worlds["clip",]
    p0 = tree_leaves(train["params"])
    tol = fam.SGD_UPDATE_REL if opt == "sgd" else fam.ADAMW_UPDATE_REL
    for got, want, p in zip(tree_leaves(ranks[0][opt]),
                            tree_leaves(train["clip"][opt]), p0, strict=True):
        assert fam.rel(got - p, want - p) <= tol
    if opt == "adamw":
        np.testing.assert_allclose(ranks[0]["losses"],
                                   train["clip"]["losses"],
                                   rtol=fam.LOSS_RTOL)
        for r in ranks[1:]:          # replicated leaves stay bit-equal
            for k, v in r["scales"].items():
                np.testing.assert_array_equal(v, ranks[0]["scales"][k])


def _assert_updates_close(got, want, init):
    for a, b, p in zip(tree_leaves(got), tree_leaves(want), tree_leaves(init),
                       strict=True):
        assert a.shape == b.shape
        assert fam.rel(a - p, b - p) <= fam.LOOP_UPDATE_REL


def test_train_loop_checkpoints_are_global_and_resume_across_layouts(
        worlds, train):
    init = fam.seed_init(_f32_cfg())
    want = [rec["loss"] for rec in train["loop"]["log"]]
    for r in worlds["loop", "sharded"]:
        assert r["start"] == 0
        np.testing.assert_allclose([rec["loss"] for rec in r["log"]], want,
                                   rtol=fam.LOSS_RTOL)
    sharded = worlds["loop", "sharded"][0]["params"]
    _assert_updates_close(sharded, train["loop"]["params"], init)
    got = np.load(train["root"] / "sharded" / "step_00000003" / "arrays.npz")
    exp = np.load(train["root"] / "unsharded" / "step_00000003"
                  / "arrays.npz")
    assert sorted(got.files) == sorted(exp.files)
    for k in exp.files:
        assert got[k].shape == exp[k].shape
    resumed = worlds["loop", "resume-sharded"]
    assert all(r["start"] == 2 for r in resumed)
    _assert_updates_close(resumed[0]["params"], train["loop"]["params"], init)
    start, params = fam.resume_unsharded(_f32_cfg(), train["batches"],
                                         train["root"])
    assert start == 2
    _assert_updates_close(params, sharded, init)


def test_federated_round_of_tensor_parallel_clients_equals_the_host_path(
        worlds, train):
    ranks = worlds["fl",]
    want, want_loss = train["host"]
    np.testing.assert_allclose(ranks[0]["loss"], want_loss, **fam.FL_TOL)
    assert sorted({r["client"] for r in ranks}) == [0, 1]
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        for a, b in zip(tree_leaves(r["params"]), tree_leaves(want),
                        strict=True):
            np.testing.assert_allclose(a, b, **fam.FL_TOL)
        first = next(q for q in ranks if q["model"] == r["model"])
        for a, b in zip(tree_leaves(r["local"]), tree_leaves(first["local"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(ranks[0]["init"]),
                    tree_leaves(fam.seed_init(_f32_cfg())), strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# bf16: inside the reference's own sharded band
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_stays_inside_the_reference_sharded_band(worlds, ref_runs, name):
    ref, port = ref_runs
    i = BF16_CASES.index(name)
    fam.assert_in_band(worlds[name, "bfloat16"][0], port[name], ref, i,
                       fam.unsharded_of(CASES, BF16_CASES, i),
                       n_logits=STEPS + 1)
