"""The hybrid family (recurrentgemma-2b, reduced to 5 layers: one (r, r,
a) triple and two tail blocks) over rank meshes of gloo ranks, held to
the port's unsharded path and to the reference's own sharded run.

* Float32 compute, on ``("data", "model")`` meshes (1, 4) and (1, 2)
  with sequence parallelism off and on, (1, 4) with remat, and (2, 2)
  with fsdp and sequence parallelism (``make_policy``), params from the
  reference's init cut by ``shard_params``: the global batch's loss
  within rtol 1e-5 of the unsharded loss, the gathered gradients within
  rtol 1e-4 / atol 1e-6, the prefill logits of a 70-token prompt (the
  ring of 64 wrapped) and 4 teacher-forced decode steps within rtol
  1e-5 / atol 1e-5, gathered to every rank. S is 128, so the reduced
  window of 64 binds. Every replicated leaf's gradient (``conv_w``,
  ``conv_b``, ``lam``, ``b_a``, ``b_x``, the norms and, without fsdp,
  the attention weights) is the unsharded one on every rank: whole,
  not a rank's share or M times it. The decode state after prefill and
  after the steps, gathered by ``state_pspecs``, equals the unsharded
  state at the logits' tolerance; each rank holds dr / M channels of
  the RG-LRU states and every channel of the conv states.
* The clip reads the global norm on (2, 2) with fsdp, and one clipped
  SGD step and three clipped AdamW steps equal the unsharded steps;
  ``TrainLoop`` on (2, 2) with fsdp writes global checkpoints, and
  resume crosses layouts both ways (``test_torch_fsdp.py``'s rules).
* Federated rounds of tensor-parallel clients on (2, 2), 2 clients of 2
  model ranks, the reference's federated policy: the round's params
  equal the host path's at ``test_torch_fl_tp.py``'s tolerance, and
  every shard is bit-equal along the data axis.
* bf16 compute (the config's own) on (2, 2) with fsdp and sequence
  parallelism, against the reference's sharded run
  on a forged ``Auto`` mesh and its unsharded run (``_torch_family_tp.
  assert_in_band``): sharding moves the port's loss, each gradient leaf
  and the prefill logits at most BAND_MARGIN (2) times as far as it
  moves the reference's, and the port's sharded run lies within
  BAND_MARGIN times the larger of the reference's own sharded gap and
  the two packages' unsharded gap of the reference's sharded run (the
  port's unsharded bf16 loss is 1.06e-3 from the reference's, its own
  sharded gap 1.4e-4 on (1, 4) with seq on: ROADMAP.md section 3). The
  decode logits are held to the port alone: the port's hybrid decode
  writes at ``pos + 1`` into a full ring on purpose, where the
  reference's does not (ROADMAP.md section 3).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.fl.distributed import choose_fl_hierarchy
from repro_torch.utils.trees import tree_leaves

sys.path.insert(0, str(Path(__file__).parent))
import _torch_family_tp as fam  # noqa: E402  (the shared machinery)

ARCH = "recurrentgemma-2b"
BASE = {"n_layers": 5}
SEED = 29
ROWS, SEQ, PROMPT, STEPS = 4, 128, 70, 4
F32, BF16 = ("float32",), ("float32", "bfloat16")
# name -> (overrides, dims, seq, fsdp, dtypes)
CASES = {
    "m4-seq-off": ({}, (1, 4), False, False, F32),
    "m4-seq-on": ({}, (1, 4), True, False, F32),
    "m2-seq-off": ({}, (1, 2), False, False, F32),
    "m2-seq-on": ({}, (1, 2), True, False, F32),
    "m4-seq-on-remat": ({"remat": True}, (1, 4), True, False, F32),
    "2x2-fsdp-seq": ({}, (2, 2), True, True, BF16),
}
BF16_CASES = [n for n, c in CASES.items() if "bfloat16" in c[4]]
TRAIN_ROWS, TRAIN_SEQ = 4, 64
PAIR = choose_fl_hierarchy(2)
FL_TREE = ((PAIR.depth, PAIR.width, PAIR.trainers_per_leaf, PAIR.n_clients),
           [0])
FL_ROWS, FL_SEQ = 2, 64


def _over(name, dtype="float32"):
    return dict(BASE, **CASES[name][0], dtype=dtype)


def _inputs(name, dtype):
    return fam.inputs(ARCH, _over(name, dtype), SEED, ROWS, SEQ, PROMPT,
                      STEPS)


def _f32_cfg():
    return fam.config(ARCH, dict(BASE, dtype="float32"))


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """The unsharded clip and loop runs, and the inputs of their ranks."""
    root = tmp_path_factory.mktemp("hybrid_loops")
    cfg = _f32_cfg()
    params = fam.ref_params(ARCH, dict(BASE, dtype="float32"), SEED)
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
    """The reference's bf16 runs, started before the ranks (its decode
    left out: see the module docstring)."""
    return fam.start_reference(tmp_path_factory.mktemp("ref_hybrid_tp"),
                               ARCH, _cases(), _inputs, BF16_CASES,
                               decode=False)


@pytest.fixture(scope="module")
def worlds(reference, train):
    cfg = ("recurrentgemma-2b", dict(BASE, dtype="float32"))
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
    return fam.run_worlds(ARCH, _cases(), _inputs, extra)


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for name in CASES:
        over = _over(name)
        key = tuple(sorted(over.items()))
        if key not in out:
            out[key] = fam.unsharded(ARCH, over, *_inputs(name, "float32"))
    return {name: out[tuple(sorted(_over(name).items()))] for name in CASES}


def _cases():
    return {n: (dict(BASE, **c[0]),) + c[1:] for n, c in CASES.items()}


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
    for want in ("conv_w", "conv_b", "lam", "b_a", "b_x", "ln/scale",
                 "ln_mlp/scale"):
        assert f"tail/{want}" in paths and f"triples/rec1/{want}" in paths
    assert "ln_f/scale" in paths
    if not CASES[name][3]:           # without fsdp: the attention's too
        assert {f"triples/attn/{w}" for w in ("wq", "wk", "wv", "wo")} \
            <= paths
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
    dims = CASES[name][1]
    rows = ROWS // dims[0]
    m = dims[1]
    local = r0["local_state"]
    assert local["tail/h"] == (2, rows, 256 // m)
    assert local["triples/rec1/conv"] == (1, rows, 3, 256)
    assert local["triples/attn/k"] == (1, rows, 64, 1, 64)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


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
    # an unsharded checkpoint resumed on the ranks, and the ranks'
    # resumed unsharded
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
    # init_stacked drew the one seeded init and kept each rank its shards
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
                       fam.unsharded_of(_cases(), BF16_CASES, i), n_logits=1)

