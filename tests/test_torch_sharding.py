"""The sharding policy and every family's spec rules, held to the
reference's exactly; and fault F3, the reference's call shapes.

* ``ShardingPolicy`` arithmetic (``axis_size``, ``dim`` with its
  divisibility gate, ``spec``, ``named``), ``resolve_hint`` /
  ``shard_hint`` with ``force``, and ``make_policy``, against the
  reference's on the same meshes.
* ``param_pspecs``, ``state_pspecs`` (two batch and cache sizes) and
  ``FLTrainStep.stacked_param_pspecs`` of every config in
  ``repro_torch.configs``, reduced and at full size, on meshes (1, 4),
  (2, 4), (4, 2), (2, 2, 4) and (2, 3) (a model axis of 3: the kv heads
  that do not divide, the cache over its length or over hd), fsdp and
  sequence sharding on and off. The reference runs once, in a
  subprocess with 16 forged host devices; the port's shapes are built
  on the meta device.
* F3: ``attention_block``, ``make_block_fn``, ``decoder_forward``,
  ``make_loss_fn``, ``make_decode_fn``, ``make_prefill_fn``, ``encode``
  and ``decode_stack`` take the reference's positional and keyword
  arguments (and give its numbers, float32); ``get_model`` raises
  ``KeyError`` for an unknown family; ``fedavg_ref`` takes ``weights``.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import get_model as ref_get_model
from repro.models import transformer as ref_transformer
from repro.models.sharding import UNSHARDED as REF_UNSHARDED
from repro_torch.configs import get_config, list_configs
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.fl.distributed import FLTrainStep
from repro_torch.kernels.ref import fedavg_ref
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import UNSHARDED, get_model, make_policy
from repro_torch.models import encdec, transformer
from repro_torch.models.sharding import PartitionSpec, resolve_hint, shard_hint
from repro_torch.optim import sgd
from repro_torch.utils.trees import tree_leaves, tree_map_with_path

SRC = str(Path(__file__).resolve().parents[1] / "src")
_INIT_STREAM = 270
_DATA_STREAM = 2700
MESHES = (((1, 4), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
          ((2, 3), ("data", "model")))
FLAGS = tuple(itertools.product((False, True), (False, True)))  # fsdp, seq
STATE_SIZES = ((4, 64), (3, 66))          # (batch, cache length)
CONFIGS = tuple(list_configs())
SIZES = ("reduced", "full")


def _spec_json(spec):
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def _flat(tree, shapes):
    """{path: spec as JSON} of a spec tree over a shape tree."""
    out = {}
    tree_map_with_path(lambda path, x, spec: out.__setitem__(
        path, _spec_json(spec)), shapes, tree)
    return out


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.core.hierarchy import Hierarchy
    from repro.fl.distributed import FLTrainStep
    from repro.models import get_model
    from repro.models.api import _path_str
    from repro.models.sharding import make_policy
    from repro.optim import sgd

    req = json.loads(open(sys.argv[1]).read())

    def js(spec):
        return [list(s) if isinstance(s, tuple) else s for s in spec]

    def flat(specs):
        out = {}
        for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]:
            out[_path_str(path)] = js(s)
        return out

    meshes = [jax.make_mesh(tuple(d), tuple(a)) for d, a in req["meshes"]]
    out = {}
    for name in req["configs"]:
        for size in req["sizes"]:
            cfg = get_config(name)
            cfg = cfg.reduced() if size == "reduced" else cfg
            shapes = None
            states = {}
            for mi, mesh in enumerate(meshes):
                for fsdp, seq in req["flags"]:
                    model = get_model(cfg, make_policy(mesh, fsdp, seq))
                    if shapes is None:      # the method once, then its rule
                        shapes = model.param_shapes()
                        specs = model.param_pspecs()
                    else:
                        specs = jax.tree_util.tree_map_with_path(
                            lambda p, x: model.spec_rule(_path_str(p),
                                                         tuple(x.shape)),
                            shapes)
                    key = f"{name}|{size}|{mi}|{int(fsdp)}|{int(seq)}"
                    rec = {"params": flat(specs), "state": {}}
                    for b, t in req["state_sizes"]:
                        if model.init_decode_state is None:
                            rec["state"][f"{b}x{t}"] = None
                            continue
                        if (b, t) not in states:
                            states[b, t] = jax.eval_shape(
                                lambda: model.init_decode_state(b, t))
                        rec["state"][f"{b}x{t}"] = flat(
                            jax.tree_util.tree_map_with_path(
                                lambda p, x: model.state_spec_rule(
                                    _path_str(p), tuple(x.shape)),
                                states[b, t]))
                    data = mesh.shape.get("data", 1)
                    if data % 2 == 0:
                        fl = FLTrainStep(model, sgd(0.1), Hierarchy(
                            1, 1, 1, n_clients=2), np.arange(1))
                        base = fl.model.param_pspecs
                        fl.model.param_pspecs = lambda s=specs: s
                        rec["stacked"] = flat(fl.stacked_param_pspecs())
                        fl.model.param_pspecs = base
                    out[key] = rec
    open(sys.argv[2], "w").write(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_specs")
    (tmp / "req.json").write_text(json.dumps({
        "configs": CONFIGS, "sizes": SIZES, "meshes": MESHES,
        "flags": FLAGS, "state_sizes": STATE_SIZES}))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "req.json"),
         str(tmp / "out.json")], env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text())


def _mesh(dims, axes):
    return DeviceMesh((torch.device("cpu"),) * int(np.prod(dims)), axes, dims)


def _cfg(name, size):
    cfg = get_config(name)
    return cfg.reduced() if size == "reduced" else cfg


# ---------------------------------------------------------------------------
# the spec rules, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_state_pspecs_equal_the_reference(ref_specs, name, size):
    cfg = _cfg(name, size)
    for mi, (dims, axes) in enumerate(MESHES):
        for fsdp, seq in FLAGS:
            key = f"{name}|{size}|{mi}|{int(fsdp)}|{int(seq)}"
            model = get_model(cfg, make_policy(_mesh(dims, axes), fsdp, seq))
            shapes = model.param_shapes()
            assert all(x.is_meta for x in tree_leaves(shapes))
            got = _flat(model.param_pspecs(), shapes)
            assert got == ref_specs[key]["params"], key
            for b, t in STATE_SIZES:
                want = ref_specs[key]["state"][f"{b}x{t}"]
                specs = model.state_pspecs(b, t)
                if want is None:
                    assert specs is None, key
                    continue
                state = model.init_decode_state(b, t, "meta") \
                    if model.unsharded is None else \
                    model.unsharded.init_decode_state(b, t, "meta")
                assert _flat(specs, state) == want, (key, b, t)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", CONFIGS)
def test_stacked_param_pspecs_equal_the_reference(ref_specs, name, size):
    cfg = _cfg(name, size)
    n = 0
    for mi, (dims, axes) in enumerate(MESHES):
        if dict(zip(axes, dims))["data"] % 2:
            continue
        for fsdp, seq in FLAGS:
            key = f"{name}|{size}|{mi}|{int(fsdp)}|{int(seq)}"
            model = get_model(cfg, make_policy(_mesh(dims, axes), fsdp, seq))
            fl = FLTrainStep(model, sgd(0.1), Hierarchy(1, 1, 1, n_clients=2),
                             np.arange(1))
            got = _flat(fl.stacked_param_pspecs(), model.param_shapes())
            assert got == ref_specs[key]["stacked"], key
            n += 1
    assert n == 4 * len(FLAGS)


def test_model_axis_of_three_reaches_the_fallbacks(ref_specs):
    """granite-8b on a (2, 3) mesh: 32 q and 8 kv heads do not divide
    by 3, so wq, wk and wv replicate; the cache goes over its length
    where 66 slots divide, and stays replicated at 64 slots (hd 128 does
    not divide either); a batch of 3 does not split over data 2."""
    key = "granite-8b|full|4|0|0"
    params = ref_specs[key]["params"]
    assert params["layers/attn/wq"] == [None, None, None]
    assert params["layers/ffn/w_up"] == [None, None, "model"]
    assert params["layers/attn/wk"] == [None, None, None]
    state = ref_specs[key]["state"]
    assert state["3x66"]["cache/k"] == [None, None, "model", None, None]
    assert state["4x64"]["cache/k"] == [None, "data", None, None, None]


# ---------------------------------------------------------------------------
# the policy's arithmetic against the reference's
# ---------------------------------------------------------------------------
def _ref_mesh(dims, axes):
    class _M:                         # the reference reads .shape and names
        shape = dict(zip(axes, dims))
        axis_names = axes
    return _M()


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_policy_arithmetic_equals_the_reference(mi):
    from repro.models.sharding import make_policy as ref_make_policy
    dims, axes = MESHES[mi]
    for fsdp, seq in FLAGS:
        got = make_policy(_mesh(dims, axes), fsdp, seq)
        want = ref_make_policy(_ref_mesh(dims, axes), fsdp, seq)
        for f in ("batch_axes", "model_axis", "fsdp_axes", "seq_axis",
                  "ep2d_axis"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.model_size == want.model_size
        assert got.batch_size_divisor == want.batch_size_divisor
        for axes_q in (None, "model", "data", ("data",), axes):
            assert got.axis_size(axes_q) == want.axis_size(axes_q)
        for logical in (None, "batch", "model", "fsdp", "seq", "other"):
            for size in (None, 1, 2, 3, 4, 6, 8, 12):
                assert got.dim(logical, size) == want.dim(logical, size), \
                    (logical, size)
        dims_q = ("batch", ("model", 6), None, ("seq", 8), "fsdp")
        assert tuple(got.spec(*dims_q)) == tuple(want.spec(*dims_q))
        assert make_policy(None) is UNSHARDED


def test_named_gives_a_placement_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard
    pol = make_policy(_mesh((2, 4), ("data", "model")))
    named = pol.named("batch", None, "model")
    assert named.spec == PartitionSpec("data", None, "model")
    assert named.placements() == (Shard(0), Shard(2))
    assert pol.named(None, "batch").placements() == (Shard(1), Replicate())
    assert UNSHARDED.named("batch") is None


def test_shard_hint_resolves_as_the_reference_with_force():
    from repro.models.sharding import make_policy as ref_make_policy
    dims, axes = (2, 4), ("data", "model")
    pol = make_policy(_mesh(dims, axes), seq_shard=True)
    ref = ref_make_policy(_ref_mesh(dims, axes), seq_shard=True)
    x = torch.zeros(4, 8, 16)
    for logical, force in ((("batch", "seq", None), False),
                           (("batch", None, None), True),
                           ((None, None, None), False),
                           (("batch", ("seq", 6), None), False)):
        got = resolve_hint(pol, tuple(x.shape), *logical, force=force)
        want = [ref.dim(d[0], d[1]) if isinstance(d, tuple) else ref.dim(d, n)
                for d, n in zip(logical, x.shape)]
        if not force and all(w is None for w in want):
            assert got is None
        else:
            assert tuple(got) == tuple(want)
        assert shard_hint(x, pol, *logical, force=force) is x
    with pytest.raises(ValueError, match="rank mismatch"):
        shard_hint(x, pol, "batch", None)
    assert resolve_hint(UNSHARDED, (4,), "batch") is None


# ---------------------------------------------------------------------------
# F3: the reference's call shapes
# ---------------------------------------------------------------------------
ARCH = "granite-8b"


@pytest.fixture(scope="module")
def shared():
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    ref_cfg = ref_get_config(ARCH).reduced().replace(dtype="float32")
    gen = torch.Generator().manual_seed(_INIT_STREAM)
    np_params = params_to_numpy(get_model(cfg).init(gen, "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, 0))
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    return cfg, ref_cfg, np_params, x, toks


def _layer(np_params):
    return jax.tree.map(lambda a: a[0], np_params["layers"])


def test_attention_block_takes_the_reference_arguments(shared):
    cfg, ref_cfg, np_params, x, _ = shared
    attn = _layer(np_params)["attn"]
    want = ref_transformer.attention_block(
        jax.tree.map(jnp.asarray, attn), jnp.asarray(x), ref_cfg,
        REF_UNSHARDED, jnp.arange(16), None)
    pos = params_from_numpy(attn, "cpu")
    got = transformer.attention_block(pos, torch.tensor(x), cfg, UNSHARDED,
                                      torch.arange(16), None)
    kw = transformer.attention_block(
        layer_attn=pos, x=torch.tensor(x), cfg=cfg, policy=UNSHARDED,
        positions=torch.arange(16), window=None)
    assert torch.equal(got, kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_block_fn_and_decoder_forward_take_the_reference_arguments(shared):
    cfg, ref_cfg, np_params, x, _ = shared
    layer = _layer(np_params)
    zero = jnp.zeros((), jnp.float32)
    (want, _), none = ref_transformer.make_block_fn(
        ref_cfg, REF_UNSHARDED, None, n_real=None)(
        (jnp.asarray(x), zero), jax.tree.map(jnp.asarray, layer))
    block = transformer.make_block_fn(cfg, UNSHARDED, None, n_real=None)
    (got, aux), nothing = block((torch.tensor(x), torch.zeros(())),
                                params_from_numpy(layer, "cpu"))
    assert none is None and nothing is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want, _ = ref_transformer.decoder_forward(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(x), ref_cfg,
        REF_UNSHARDED, None, n_real=None)
    got, _ = transformer.decoder_forward(
        params_from_numpy(np_params, "cpu"), torch.tensor(x), cfg, UNSHARDED,
        None, n_real=None)
    kw, _ = transformer.decoder_forward(
        params=params_from_numpy(np_params, "cpu"), embeds=torch.tensor(x),
        cfg=cfg, policy=UNSHARDED, window=None, n_real=None)
    assert torch.equal(got, kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_model_function_makers_take_the_reference_arguments(shared):
    cfg, ref_cfg, np_params, _, toks = shared
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    p = params_from_numpy(np_params, "cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    want, _ = ref_transformer.make_loss_fn(ref_cfg, REF_UNSHARDED, None)(
        jp, jax.tree.map(jnp.asarray, batch))
    for fn in (transformer.make_loss_fn(cfg, UNSHARDED, None),
               transformer.make_loss_fn(cfg=cfg, policy=UNSHARDED,
                                        window=None)):
        got, _ = fn(p, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    prompt = {"tokens": toks[:, :8]}
    want, ref_state = ref_transformer.make_prefill_fn(
        ref_cfg, REF_UNSHARDED, None)(jp, jax.tree.map(jnp.asarray, prompt))
    for fn in (transformer.make_prefill_fn(cfg, UNSHARDED, None),
               transformer.make_prefill_fn(cfg=cfg, policy=UNSHARDED,
                                           window=None)):
        got, state = fn(p, {"tokens": torch.tensor(prompt["tokens"])})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    step = {"token": toks[:, 8:9]}
    want, _ = ref_transformer.make_decode_fn(ref_cfg, REF_UNSHARDED)(
        jp, ref_state, jax.tree.map(jnp.asarray, step))
    for fn in (transformer.make_decode_fn(cfg, UNSHARDED),
               transformer.make_decode_fn(cfg=cfg, policy=UNSHARDED)):
        _, state = transformer.make_prefill_fn(cfg, UNSHARDED, None)(
            p, {"tokens": torch.tensor(prompt["tokens"])})
        got, _ = fn(p, state, {"token": torch.tensor(step["token"])})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_encdec_stacks_take_the_reference_policy_keyword():
    name = "seamless-m4t-large-v2"
    cfg = get_config(name).reduced().replace(dtype="float32")
    ref_cfg = ref_get_config(name).reduced().replace(dtype="float32")
    gen = torch.Generator().manual_seed(_INIT_STREAM)
    np_params = params_to_numpy(get_model(cfg).init(gen, "cpu"))
    rng = np.random.default_rng((_DATA_STREAM, 1))
    fe = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    p = params_from_numpy(np_params, "cpu")
    want = ref_encdec.encode(jp, jnp.asarray(fe), ref_cfg,
                             policy=REF_UNSHARDED)
    got = encdec.encode(p, torch.tensor(fe), cfg, policy=UNSHARDED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    want = ref_encdec.decode_stack(jp, jnp.asarray(toks), want, ref_cfg,
                                   None, with_cache=False,
                                   policy=REF_UNSHARDED)
    got = encdec.decode_stack(p, torch.tensor(toks), got, cfg, None,
                              with_cache=False, policy=UNSHARDED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_get_model_raises_key_error_and_fedavg_ref_takes_weights():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), family="nope")
    with pytest.raises(KeyError, match="nope"):
        get_model(cfg)
    with pytest.raises(KeyError, match="nope"):
        ref_get_model(dataclasses.replace(ref_get_config(ARCH).reduced(),
                                          family="nope"))
    stacked = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    w = torch.tensor([0.5, 0.25, 0.25])
    assert torch.equal(fedavg_ref(stacked=stacked, weights=w),
                       fedavg_ref(stacked, w))
