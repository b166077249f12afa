"""The paper MLP, its data and its configs: port vs reference on the CPU.

Exact where the reference is numpy (configs, the synthetic data and its
partitions, batch draws, the params bridge); float32 tolerances where it
is float math (loss, gradients, a round of local training), because
XLA and PyTorch sum the matrix products in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.hierarchy import ClientPool as RefPool
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.data.synthetic import make_federated_dataset as ref_make_dataset
from repro.fl.orchestrator import FederatedOrchestrator as RefOrchestrator
from repro.models import get_model as ref_get_model
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model
from repro_torch.models.common import dense_init
from repro_torch.utils.trees import tree_leaves, tree_size

_TEST_STREAM = 7  # init key of the reference params the tests copy in
MLPS = ["mlp-smoke", "paper-mlp-1m8"]


def _ref_params(name, seed=_TEST_STREAM):
    model = ref_get_model(ref_get_config(name))
    return model, jax.tree.map(np.asarray, model.init(jax.random.key(seed)))


@pytest.mark.parametrize("name", MLPS)
def test_configs_are_copied_field_for_field(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(ref_get_config(name))


def test_other_families_name_their_roadmap_item():
    """Every architecture of the reference is registered (the vlm and
    audio families since ROADMAP.md item 11b-4); an unknown name raises."""
    assert dataclasses.asdict(get_config("llava-next-mistral-7b")) == \
        dataclasses.asdict(ref_get_config("llava-next-mistral-7b"))
    with pytest.raises(KeyError):
        get_config("no-such-model")


def test_synthetic_data_is_bit_identical():
    cfg = get_config("mlp-smoke")
    ref = ref_make_dataset(ref_get_config("mlp-smoke"), 13, seed=4)
    port = make_federated_dataset(cfg, 13, seed=4)
    assert np.array_equal(port.base.features, ref.base.features)
    assert np.array_equal(port.base.labels, ref.base.labels)
    assert np.array_equal(port.base.centers, ref.base.centers)
    assert len(port.partitions) == len(ref.partitions) == 13
    for a, b in zip(port.partitions, ref.partitions, strict=True):
        assert np.array_equal(a, b)
    assert np.array_equal(port.client_weights(), ref.client_weights())
    for c, step in ((0, 0), (5, 3), (12, 17)):
        pa, pb = port.client_batch(c, 32, step), ref.client_batch(c, 32, step)
        assert np.array_equal(pa["x"], pb["x"])
        assert np.array_equal(pa["y"], pb["y"])
    # an elastic resize: two leave, three join, same provisioning stream
    remap = np.array([0, -1, 1, 2, 3, -1, 4, 5, 6, 7, 8, 9, 10])
    port.resize(remap, 14, np.random.default_rng((4, 99)))
    ref.resize(remap, 14, np.random.default_rng((4, 99)))
    for a, b in zip(port.partitions, ref.partitions, strict=True):
        assert np.array_equal(a, b)
    assert port.stream_of == ref.stream_of
    assert port.stream_hwm == ref.stream_hwm
    assert np.array_equal(port.client_batch(13, 16, 2)["x"],
                          ref.client_batch(13, 16, 2)["x"])


def test_params_bridge_round_trip():
    _, ref = _ref_params("paper-mlp-1m8")
    port = params_from_numpy(ref, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(port)] == \
        [x.shape for x in jax.tree.leaves(ref)]
    assert tree_size(port) == 1_791_754
    back = params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a bfloat16 leaf crosses exactly
    bf = {"w": (np.arange(6, dtype=np.float32).reshape(2, 3) / 3).astype(
        ml_dtypes.bfloat16)}
    t = params_from_numpy(bf, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(params_to_numpy({"w": t})["w"],
                          bf["w"].astype(np.float32))


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(_TEST_STREAM)
    x = dense_init(g, (784, 768), torch.float32)
    std = 1.0 / np.sqrt(784)
    assert float(x.abs().max()) <= 3 * std
    # a standard normal cut at +-3 has std 0.9865
    assert abs(float(x.std()) / std - 0.9865) < 0.01
    g2 = torch.Generator().manual_seed(_TEST_STREAM)
    assert torch.equal(x, dense_init(g2, (784, 768), torch.float32))


@pytest.mark.parametrize("name", MLPS)
def test_loss_and_gradient_match_reference(name):
    model_r, ref = _ref_params(name)
    model = get_model(get_config(name))
    data = make_federated_dataset(get_config(name), 4, seed=1)
    batch = data.client_batch(2, 32, 0)
    (l_r, m_r), g_r = jax.value_and_grad(model_r.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, ref), batch)
    params = params_from_numpy(ref, device="cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    loss, m = model.loss_fn(params, {"x": torch.from_numpy(batch["x"]),
                                     "y": torch.from_numpy(batch["y"])})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(l_r), rtol=1e-6)
    assert float(m["acc"]) == float(m_r["acc"])
    for a, b in zip(grads, jax.tree.leaves(g_r), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def test_client_stacked_forward_is_per_client():
    _, ref = _ref_params("mlp-smoke")
    model = get_model(get_config("mlp-smoke"))
    p = params_from_numpy(ref, device="cpu")
    q = jax.tree.map(lambda a: a * np.float32(0.5), ref)
    q = params_from_numpy(q, device="cpu")
    stacked = {"layers": [{k: torch.stack([a[k], b[k]]) for k in a}
                          for a, b in zip(p["layers"], q["layers"],
                                          strict=True)]}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 784)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2, 8)).astype(np.int32))
    loss, m = model.loss_fn(stacked, {"x": x, "y": y})
    assert tuple(loss.shape) == (2,)
    for c, params in enumerate((p, q)):
        lc, mc = model.loss_fn(params, {"x": x[c], "y": y[c]})
        np.testing.assert_allclose(float(loss[c]), float(lc), rtol=1e-6)
        assert float(m["acc"][c]) == float(mc["acc"])


@pytest.mark.parametrize("name,local_steps,batch_size", [
    ("mlp-smoke", 3, 16), ("paper-mlp-1m8", 2, 32)])
def test_batched_local_training_matches_reference(name, local_steps,
                                                  batch_size):
    """One round of the batched engine's local training (every client's
    SGD steps from the same global params) against the reference's
    ``_train_all_batched``, params copied in from the reference."""
    seed = 2
    rh, h = RefHierarchy(2, 2, 2, n_clients=9), Hierarchy(2, 2, 2,
                                                          n_clients=9)
    ref_model = ref_get_model(ref_get_config(name))
    ref = RefOrchestrator(
        ref_model, rh, RefPool.random(9, seed=seed),
        ref_make_dataset(ref_get_config(name), 9, seed=seed),
        local_steps=local_steps, batch_size=batch_size, seed=seed,
        timing="deterministic", engine="batched")
    port = FederatedOrchestrator(
        get_model(get_config(name)), h, ClientPool.random(9, seed=seed),
        make_federated_dataset(get_config(name), 9, seed=seed),
        local_steps=local_steps, batch_size=batch_size, seed=seed,
        timing="deterministic", engine="batched", device="cpu")
    port.set_global(params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                      device="cpu"))
    want, t_want = ref._train_all_batched(3)
    got, t_got = port._train_all_batched(3)
    assert np.array_equal(t_got, t_want)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=2e-6)
