"""Federated language models: the data (fault F1) and the batched round
engine (fault F2) against the reference on the CPU.

F1: the port's ``make_federated_dataset`` takes the reference's
parameters in the reference's order, ``(model_cfg, n_clients, seed=0,
seq_len=64, alpha=0.5)``, and builds the LM token streams; partitions,
batches and eval batches are numpy and equal bit for bit.

F2: the batched engine hands a family's loss client-stacked params and
batches and sums the losses; every LM family keeps the client dim
through ``models.api.per_client_loss``. Both packages federate reduced
stablelm-1.6b and recurrentgemma-2b (float32 compute) from the
reference's initial params with deterministic timing: placements and
TPDs are numpy and equal exactly, per-round losses within rtol 1e-4 and
final params within rtol 1e-3 / atol 1e-5 (float32 local SGD summed in
other orders, as ``tests/test_torch_emulated.py`` holds the MLP).
"""
import json

import jax
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
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.core.registry import create_strategy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.data import FederatedLMDataset, make_federated_dataset
from repro_torch.fl.orchestrator import FederatedOrchestrator
from repro_torch.models import get_model
from repro_torch.models import mlp as port_mlp
from repro_torch.models.api import per_client_loss
from repro_torch.utils.trees import tree_flatten, tree_leaves, tree_stack

LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
ROUNDS = 3
SEQ_LEN = 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the reduced models' ops are too small
    to gain from more, and spinning thread teams slow many fold when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# F1: the federated datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_mlp_partitions_take_seq_len_as_the_reference(call):
    """The 4th parameter is ``seq_len`` (ignored by the mlp family) and
    ``alpha`` the 5th, so both call forms partition as the reference."""
    args = (6, 0, 16) if call == "positional" else (6,)
    kw = {} if call == "positional" else dict(seed=0, seq_len=8, alpha=0.3)
    want = ref_make_dataset(ref_get_config("mlp-smoke"), *args, **kw)
    got = make_federated_dataset(get_config("mlp-smoke"), *args, **kw)
    assert got.alpha == want.alpha
    assert len(got.partitions) == len(want.partitions)
    for a, b in zip(got.partitions, want.partitions, strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "recurrentgemma-2b",
                                  "granite-8b"])
def test_lm_batches_are_bit_identical(name):
    want = ref_make_dataset(ref_get_config(name).reduced(), 5, 3, SEQ_LEN)
    got = make_federated_dataset(get_config(name).reduced(), 5, 3, SEQ_LEN)
    assert isinstance(got, FederatedLMDataset)
    assert (got.vocab_size, got.seq_len, got.n_clients, got.frontend) == \
        (want.vocab_size, want.seq_len, want.n_clients, want.frontend)
    assert np.array_equal(got.client_weights(), want.client_weights())
    for c, step in ((0, 0), (4, 7)):
        a, b = got.client_batch(c, 3, step), want.client_batch(c, 3, step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    a, b = got.eval_batch(8), want.eval_batch(8)
    assert all(np.array_equal(a[k], b[k]) for k in b)


def test_lm_dataset_resize_matches_the_reference():
    want = ref_make_dataset(ref_get_config("stablelm-1.6b").reduced(), 5)
    got = make_federated_dataset(get_config("stablelm-1.6b").reduced(), 5)
    remap = np.array([0, -1, 1, 2, -1])
    for ds in (want, got):
        ds.resize(remap, 6)
        ds.resize(np.array([0, 1, 2, -1, 3, 4]), 7)
    assert got.stream_of == want.stream_of
    assert got.stream_hwm == want.stream_hwm
    assert np.array_equal(got.client_batch(6, 2, 1)["tokens"],
                          want.client_batch(6, 2, 1)["tokens"])


def test_frontend_families_get_their_stub_shape():
    """The vlm/audio branch on a config of that family without a
    ``frontend_dim``: the reference's frontend tuple (len, d_model)."""
    cfg = get_config("stablelm-1.6b").reduced().replace(
        family="vlm", frontend_len=8, frontend_dim=0)
    ref_cfg = ref_get_config("stablelm-1.6b").reduced().replace(
        family="vlm", frontend_len=8, frontend_dim=0)
    got, want = make_federated_dataset(cfg, 3), ref_make_dataset(ref_cfg, 3)
    assert got.frontend == want.frontend == (8, 256)
    a, b = got.client_batch(1, 2, 0), want.client_batch(1, 2, 0)
    assert np.array_equal(a["frontend"], b["frontend"])


# ---------------------------------------------------------------------------
# F2: the client dim of the LM losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["stablelm-1.6b", "recurrentgemma-2b"])
def test_client_stacked_loss_is_each_clients_own(name):
    """With a leading client dim the loss keeps it, and each client's
    gradient is its own loss's gradient."""
    cfg = get_config(name).reduced().replace(dtype="float32")
    model = get_model(cfg)
    g = torch.Generator().manual_seed(0)
    ps = [model.init(g, "cpu") for _ in range(3)]
    data = make_federated_dataset(cfg, 3, 0, SEQ_LEN)
    bs = [{k: torch.tensor(v) for k, v in data.client_batch(c, 2, 0).items()}
          for c in range(3)]
    stack = tree_stack(ps)
    batch = tree_stack(bs)
    leaves, rebuild = tree_flatten(stack)
    live = [x.detach().requires_grad_() for x in leaves]
    losses, metrics = model.loss_fn(rebuild(live), batch)
    assert tuple(losses.shape) == (3,) and tuple(metrics["xent"].shape) == (3,)
    grads = torch.autograd.grad(losses.sum(), live, allow_unused=True)
    for c in range(3):
        one_leaves, one_rebuild = tree_flatten(ps[c])
        one_live = [x.detach().requires_grad_() for x in one_leaves]
        loss, _ = model.loss_fn(one_rebuild(one_live), bs[c])
        assert torch.equal(loss.detach(), losses[c].detach())
        one = torch.autograd.grad(loss, one_live, allow_unused=True)
        for a, b in zip(grads, one, strict=True):
            if b is None:
                assert a is None or not a[c].any()
            else:
                assert torch.allclose(a[c], b, rtol=1e-5, atol=1e-7)


def test_per_client_loss_passes_one_client_through():
    def loss_fn(params, batch):
        return (params["w"] * batch["tokens"].float()).mean(), {"n": batch[
            "tokens"].sum()}
    wrapped = per_client_loss(loss_fn)
    one = {"tokens": torch.ones(2, 3, dtype=torch.int32)}
    assert float(wrapped({"w": torch.tensor(2.0)}, one)[0]) == 2.0
    loss, metrics = wrapped({"w": torch.tensor([1.0, 3.0])},
                            {"tokens": torch.ones(2, 2, 3, dtype=torch.int32)})
    assert loss.tolist() == [1.0, 3.0] and metrics["n"].tolist() == [6, 6]


def test_mlp_keeps_its_native_stacked_loss():
    """The paper MLP's loss is not wrapped: its client-stacked forward is
    the batched products the Fig. 4 path and its counts rely on."""
    assert get_model(get_config("mlp-smoke")).loss_fn is port_mlp.mlp_loss


def _federate(name, strategy, seed=1):
    """Both packages' batched engines over ROUNDS rounds of ``name``
    reduced (float32) from the reference's initial params."""
    ref_cfg = ref_get_config(name).reduced().replace(dtype="float32")
    cfg = get_config(name).reduced().replace(dtype="float32")
    runs = []
    for pkg in ("ref", "port"):
        H, Pool = (RefHierarchy, RefClientPool) if pkg == "ref" else \
            (Hierarchy, ClientPool)
        h = H(depth=2, width=2, trainers_per_leaf=1, n_clients=7)
        pool = Pool.random(h.total_clients, seed=seed)
        if pkg == "ref":
            orch = RefOrchestrator(
                ref_get_model(ref_cfg), h, pool,
                ref_make_dataset(ref_cfg, h.total_clients, seed, SEQ_LEN),
                local_steps=2, batch_size=2, seed=seed,
                timing="deterministic", engine="batched")
            init = jax.tree.map(np.asarray, orch.params)
            strat = ref_create_strategy(strategy, h, seed=seed, clients=pool)
        else:
            orch = FederatedOrchestrator(
                get_model(cfg), h, pool,
                make_federated_dataset(cfg, h.total_clients, seed, SEQ_LEN),
                local_steps=2, batch_size=2, seed=seed,
                timing="deterministic", engine="batched", device="cpu")
            orch.set_global(params_from_numpy(init, device="cpu"))
            strat = create_strategy(strategy, h, seed=seed, clients=pool)
        res = orch.run(strat, rounds=ROUNDS)
        runs.append((res, orch))
    return runs


@pytest.mark.parametrize("name,strategy", [("stablelm-1.6b", "pso"),
                                           ("recurrentgemma-2b", "pso"),
                                           ("stablelm-1.6b", "random")])
def test_federated_lm_rounds_match_reference(name, strategy):
    (want, ref_orch), (got, orch) = _federate(name, strategy)
    assert [r.placement for r in got.rounds] == \
        [r.placement for r in want.rounds]
    assert got.tpds.tolist() == want.tpds.tolist()
    np.testing.assert_allclose([r.loss for r in got.rounds],
                               [r.loss for r in want.rounds], rtol=LOSS_RTOL)
    assert all(np.isfinite(r.loss) for r in got.rounds)
    for a, b in zip(tree_leaves(params_to_numpy(orch.params)),
                    jax.tree.leaves(ref_orch.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), **PARAM_TOL)


def test_launch_train_federates_a_dense_model_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    out = tmp_path / "rounds.json"
    assert main(["--arch", "stablelm-1.6b", "--strategy", "pso",
                 "--clients", "7", "--rounds", "2", "--local-steps", "1",
                 "--batch-size", "2", "--out", str(out)], device="cpu") == 0
    record = json.loads(out.read_text())
    assert record["summary"]["rounds"] == 2
    assert all(np.isfinite(r["loss"]) for r in record["rounds"])
    assert '"strategy": "pso"' in capsys.readouterr().out
