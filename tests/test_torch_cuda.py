"""The port's kernels on the card, held to their plain torch versions.

Every test here is marked ``cuda`` and skips on a host without a card.
This file imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch for CUDA and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.hierarchy import ClientPool, Hierarchy
from repro_torch.kernels.ref import tpd_ref
from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs

# (depth, width, trainers/leaf, clients)
SHAPES = [(3, 4, 2, 60), (4, 3, 2, 200), (2, 5, 3, None), (5, 5, 2, None),
          (6, 4, 2, 10000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _operands(shape, P, penalty, device):
    depth, width, tpl, n = shape
    h = Hierarchy(depth, width, tpl, n)
    C = h.total_clients
    rng = np.random.default_rng(depth * 10 + width)
    pool = ClientPool.random(C, seed=depth)
    pool.mdatasize = rng.uniform(1.0, 40.0, C)
    ps = np.stack([rng.permutation(C)[:h.dimensions]
                   for _ in range(P)]).astype(np.int32)
    ps[-1, 1] = ps[-1, 0]  # a duplicate-id row
    cm = CostModel(h, pool, memory_penalty=penalty, device=device)
    return h, cm, ps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("penalty", [0.0, 3.0])
def test_kernel_equals_plain_version(cuda_device, shape, penalty):
    h, cm, ps = _operands(shape, 33, penalty, cuda_device)
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    leaf = leaf_loads(p, attrs[0], h.n_leaves)
    tables = tpd_kernel_inputs(h, device=cuda_device)
    before = batch_tpd_cuda.launches
    got = batch_tpd_cuda(p, attrs, leaf, *tables, penalty=penalty)
    torch.cuda.synchronize()
    assert batch_tpd_cuda.launches == before + 1
    want = tpd_ref(p, attrs, leaf, *tables, penalty=penalty)
    assert torch.equal(got, want)  # atol 0
    np.testing.assert_allclose(got.cpu().numpy()[:3],
                               [cm.tpd(row) for row in ps[:3]], rtol=2e-5)


@pytest.mark.cuda
def test_cost_model_kernel_backend_matches_torch_backend(cuda_device):
    h, cm, ps = _operands(SHAPES[1], 12, 3.0, cuda_device)
    np.testing.assert_array_equal(cm.batch_tpd(ps),  # auto: the kernel
                                  cm.batch_tpd(ps, backend="torch"))
    np.testing.assert_array_equal(cm.batch_tpd(ps, backend="kernel"),
                                  cm.batch_tpd(ps, backend="np"))


@pytest.mark.cuda
def test_wrapper_rejects_malformed_operands(cuda_device):
    h, cm, ps = _operands(SHAPES[0], 4, 0.0, cuda_device)
    p = torch.as_tensor(ps, device=cuda_device)
    attrs = torch.as_tensor(cm._attr_stack(np.float32), device=cuda_device)
    leaf = leaf_loads(p, attrs[0], h.n_leaves)
    kids, starts = tpd_kernel_inputs(h, device=cuda_device)
    before = batch_tpd_cuda.launches
    with pytest.raises(ValueError, match="level_starts"):
        batch_tpd_cuda(p, attrs, leaf, kids, starts[:-1] + (starts[-1] + 1,))
    with pytest.raises(TypeError, match="placements"):
        batch_tpd_cuda(p.long(), attrs, leaf, kids, starts)
    with pytest.raises(ValueError, match="leaf_load"):
        batch_tpd_cuda(p, attrs, leaf[:, 1:].contiguous(), kids, starts)
    assert batch_tpd_cuda.launches == before
