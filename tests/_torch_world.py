"""Rank tasks of the distributed parity tests (``test_torch_distributed.py``).

Each function here runs in one spawned rank of a gloo world started by
``repro_torch.launch.world.run_world`` and returns numpy results to the
test process. This module imports only ``numpy``, ``torch`` and
``repro_torch``, so the ranks never import JAX.
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.core.state import params_from_numpy, params_to_numpy
from repro_torch.fl.aggregation import AggregationPlan, flat_psum, hierarchical_psum
from repro_torch.fl.distributed import FLTrainStep
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import ShardingPolicy, get_model
from repro_torch.models.api import flat_params
from repro_torch.optim import sgd
from repro_torch.utils.trees import tree_leaves


def run_tasks(rank: int, world: int, tasks):
    """Every ``(name, kwargs)`` task of ``tasks`` in order, on one
    intra-op thread; returns their results."""
    torch.set_num_threads(1)
    meshes = {}

    def mesh_of(dims, axes):
        key = (tuple(dims), tuple(axes))
        if key not in meshes:
            meshes[key] = RankMesh(dims, axes, device="cpu")
        return meshes[key]

    out = []
    for name, kw in tasks:
        if name not in _TASKS:
            raise ValueError(f"unknown task {name!r}")
        out.append(_TASKS[name](rank, mesh_of, **kw))
    return out


def psum_case(rank, mesh_of, dims, axes, tree, placement, weights, x):
    """Both grouped psums of ``x[rank]`` over the case's mesh."""
    mesh = mesh_of(dims, axes)
    plan = AggregationPlan.build(Hierarchy(*tree[:3], n_clients=tree[3]),
                                 np.asarray(placement), mesh.shape["data"],
                                 weights)
    pod = "pod" if "pod" in axes else None
    stats = []
    hier = hierarchical_psum(torch.tensor(x[rank]), plan, mesh, "data", pod,
                             stats=stats)
    flat = flat_psum(torch.tensor(x[rank]), plan, mesh, "data", pod)
    return {"hier": hier.numpy(), "flat": flat.numpy(),
            "steps": [(s["step"], s["ranks"], s["bytes"]) for s in stats]}


def fl_round(rank, mesh_of, dims, axes, cfg, tree, placement, weights,
             mode, lr, local_steps, params, batch):
    """One FLTrainStep round on the rank path from the given initial
    params; ``batch`` is client-stacked, this rank takes its client's."""
    mesh = mesh_of(dims, axes)
    model = get_model(get_config(cfg[0]).reduced().replace(**cfg[1]),
                      ShardingPolicy(mesh=mesh))
    fl = FLTrainStep(model, sgd(lr), Hierarchy(*tree[:3], n_clients=tree[3]),
                     placement, weights=weights, local_steps=local_steps,
                     mode=mode)
    p = flat_params(params_from_numpy(params, "cpu"))
    leaves = tree_leaves(p)
    own = {k: torch.tensor(v[fl.client_index]) for k, v in batch.items()}
    stats = []
    p, _, metrics = fl.make_round_fn()(p, fl.optimizer.init(p), own,
                                       stats=stats)
    kept = all(a is b for a, b in zip(leaves, tree_leaves(p), strict=True))
    return {"params": params_to_numpy(p), "loss": float(metrics["loss"]),
            "client": fl.client_index, "steps": [s["step"] for s in stats],
            "in_place": kept}


def replica_check(rank, mesh_of, dims, axes, cfg, perturb):
    """``init_stacked`` on the rank path: every rank draws the same
    params; with ``perturb``, rank 0 changes one element first, and the
    checksum all-reduce must raise on every rank."""
    import repro_torch.fl.distributed as fd
    mesh = mesh_of(dims, axes)
    model = get_model(get_config(cfg[0]).reduced().replace(**cfg[1]),
                      ShardingPolicy(mesh=mesh))
    fl = FLTrainStep(model, sgd(0.1), Hierarchy(2, 1, 2, n_clients=4),
                     np.arange(2))
    gen = torch.Generator().manual_seed(0)
    if not perturb:
        params, _ = fl.init_stacked(gen, "cpu")
        return float(fd.flat_buffer_of(params)[:8].sum())
    flat = fd.flat_buffer_of(flat_params(model.init(gen, "cpu")))
    if rank == 0:
        flat[0] += 1.0
    try:
        fd._assert_replicas_equal(flat)
    except RuntimeError as e:
        return str(e)
    return None


_TASKS = {"psum_case": psum_case, "fl_round": fl_round,
          "replica_check": replica_check}
