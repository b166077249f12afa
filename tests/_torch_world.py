"""Rank tasks of the distributed parity tests (``test_torch_distributed.py``,
``test_torch_tensor_parallel.py``).

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
from repro_torch.models import ShardingPolicy, get_model, make_policy
from repro_torch.models.api import flat_params
from repro_torch.models.tensor_parallel import gather_params, shard_params
from repro_torch.optim import sgd
from repro_torch.utils.trees import tree_flatten, tree_leaves


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


def tp_case(rank, mesh_of, dims, cfg, seq, params, batch, prompt, steps,
            stream):
    """The model-axis decoder on this rank: ``params`` (a full numpy
    tree) cut into its shards; the loss and its gradients (gathered back
    to full, and each rank's own gradients of the norms), the prefill
    logits of ``prompt`` and the logits of teacher-forced decode steps
    (``steps``: (B, n) tokens), each gathered to every rank; and the
    first layer's ``attention_block`` and ``make_block_fn`` block over
    ``stream`` (B, S, D), gathered along S."""
    mesh = mesh_of(dims, ("data", "model"))
    mesh.traffic.clear()          # this task's collectives only
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    policy = make_policy(mesh, seq_shard=seq)
    model = get_model(config, policy)
    specs = model.param_pspecs()
    local = shard_params(params_from_numpy(params, "cpu"), specs, mesh)
    leaves, rebuild = tree_flatten(local)
    live = [x.detach().requires_grad_() for x in leaves]
    t = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(rebuild(live), t)
    grads = rebuild(list(torch.autograd.grad(loss, live)))
    full = gather_params(grads, specs, mesh)
    back = tree_leaves(gather_params(local, specs, mesh))
    roundtrip = all(torch.equal(a, torch.tensor(b)) for a, b in zip(
        back, tree_leaves(params), strict=True))
    norms = {k: grads["layers"][k]["scale"].numpy() for k in ("ln1", "ln2")}
    norms["ln_f"] = grads["ln_f"]["scale"].numpy()
    with torch.no_grad():
        logits, state = model.prefill_fn(
            local, {k: torch.tensor(v) for k, v in prompt.items()})
        out = [logits.numpy()]
        for j in range(steps.shape[1]):
            logits, state = model.decode_fn(
                local, state, {"token": torch.tensor(steps[:, j:j + 1])})
            out.append(logits.numpy())
        blocks = _tp_blocks(mesh, config, policy, local, torch.tensor(stream))
    shapes = {k: tuple(v.shape) for k, v in state["cache"].items()}
    return {"loss": float(loss.detach()), "norms": norms, "logits": out,
            "grads": params_to_numpy(full) if rank == 0 else None,
            "cache": shapes, "traffic": dict(mesh.traffic),
            "roundtrip": roundtrip, "blocks": blocks}


def _tp_blocks(mesh, cfg, policy, local, x):
    """``attention_block`` and ``make_block_fn``'s block of the first
    layer on this rank over ``x`` (its S / M positions under sequence
    parallelism), gathered back along S."""
    from repro_torch.models import common, transformer
    from repro_torch.utils.trees import tree_unstack
    layer = tree_unstack(local["layers"])[0]
    s, m = x.shape[1], mesh.shape["model"]
    seq_on = policy.seq_axis is not None and s % m == 0
    if seq_on:
        k = s // m
        x = x[:, mesh.axis_index("model") * k:(mesh.axis_index("model") + 1)
              * k]
    h = transformer.attention_block(
        layer["attn"], common.rmsnorm(layer["ln1"], x, cfg.norm_eps), cfg,
        policy, torch.arange(s), None)
    (y, _), _ = transformer.make_block_fn(cfg, policy, None)(
        (x, torch.zeros(())), layer, seq_len=s if seq_on else None)
    if seq_on:
        h, y = (mesh.all_gather(t, "model", 1) for t in (h, y))
    return {"attention": h.float().numpy(), "block": y.float().numpy()}


def tp_card_prefill(rank, world, cfg, prompt):
    """A rank of ``test_torch_cuda.py``'s model-axis prefill on the card
    (a module-level target of ``run_world``): this rank's shards of the
    seeded init, the prefill logits of ``prompt`` and the rank's flash
    launches by head counts."""
    from repro_torch.kernels import flash_attention as kflash
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    mesh = RankMesh((1, world), ("data", "model"), device="cuda")
    model = get_model(cfg, make_policy(mesh))
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    kflash.flash_attention.heads.clear()
    with torch.no_grad():
        logits, state = model.prefill_fn(params, {
            "tokens": torch.tensor(prompt, device="cuda")})
    torch.cuda.synchronize()
    return {"logits": logits.float().cpu().numpy(),
            "heads": dict(kflash.flash_attention.heads),
            "cache": tuple(state["cache"]["k"].shape)}


_TASKS = {"psum_case": psum_case, "fl_round": fl_round,
          "replica_check": replica_check, "tp_case": tp_case}
