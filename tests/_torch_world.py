"""Rank tasks of the distributed parity tests (``test_torch_distributed.py``,
``test_torch_tensor_parallel.py``, ``test_torch_fsdp.py``,
``test_torch_fl_tp.py``).

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
from repro_torch.utils.trees import tree_flatten, tree_leaves, tree_map


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


def _live(tree):
    leaves, rebuild = tree_flatten(tree)
    live = [x.detach().requires_grad_() for x in leaves]
    return live, rebuild


def fsdp_case(rank, mesh_of, dims, axes, cfg, seq, fsdp, params, batch,
              prompt, steps):
    """The decoder on a mesh with batch axes beside the model axis:
    ``make_policy(mesh, fsdp=fsdp, seq_shard=seq)``, ``params`` (a full
    numpy tree) cut into this rank's shards. The global batch's loss and
    its gradients (gathered to full on rank 0; the norms' own gradients
    on every rank); the prefill logits of ``prompt`` and the logits of
    teacher-forced decode steps, with the same policy and with fsdp off
    (the reference's decode layout, the params cut again), each gathered
    to every rank; the cache's local shape."""
    mesh = mesh_of(dims, axes)
    mesh.traffic.clear()
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    full = params_from_numpy(params, "cpu")
    model = get_model(config, make_policy(mesh, fsdp=fsdp, seq_shard=seq))
    specs = model.param_pspecs()
    local = shard_params(full, specs, mesh)
    live, rebuild = _live(local)
    t = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(rebuild(live), t)
    grads = rebuild(list(torch.autograd.grad(loss, live)))
    gathered = gather_params(grads, specs, mesh)
    norms = {k: grads["layers"][k]["scale"].numpy() for k in ("ln1", "ln2")}
    norms["ln_f"] = grads["ln_f"]["scale"].numpy()
    traffic = dict(mesh.traffic)
    out = {"loss": float(loss.detach()), "norms": norms, "traffic": traffic,
           "grads": params_to_numpy(gathered) if rank == 0 else None}
    decoders = {"same": (model, local)}
    if fsdp:
        plain = get_model(config, make_policy(mesh, seq_shard=seq))
        decoders["fsdp-off"] = (plain, shard_params(
            full, plain.param_pspecs(), mesh))
    with torch.no_grad():
        logits, state = model.prefill_fn(
            local, {k: torch.tensor(v) for k, v in prompt.items()})
        out["prefill"] = logits.numpy()
        out["cache"] = tuple(state["cache"]["k"].shape)
        first = {k: v.clone() for k, v in state["cache"].items()}
        for tag, (m, p) in decoders.items():
            st = {"cache": {k: v.clone() for k, v in first.items()},
                  "pos": state["pos"]}
            seq_logits = []
            for j in range(steps.shape[1]):
                logits, st = m.decode_fn(
                    p, st, {"token": torch.tensor(steps[:, j:j + 1])})
                seq_logits.append(logits.numpy())
            out[f"decode-{tag}"] = seq_logits
    return out


def _scales(tree) -> dict:
    """The norms' leaves of a param tree (any family), numpy."""
    from repro_torch.utils.trees import tree_map_with_path
    out = {}
    tree_map_with_path(lambda path, x: out.__setitem__(
        path, x.detach().numpy()) if path.endswith("scale") else None, tree)
    return out


def _without_pos(state):
    return {k: v for k, v in state.items() if k != "pos"}


def family_case(rank, mesh_of, dims, axes, cfg, seq, fsdp, params, batch,
                prompt, steps):
    """Any family's model on a ``make_policy(mesh, fsdp=fsdp,
    seq_shard=seq)`` rank mesh, ``params`` (a full numpy tree) cut into
    this rank's shards: the global batch's loss and its gradients
    (gathered to full on rank 0), each rank's own gradients of the
    leaves its spec replicates over every axis; the prefill
    logits of ``prompt`` and the logits of teacher-forced decode steps
    (``steps``: (B, n) tokens), each gathered to every rank; the decode
    state after prefill and after the steps, gathered to full by
    ``state_pspecs`` on rank 0, and its local shapes."""
    from repro_torch.utils.trees import tree_map_with_path
    mesh = mesh_of(dims, axes)
    mesh.traffic.clear()
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    model = get_model(config, make_policy(mesh, fsdp=fsdp, seq_shard=seq))
    specs = model.param_pspecs()
    local = shard_params(params_from_numpy(params, "cpu"), specs, mesh)
    live, rebuild = _live(local)
    t = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(rebuild(live), t)
    grads = rebuild(list(torch.autograd.grad(loss, live)))
    replicated = {}
    tree_map_with_path(lambda path, g, spec: replicated.__setitem__(
        path, g.numpy()) if all(e is None for e in spec) else None, grads,
        specs)
    full = gather_params(grads, specs, mesh)   # on every rank
    out = {"loss": float(loss.detach()), "replicated": replicated,
           "traffic": dict(mesh.traffic),
           "grads": params_to_numpy(full) if rank == 0 else None}
    rows = next(iter(prompt.values())).shape[0]

    def gathered(state):
        # the state rule reads the batch and the head or channel dims
        sspecs = _without_pos(model.state_pspecs(rows, state["pos"] + 1))
        full = gather_params(_without_pos(state), sspecs, mesh)
        # a copy: decode writes the caches in place
        return params_to_numpy(tree_map(torch.clone, full)) if rank == 0 \
            else None

    with torch.no_grad():
        logits, state = model.prefill_fn(
            local, {k: torch.tensor(v) for k, v in prompt.items()})
        out["logits"] = [logits.numpy()]
        out["local_state"] = {k: tuple(v.shape) for k, v in _paths(
            _without_pos(state))}
        out["state"] = [gathered(state)]
        for j in range(steps.shape[1]):
            logits, state = model.decode_fn(
                local, state, {"token": torch.tensor(steps[:, j:j + 1])})
            out["logits"].append(logits.numpy())
        out["state"].append(gathered(state))
    return out


def answer_case(rank, mesh_of, dims, arch, fsdp, seq):
    """A reduced ``arch`` on ``make_policy(mesh, fsdp=fsdp,
    seq_shard=seq)``: the seeded init cut into this rank's shards, the
    loss of a global batch of 2 and the prefill logits of a 2-row
    prompt (a stub frontend for the audio family)."""
    mesh = mesh_of(dims, ("data", "model"))
    cfg = get_config(arch).reduced()
    model = get_model(cfg, make_policy(mesh, fsdp=fsdp, seq_shard=seq))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frontend"] = torch.randn(
            (2, cfg.frontend_len, cfg.d_model), generator=gen)
    loss, _ = model.loss_fn(params, batch)
    with torch.no_grad():
        logits, _ = model.prefill_fn(params, {k: v for k, v in batch.items()
                                              if k != "labels"})
    return {"loss": float(loss.detach()), "logits": logits.numpy()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def clip_case(rank, mesh_of, dims, axes, cfg, fsdp, params, batches, lr,
              clip, sgd_lr=None):
    """The gradient clip on this rank's shards (``make_policy(mesh,
    fsdp=fsdp)``): the global norm of the first batch's gradient (and
    the rank's own, the norm the clip read before it was global); one
    ``sgd(sgd_lr or lr, grad_clip=clip)`` step; ``len(batches)`` steps of
    ``make_train_step`` with ``adamw(lr, grad_clip=clip)``. The params
    after each, gathered to full on rank 0, the losses, and each rank's
    norm scales after the AdamW steps."""
    from repro_torch.models.api import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.utils.trees import tree_global_norm
    mesh = mesh_of(dims, axes)
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    model = get_model(config, make_policy(mesh, fsdp=fsdp))
    specs = model.param_pspecs()
    full = params_from_numpy(params, "cpu")
    ts = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    live, rebuild = _live(shard_params(full, specs, mesh))
    loss, _ = model.loss_fn(rebuild(live), ts[0])
    grads = rebuild(list(torch.autograd.grad(loss, live)))
    out = {"norm": float(global_norm(grads, (specs, mesh))),
           "local_norm": float(tree_global_norm(grads))}
    gathered = lambda p: params_to_numpy(gather_params(p, specs, mesh))
    p = flat_params(shard_params(full, specs, mesh))
    opt = sgd(sgd_lr or lr, grad_clip=clip)
    p, _, _ = make_train_step(model, opt)(p, opt.init(p), ts[0])
    out["sgd"] = gathered(p)
    p = flat_params(shard_params(full, specs, mesh))
    opt = adamw(lr, grad_clip=clip)
    step, state, losses = make_train_step(model, opt), opt.init(p), []
    for b in ts:
        p, state, m = step(p, state, b)
        losses.append(float(m["loss"]))
    out["adamw"], out["losses"] = gathered(p), losses
    out["scales"] = _scales(p)
    if rank:
        out["sgd"] = out["adamw"] = None
    return out


def loop_case(rank, mesh_of, dims, axes, cfg, fsdp, batches, lr, ckpt):
    """``TrainLoop`` on this rank (``make_policy(mesh, fsdp=fsdp)``,
    ``adamw(lr)``, seed 0, a checkpoint every step under ``ckpt``,
    resuming from the newest one there): its metrics log and its final
    params, gathered to full on rank 0."""
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig
    mesh = mesh_of(dims, axes)
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    model = get_model(config, make_policy(mesh, fsdp=fsdp))
    loop = TrainLoop(model, adamw(lr), lambda step: batches[step],
                     TrainLoopConfig(total_steps=len(batches), log_every=1,
                                     save_every=1, checkpoint_dir=ckpt),
                     device="cpu")
    start = loop.start_step
    log = loop.run()["metrics_log"]
    params = params_to_numpy(gather_params(loop.params, model.param_pspecs(),
                                           mesh))
    return {"start": start, "log": log,
            "params": params if rank == 0 else None}


def fl_tp_round(rank, mesh_of, dims, cfg, seq, tree, placement, mode, lr,
                local_steps, params, batch):
    """One FLTrainStep round of tensor-parallel clients on a ``("data",
    "model")`` mesh, the reference's federated policy (model axis, seq
    axis when ``seq``, no batch or fsdp axes): ``init_stacked``'s params
    gathered over the model axis, then this rank's shards of ``params``
    (a full numpy tree), its client's rows of the client-stacked
    ``batch``, one round; the params after it gathered over the model
    axis (each data coordinate's), this rank's own shards, the loss."""
    mesh = mesh_of(dims, ("data", "model"))
    config = get_config(cfg[0]).reduced().replace(**cfg[1])
    policy = ShardingPolicy(mesh=mesh, model_axis="model",
                            seq_axis="model" if seq else None)
    model = get_model(config, policy)
    specs = model.param_pspecs()
    fl = FLTrainStep(model, sgd(lr), Hierarchy(*tree[:3], n_clients=tree[3]),
                     placement, local_steps=local_steps, mode=mode)
    drawn, _ = fl.init_stacked(torch.Generator().manual_seed(0), "cpu")
    drawn = params_to_numpy(gather_params(drawn, specs, mesh))
    p = flat_params(shard_params(params_from_numpy(params, "cpu"), specs,
                                 mesh))
    own = {k: torch.tensor(v[fl.client_index]) for k, v in batch.items()}
    stats = []
    p, _, metrics = fl.make_round_fn()(p, fl.optimizer.init(p), own,
                                       stats=stats)
    return {"params": params_to_numpy(gather_params(p, specs, mesh)),
            "local": params_to_numpy(p), "loss": float(metrics["loss"]),
            "client": fl.client_index, "model": mesh.axis_index("model"),
            "steps": [s["step"] for s in stats],
            "init": drawn if rank == 0 else None}


def fsdp_card_step(rank, world, cfg, batch):
    """A rank of ``test_torch_cuda.py``'s fsdp step on the card (a
    module-level target of ``run_world``): a (2, 2) ``("data",
    "model")`` mesh, ``make_policy(mesh, fsdp=True, seq_shard=True)``,
    this rank's shards of the seeded init, one ``make_train_step`` step
    with ``adamw(1e-3)``; the loss, the params after it gathered to full
    (rank 0) and the rank's fused AdamW launches."""
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.models.api import make_train_step
    from repro_torch.optim import adamw
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    mesh = RankMesh((2, 2), ("data", "model"), device="cuda")
    model = get_model(cfg, make_policy(mesh, fsdp=True, seq_shard=True))
    params = flat_params(model.init(torch.Generator("cuda").manual_seed(0),
                                    "cuda"))
    opt = adamw(1e-3)
    kadamw.fused_adamw.launches = 0
    params, _, metrics = make_train_step(model, opt)(
        params, opt.init(params),
        {k: torch.tensor(v, device="cuda") for k, v in batch.items()})
    full = gather_params(params, model.param_pspecs(), mesh)
    torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]),
            "adamw": kadamw.fused_adamw.launches,
            "params": params_to_numpy(full) if rank == 0 else None}


_TASKS = {"psum_case": psum_case, "fl_tp_round": fl_tp_round, "fl_round": fl_round,
          "replica_check": replica_check, "tp_case": tp_case,
          "fsdp_case": fsdp_case, "clip_case": clip_case,
          "loop_case": loop_case, "family_case": family_case,
          "answer_case": answer_case}
