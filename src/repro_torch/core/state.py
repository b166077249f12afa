"""Carrying a reference run's state into the port.

The client pool and the swarm are what weights are to a model: the
state a run is made of. Both cross over as plain arrays and dicts — the
reference's ``FlagSwapPSO.state_dict()`` is JSON-able — and so do model
params: a reference param tree turned into numpy arrays
(``jax.tree.map(np.asarray, params)``) becomes the port's tree of
tensors key for key. Nothing of the reference package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hierarchy import ClientPool
from repro_torch.core.pso import FlagSwapPSO
from repro_torch.device import resolve_device
from repro_torch.utils.trees import tree_map

# the constructor's own draws are overwritten by load_state, the rng
# stream included, so this seed never shows in a restored swarm
_RESTORE_STREAM = 0


def pool_from_numpy(memcap, pspeed, mdatasize) -> ClientPool:
    """A port :class:`ClientPool` holding float64 copies of the arrays."""
    return ClientPool(memcap=np.array(memcap, np.float64),
                      pspeed=np.array(pspeed, np.float64),
                      mdatasize=np.array(mdatasize, np.float64))


def params_from_numpy(tree, device="cuda"):
    """A param tree of numpy arrays (dicts and lists, the reference's
    layout) -> the same tree of tensors on ``device``, copied. A
    bfloat16 array (numpy's ``ml_dtypes`` extension type) keeps its
    dtype: it crosses as float32, which holds it exactly."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=dev).to(
                torch.bfloat16)
        return torch.tensor(a, device=dev)

    return tree_map(one, tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: numpy copies on the host
    (a bfloat16 leaf comes back as float32, exactly)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


def swarm_from_state(d: dict) -> FlagSwapPSO:
    """A port :class:`FlagSwapPSO` restored from a ``state_dict()``
    (positions, velocities, bests, history and the rng state): it
    continues bit for bit where the captured swarm left off."""
    pso = FlagSwapPSO(int(d["n_slots"]), int(d["n_clients"]),
                      n_particles=int(d["n_particles"]),
                      seed=_RESTORE_STREAM)
    pso.load_state(d)
    return pso
