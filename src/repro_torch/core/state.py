"""Carrying a reference run's state into the port.

The client pool and the swarm are what weights are to a model: the
state a run is made of. Both cross over as plain arrays and dicts — the
reference's ``FlagSwapPSO.state_dict()`` is JSON-able — so nothing of
the reference package is imported here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hierarchy import ClientPool
from repro_torch.core.pso import FlagSwapPSO

# the constructor's own draws are overwritten by load_state, the rng
# stream included, so this seed never shows in a restored swarm
_RESTORE_STREAM = 0


def pool_from_numpy(memcap, pspeed, mdatasize) -> ClientPool:
    """A port :class:`ClientPool` holding float64 copies of the arrays."""
    return ClientPool(memcap=np.array(memcap, np.float64),
                      pspeed=np.array(pspeed, np.float64),
                      mdatasize=np.array(mdatasize, np.float64))


def swarm_from_state(d: dict) -> FlagSwapPSO:
    """A port :class:`FlagSwapPSO` restored from a ``state_dict()``
    (positions, velocities, bests, history and the rng state): it
    continues bit for bit where the captured swarm left off."""
    pso = FlagSwapPSO(int(d["n_slots"]), int(d["n_clients"]),
                      n_particles=int(d["n_particles"]),
                      seed=_RESTORE_STREAM)
    pso.load_state(d)
    return pso
