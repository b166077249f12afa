"""The TPD cost model (paper eqs. 6-7) — scalar and particle-vectorized.

    d_a = (mdatasize_a + sum_{c in children(a)} mdatasize_c) / pspeed_a
    TPD = sum_levels max_{a in level} d_a

The max-per-level captures the bottleneck effect (aggregators at one
level run in parallel; levels are serial, bottom-up). An optional memory
penalty inflates d_a when the buffer exceeds the host's memcap — the
"compute memory consumption" line of Algorithm 1.

The port's ``CostModel``, held to ``repro.core.cost_model.CostModel``:

* ``tpd`` — the scalar Python reference (paper-literal).
* ``tpd_fast`` — the cached EXACT (float64 numpy) vectorized evaluator
  on a batch of 1, on the host as in the reference; bit-identical to
  ``tpd`` for width < 8.
* ``batch_tpd`` — whole-swarm (P, D) -> (P,) evaluation, backends:

  - ``"np"``: the reference's float32 numpy closure, on the host;
  - ``"torch"``: :func:`~repro_torch.kernels.tpd.leaf_loads` plus the
    plain torch :func:`~repro_torch.kernels.ref.tpd_ref` on the model's
    device;
  - ``"kernel"``: the CUDA kernel
    (:func:`~repro_torch.kernels.tpd.batch_tpd_cuda`), one launch that
    builds the leaf loads and scores the swarm; CUDA devices only.

  Auto-selection: on a CUDA device always ``"kernel"``; on the CPU the
  reference's ``_NP_FASTPATH_ELEMS`` rule picks ``"np"`` for small
  swarms and ``"torch"`` above it.

Cache invalidation is O(1): evaluators are keyed on the ClientPool's
mutation ``version`` counter and the retarget counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hierarchy import ClientPool, Hierarchy, rows_with_duplicates
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import tpd_ref
from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs

_BACKENDS = ("np", "torch", "kernel")


@dataclass(frozen=True)
class CostModel:
    hierarchy: Hierarchy
    clients: ClientPool
    memory_penalty: float = 0.0  # 0 disables the memcap feasibility term
    device: object = "cuda"      # where the torch/kernel backends run

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ------------------------------------------------------------------
    def cluster_delay(self, host: int, children: Sequence[int]) -> float:
        """Paper eq. 6 (+ optional memcap penalty)."""
        mds = self.clients.mdatasize
        load = mds[host] + sum(mds[c] for c in children)
        delay = load / self.clients.pspeed[host]
        if self.memory_penalty > 0:
            over = max(0.0, load - self.clients.memcap[host])
            delay *= 1.0 + self.memory_penalty * over / max(
                self.clients.memcap[host], 1e-9)
        return float(delay)

    def tpd(self, placement: Sequence[int]) -> float:
        """Paper eq. 7: bottom-up BFT, sum of per-level maxima (the
        scalar reference every vectorized path is held to)."""
        h = self.hierarchy
        children = h.children_clients(placement)
        total = 0.0
        for level in range(h.depth - 1, -1, -1):
            worst = 0.0
            for s in range(h.level_starts[level], h.level_starts[level + 1]):
                worst = max(worst,
                            self.cluster_delay(int(placement[s]), children[s]))
            total += worst
        return total

    def fitness(self, placement: Sequence[int]) -> float:
        """Paper eq. 1: f = -T."""
        return -self.tpd(placement)

    # ------------------------------------------------------------------
    # vectorized path (all particles at once)
    # ------------------------------------------------------------------
    # the reference's numpy-vs-XLA-CPU crossover, kept for CPU devices:
    # below this many placement entries the numpy evaluator wins
    _NP_FASTPATH_ELEMS = 32768

    def _attr_stack(self, dtype) -> np.ndarray:
        """Stacked (3, C) client-attribute table: mdatasize, pspeed,
        memcap — ONE fancy-index gathers every per-host attribute."""
        return np.stack([self.clients.mdatasize, self.clients.pspeed,
                         self.clients.memcap]).astype(dtype)

    def _make_batch_tpd(self, dtype=None):
        """Build the numpy (P, slots) -> (P,) TPD evaluator (the
        reference's closure, host-side, numpy branch of the base model).

        The canonical round-robin trainer split is recomputed per
        particle (rank of each unplaced client in ascending id order,
        mod n_leaves), so heterogeneous ``mdatasize`` charges the ACTUAL
        per-child loads.

        ``dtype`` is the accumulation dtype (default float32). The
        float64 build is the EXACT path: every reduction runs in the
        same order as the scalar reference (bincount/left-to-right
        child sums, division by pspeed, per-level maxima summed deepest
        level first), so it is bit-identical to ``tpd`` for width < 8.
        """
        h = self.hierarchy
        C, D, depth = h.total_clients, h.dimensions, h.depth
        n_leaves = h.n_leaves
        leaf_start = h.level_starts[depth - 1]
        kids_np = h.kids_table
        penalty = self.memory_penalty
        ft = np.dtype(dtype if dtype is not None else np.float32).type
        attrs_np = self._attr_stack(ft)                     # (3, C)
        mds_all = attrs_np[0]
        # uniform-payload fast path: when every client's mdatasize is
        # equal the canonical trainer split fixes each leaf cluster's
        # LOAD, so the per-call (P, C) rank/scatter pipeline collapses
        # to a per-slot constant — bit-identical because the constants
        # are accumulated by the same repeated addition the bincount
        # would perform. Rows with DUPLICATE ids take the general path.
        uniform = bool(mds_all.size) and bool(np.all(mds_all == mds_all[0]))
        if uniform:
            counts = np.bincount(np.arange(max(C - D, 0)) % n_leaves,
                                 minlength=n_leaves)
            # cumsum of a constant == the bincount's sequential repeated
            # addition, prefix by prefix (bit-identical)
            kmax = int(counts.max()) if counts.size else 0
            acc = np.concatenate(
                [[np.float64(0.0)],
                 np.cumsum(np.full(kmax, np.float64(mds_all[0]),
                                   np.float64))])
            leaf_part_np = np.zeros(D, np.float64)
            leaf_part_np[leaf_start:] = acc[counts]
            leaf_part = leaf_part_np.astype(ft)             # (D,)
        # gather only the attribute rows the host site consumes
        h_attrs = attrs_np[[0, 1] + ([2] if penalty > 0 else [])]
        kids = np.clip(kids_np, 0, D - 1)
        kids_valid = kids_np >= 0
        is_leaf_slot = h.levels == depth - 1
        slot_leaf_idx = np.clip(np.arange(D) - leaf_start, 0, n_leaves - 1)
        level_starts_np = np.asarray(h.level_starts[:-1], np.int32)

        def batch(placements):                           # (P, D) int
            placements = placements.astype(np.int32)
            P = placements.shape[0]
            host = h_attrs[:, placements]                # (Ah, P, D)
            kid_mds = np.where(kids_valid[None],
                               mds_all[placements[:, kids]], ft(0.0))
            if uniform and not rows_with_duplicates(placements).any():
                # leaf slots: constant trainer load (+0 kid sum);
                # internal slots: +0 leaf part — both adds are exact
                child_load = leaf_part + np.sum(kid_mds, axis=2)
            else:
                p_off = np.arange(P)[:, None]
                # placed mask via bincount, not a (P, D, C) compare
                placed = np.bincount((placements + C * p_off).ravel(),
                                     minlength=P * C).reshape(P, C)
                unplaced = placed == 0
                t_mds = np.where(unplaced, mds_all[None], ft(0.0))
                # canonical trainer split: rank among unplaced ids, mod
                # leaves
                leaf_of = (np.cumsum(unplaced, axis=1) - 1) % n_leaves
                leaf_load = np.bincount(
                    (leaf_of + n_leaves * p_off).ravel(),
                    weights=t_mds.ravel(),
                    minlength=P * n_leaves).reshape(P, n_leaves)
                child_load = np.where(
                    is_leaf_slot[None],
                    leaf_load[:, slot_leaf_idx].astype(ft),
                    np.sum(kid_mds, axis=2))
            load = host[0] + child_load
            delay = load / host[1]
            if penalty > 0:
                cap = host[2]
                over = np.maximum(ft(0.0), load - cap)
                delay = delay * (1.0 + penalty * over /
                                 np.maximum(cap, ft(1e-9)))
            # per-level max, summed DEEPEST level first — the scalar
            # reference accumulates bottom-up, and float addition is not
            # associative, so the exact path must match its order
            level_max = np.maximum.reduceat(delay, level_starts_np, axis=1)
            return level_max[:, ::-1].sum(axis=1)

        return batch

    def _make_device_tpd(self, kernel: bool):
        """Closure scoring swarms on ``self.device``: static tables and
        the (3, C) f32 attribute table are uploaded once; per call the
        placements go up, the TPD evaluation runs on the device, and the
        (P,) TPDs come back to the host. With ``kernel`` the evaluation
        is one launch of the CUDA kernel, which builds the leaf loads
        itself; else ``leaf_loads`` and the plain torch version."""
        h = self.hierarchy
        dev = self.device
        kids, level_starts = tpd_kernel_inputs(h, device=dev)
        attrs = torch.as_tensor(self._attr_stack(np.float32), device=dev)
        n_leaves, C = h.n_leaves, h.total_clients
        penalty = float(self.memory_penalty)

        def run(placements):
            placements = np.asarray(placements, np.int32)
            if placements.size and (placements.min() < 0
                                    or placements.max() >= C):
                raise ValueError(f"placement client id out of range "
                                 f"[0, {C})")
            p = torch.as_tensor(placements, device=dev)
            if kernel:
                out = batch_tpd_cuda(p, attrs, None, kids, level_starts,
                                     penalty=penalty)
            else:
                out = tpd_ref(p, attrs, leaf_loads(p, attrs[0], n_leaves),
                              kids, level_starts, penalty=penalty)
            return out.cpu().numpy()

        return run

    @property
    def topology_version(self) -> int:
        """How many times :meth:`retarget` swapped the hierarchy (0 for
        a static run)."""
        return getattr(self, "_topology_version", 0)

    def retarget(self, hierarchy: Hierarchy) -> None:
        """Swap in a new hierarchy after an elastic resize.

        The SAME cost model object (strategies hold references to it)
        starts pricing rounds on the new topology, and the bumped
        ``topology_version`` joins the pool-mutation counter in
        :meth:`_client_token`, so every cached evaluator is rebuilt on
        the next call instead of serving stale-shape answers.
        """
        if hierarchy.total_clients != len(self.clients):
            raise ValueError(
                f"hierarchy expects {hierarchy.total_clients} clients, "
                f"pool has {len(self.clients)}")
        object.__setattr__(self, "hierarchy", hierarchy)
        object.__setattr__(self, "_topology_version",
                           self.topology_version + 1)

    def _client_token(self) -> tuple:
        """O(1) fingerprint of the client attrs + topology baked into
        the cached evaluators: the pool's mutation version counter plus
        the retarget counter."""
        return (id(self.clients), self.clients.version,
                self.topology_version)

    def _cached(self, attr: str, build):
        token = self._client_token()
        cached = getattr(self, attr, None)
        if cached is None or cached[0] != token:
            cached = (token, build())
            object.__setattr__(self, attr, cached)
        return cached[1]

    def set_default_backend(self, backend: Optional[str]) -> None:
        """Pin what ``batch_tpd(backend=None)`` dispatches to; ``None``
        restores auto-selection."""
        if backend is not None and backend not in _BACKENDS:
            raise ValueError(f"unknown batch_tpd backend {backend!r}; "
                             f"use None, 'np', 'torch' or 'kernel'")
        object.__setattr__(self, "_default_backend", backend)

    def batch_tpd(self, placements, backend: Optional[str] = None
                  ) -> np.ndarray:
        """(P, D) placements -> (P,) f32 TPDs.

        ``backend``: ``None`` auto-selects (``"kernel"`` on a CUDA
        device; on the CPU ``"np"`` below the fast-path threshold and
        ``"torch"`` above it); ``"np"`` / ``"torch"`` / ``"kernel"``
        force a path; ``"kernel"`` needs a CUDA device. A
        ``set_default_backend`` pin replaces the auto-selection, never an
        explicit ``backend=``.
        """
        placements = np.asarray(placements, np.int32)
        if backend is None:
            backend = getattr(self, "_default_backend", None)
        if backend is None:
            if self.device.type == "cuda":
                backend = "kernel"
            else:
                small = placements.size // max(self.hierarchy.dimensions, 1) \
                    * self.hierarchy.total_clients <= self._NP_FASTPATH_ELEMS
                backend = "np" if small else "torch"
        if backend == "np":
            fn = self._cached("_batch_tpd_np",
                              lambda: self._make_batch_tpd())
        elif backend == "kernel":
            if self.device.type != "cuda":
                raise ValueError(
                    f"backend='kernel' runs the CUDA kernel and needs a "
                    f"CUDA device; this model is on {self.device}")
            fn = self._cached("_batch_tpd_kernel",
                              lambda: self._make_device_tpd(True))
        elif backend == "torch":
            fn = self._cached("_batch_tpd_torch",
                              lambda: self._make_device_tpd(False))
        else:
            raise ValueError(f"unknown batch_tpd backend {backend!r}; "
                             f"use None, 'np', 'torch' or 'kernel'")
        return fn(placements)

    def tpd_fast(self, placement) -> float:
        """Single-placement fast path: the cached EXACT (float64 numpy)
        vectorized evaluator on a batch of 1, bit-identical to the
        scalar :meth:`tpd` for trees with width < 8. This is what
        ``SimulatedEnvironment.step`` calls every round."""
        placements = np.asarray(placement, np.int32).reshape(1, -1)
        fn = self._cached(
            "_batch_tpd_exact",
            lambda: self._make_batch_tpd(dtype=np.float64))
        return float(fn(placements)[0])

    def batch_fitness(self, placements) -> np.ndarray:
        return -np.asarray(self.batch_tpd(placements))
