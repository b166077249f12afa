"""Deterministic synthetic data: classification for the emulated track,
LM token streams for training and federating the language models.

The port's copy of ``repro.data.synthetic``: the MNIST-shaped
class-conditional Gaussian set the paper's MLP trains on, the Dirichlet
non-IID partitioner, ``FederatedDataset`` with its elastic ``resize``,
the LM token stream ``SyntheticLMDataset`` and its per-client federated
form ``FederatedLMDataset``. Everything is numpy on the host, drawn
from the same seeds in the same order, so the same seed gives the same
arrays bit for bit; the orchestrator moves each round's batches to the
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

# named rng streams: every per-purpose stream in this module is an
# explicit (seed, STREAM, ...) tuple, never a bare literal
_EVAL_STREAM = 0xE7A1  # held-out eval shard


def _doc_seed(*parts) -> int:
    """Deterministic 31-bit seed from mixed int/str stream parts.

    ``hash()`` over a str is salted per process (PYTHONHASHSEED), so it
    can never feed a seed; SeedSequence mixing is process-independent.
    """
    ints = [
        int.from_bytes(p.encode(), "little") if isinstance(p, str) else int(p)
        for p in parts
    ]
    return int(np.random.SeedSequence(ints).generate_state(1)[0] >> 1)


class SyntheticLMDataset:
    """An infinite, seeded LM token stream with mild structure.

    Tokens follow a per-document affine recurrence so the loss is
    learnable: ``t[i+1] = (a * t[i] + b) % vocab`` with per-document
    (a, b), in closed form. numpy on the host, the same draws as the
    reference's, so a seed gives the same batches bit for bit.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.seed = int(seed)

    def batch(self, global_batch: int, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        a = rng.integers(1, 8, size=(global_batch, 1))
        b = rng.integers(0, self.vocab_size, size=(global_batch, 1))
        t0 = rng.integers(0, self.vocab_size, size=(global_batch, 1))
        idx = np.arange(self.seq_len + 1)[None, :]
        # closed form of the affine recurrence mod vocab
        toks = (t0 * np.power(a, idx % 13) + b * idx) % self.vocab_size
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, global_batch: int) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(global_batch, step)
            step += 1


class SyntheticClassificationDataset:
    """MNIST-shaped synthetic classification data (784 features, 10 classes).

    Class-conditional Gaussians so the MLP actually learns; used by the
    Fig. 4 cluster emulation.
    """

    def __init__(self, n_features: int = 784, n_classes: int = 10,
                 n_samples: int = 10_000, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.n_features, self.n_classes = n_features, n_classes
        self.centers = rng.normal(size=(n_classes, n_features)).astype(np.float32)
        self.labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
        noise = rng.normal(scale=0.8, size=(n_samples, n_features)).astype(np.float32)
        self.features = self.centers[self.labels] + noise

    def __len__(self) -> int:
        return len(self.labels)


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 8) -> list[np.ndarray]:
    """Partition sample indices across clients with Dirichlet(alpha) class
    skew — the standard non-IID FL split (smaller alpha => more skew)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    # guarantee a floor so no client starves (re-assign from the richest)
    order = np.argsort([len(x) for x in client_idx])
    for cid in order:
        while len(client_idx[cid]) < min_per_client:
            donor = max(range(n_clients), key=lambda i: len(client_idx[i]))
            client_idx[cid].append(client_idx[donor].pop())
    return [np.asarray(sorted(x), dtype=np.int64) for x in client_idx]


def _carry_by_remap(old: list, remap: Optional[np.ndarray],
                    new_total: int) -> list:
    """Place survivors' entries at their remapped ids; ``None`` holes
    mark joiners. ``remap`` is the composed old->new id map from
    ``ClientPool.drain_resizes`` (-1 = departed; ``None`` = identity)."""
    if remap is None:
        remap = np.arange(len(old))
    new: list = [None] * new_total
    for old_id, new_id in enumerate(remap):
        if new_id >= 0:
            new[int(new_id)] = old[old_id]
    return new


def _mint_streams(new_streams: list, old_streams: list,
                  hwm: Optional[int]) -> tuple:
    """Fill ``None`` holes with fresh stream ids minted above the
    high-water mark, in ascending id order; returns ``(streams, hwm)``.
    A departed client's stream id is never recycled onto a joiner."""
    if hwm is None:
        hwm = max(old_streams, default=-1) + 1
    for i, s in enumerate(new_streams):
        if s is None:
            new_streams[i] = hwm
            hwm += 1
    return new_streams, hwm


@dataclass
class FederatedDataset:
    """Per-client views over a base dataset, produced by dirichlet_partition.

    ELASTIC: :meth:`resize` reconciles the shard list with a client-pool
    resize (the orchestrator's ``admit``/``retire``): survivors keep
    their exact shards at their renumbered ids, departed shards are
    dropped, and every joiner is provisioned a fresh Dirichlet-skewed
    shard from the base set.

    Batch draws are keyed by a per-client *stream id* (identity until
    the first resize): renumbering never moves a survivor onto another
    client's batch-draw sequence, and a departed client's stream is
    never recycled onto a joiner.

    Like the reference's, this dataset has no ``eval_batch``: the
    orchestrator scores the global model on the first ``n`` base
    samples.
    """
    base: SyntheticClassificationDataset
    partitions: list
    alpha: float = 0.5
    stream_of: Optional[list] = None  # client id -> stream id (None = identity)
    stream_hwm: Optional[int] = None  # next fresh stream id (monotonic)

    @classmethod
    def make(cls, n_clients: int, alpha: float = 0.5, seed: int = 0,
             n_samples: int = 10_000) -> "FederatedDataset":
        base = SyntheticClassificationDataset(n_samples=n_samples, seed=seed)
        parts = dirichlet_partition(base.labels, n_clients, alpha=alpha, seed=seed)
        return cls(base=base, partitions=parts, alpha=alpha)

    @property
    def n_clients(self) -> int:
        return len(self.partitions)

    def _stream(self, client_id: int) -> int:
        return client_id if self.stream_of is None \
            else self.stream_of[client_id]

    def client_batch(self, client_id: int, batch_size: int, step: int) -> dict:
        part = self.partitions[client_id]
        rng = np.random.default_rng((self._stream(client_id), step))
        take = rng.choice(len(part), size=min(batch_size, len(part)), replace=False)
        idx = part[take]
        return {"x": self.base.features[idx], "y": self.base.labels[idx]}

    def client_weights(self) -> np.ndarray:
        """FedAvg weights proportional to client sample counts."""
        sizes = np.array([len(p) for p in self.partitions], dtype=np.float64)
        return (sizes / sizes.sum()).astype(np.float32)

    # ---- elastic population ----------------------------------------------
    def _provision_shard(self, rng: np.random.Generator) -> np.ndarray:
        """One fresh non-IID shard for a joiner: Dirichlet(alpha) class
        proportions, sized like the current mean shard (floor 8)."""
        labels = self.base.labels
        n_classes = int(labels.max()) + 1
        size = max(8, int(np.mean([len(p) for p in self.partitions]))
                   if self.partitions else 64)
        counts = rng.multinomial(size, rng.dirichlet([self.alpha] * n_classes))
        idx: list[int] = []
        for c, k in enumerate(counts):
            if k == 0:
                continue
            pool = np.where(labels == c)[0]
            idx.extend(rng.choice(pool, size=k,
                                  replace=k > len(pool)).tolist())
        return np.asarray(sorted(idx), dtype=np.int64)

    def resize(self, remap: Optional[np.ndarray], new_total: int,
               rng: np.random.Generator) -> None:
        """Reconcile shards with a pool resize (see class docstring).

        ``remap`` is the composed old->new client id map from
        ``ClientPool.drain_resizes`` (-1 = departed; ``None`` = identity
        over the old population); ids beyond its image are joiners and
        get provisioned from ``rng``, in ascending id order. Survivors
        carry BOTH their shard and their batch-draw stream id.
        """
        old_streams = self.stream_of if self.stream_of is not None \
            else list(range(len(self.partitions)))
        new_parts = _carry_by_remap(self.partitions, remap, new_total)
        new_streams, hwm = _mint_streams(
            _carry_by_remap(old_streams, remap, new_total),
            old_streams, self.stream_hwm)
        for i in range(new_total):
            if new_parts[i] is None:
                new_parts[i] = self._provision_shard(rng)
        self.partitions = new_parts
        self.stream_of = new_streams
        self.stream_hwm = hwm


@dataclass
class FederatedLMDataset:
    """Per-client LM token streams (non-IID via per-client seeds and
    disjoint document-parameter ranges) for federating the LM families.

    ELASTIC: each client id maps to a *stream id* (identity until the
    first :meth:`resize`), so a pool resize renumbering survivors keeps
    every surviving client on its own token stream, departed streams are
    retired for good (never recycled onto a joiner), and joiners mint
    fresh stream ids above the high-water mark.
    """
    vocab_size: int
    seq_len: int
    n_clients_: int
    seed: int = 0
    frontend: Optional[tuple] = None  # (frontend_len, frontend_dim) stub
    stream_of: Optional[list] = None  # client id -> stream id (None = identity)
    stream_hwm: Optional[int] = None  # next fresh stream id (monotonic)

    @property
    def n_clients(self) -> int:
        return self.n_clients_

    def _stream(self, client_id: int) -> int:
        return client_id if self.stream_of is None \
            else self.stream_of[client_id]

    def _with_frontend(self, batch: dict, rng) -> dict:
        if self.frontend is not None:
            fl, fd = self.frontend
            batch["frontend"] = rng.normal(
                scale=0.02, size=(len(batch["tokens"]), fl, fd)
            ).astype(np.float32)
        return batch

    def client_batch(self, client_id: int, batch_size: int, step: int) -> dict:
        stream = self._stream(client_id)
        ds = SyntheticLMDataset(self.vocab_size, self.seq_len,
                                seed=_doc_seed(self.seed, stream))
        rng = np.random.default_rng((self.seed, stream, step))
        return self._with_frontend(ds.batch(batch_size, step), rng)

    def resize(self, remap: Optional[np.ndarray], new_total: int,
               rng: Optional[np.random.Generator] = None) -> None:
        """Reconcile client->stream ids with a pool resize (see class
        docstring); ``rng`` is accepted for interface symmetry with
        :meth:`FederatedDataset.resize` but never consumed — stream
        minting is a deterministic counter."""
        old = self.stream_of if self.stream_of is not None \
            else list(range(self.n_clients_))
        self.stream_of, self.stream_hwm = _mint_streams(
            _carry_by_remap(old, remap, new_total), old, self.stream_hwm)
        self.n_clients_ = new_total

    def eval_batch(self, n: int = 256) -> dict:
        ds = SyntheticLMDataset(self.vocab_size, self.seq_len,
                                seed=_doc_seed(self.seed, "eval"))
        rng = np.random.default_rng((self.seed, _EVAL_STREAM))
        return self._with_frontend(ds.batch(n, 0), rng)

    def client_weights(self) -> np.ndarray:
        return np.full(self.n_clients_, 1.0 / self.n_clients_, np.float32)


def make_federated_dataset(model_cfg, n_clients: int, seed: int = 0,
                           seq_len: int = 64, alpha: float = 0.5):
    """Family-appropriate federated dataset for a model config: the
    Dirichlet-partitioned classification set for the mlp family, token
    streams of ``seq_len`` for the LM families (with a stub frontend
    embedding for vlm and audio)."""
    if model_cfg.family == "mlp":
        return FederatedDataset.make(n_clients, alpha=alpha, seed=seed)
    frontend = None
    if model_cfg.family in ("vlm", "audio"):
        frontend = (model_cfg.frontend_len,
                    model_cfg.frontend_dim or model_cfg.d_model)
    return FederatedLMDataset(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        n_clients_=n_clients, seed=seed, frontend=frontend)
