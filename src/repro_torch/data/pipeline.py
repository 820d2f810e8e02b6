"""Federated batching: per-client numpy datasets -> fixed-shape round tensors.

A copy of ``repro.data.pipeline`` without the streaming-cohort slabs. One
FedAvg round with N clients and K local steps needs, per client, K
minibatches of size b, stacked as ``(N, K, b, *feature)``; ``bucket_batches``
stacks rounds to ``(B, N, K, b, ...)`` and ``BatchPrefetcher`` builds the
next request on a background thread while the current one runs on the
device.

Every builder draws from one numpy Generator in request order, so the
client ids and sample indices match the reference draw for draw. The port's
trainer asks for ONE round per request (``n_rounds=1, pad_to=1``): a CIFAR100
round at paper width is a 491.5 MB batch, and the reference's default
8-round bucket would be 3.9 GB of host memory. That does not change the
stream: ``bucket_batches`` draws exactly what ``n_rounds`` sequential
per-round draws would, and padding rounds draw nothing. On a mesh every rank
draws the same cohort and keeps its own client rows (``slice_clients``).

Sampling is with replacement within a client's local dataset.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.data.synthetic import FederatedData


def sample_clients(rng: np.random.Generator, data: FederatedData,
                   n: int) -> np.ndarray:
    """Uniform client sampling without replacement (Algorithm 1, line 3)."""
    return rng.choice(data.num_clients, size=min(n, data.num_clients),
                      replace=False)


def round_batches(rng: np.random.Generator, data: FederatedData,
                  client_ids: Sequence[int], k: int,
                  batch_size: int) -> Dict[str, np.ndarray]:
    """Build the (N, K, b, ...) tensors for one round."""
    xs, ys = [], []
    for c in client_ids:
        n_c = len(data.client_y[c])
        idx = rng.integers(0, n_c, size=(k, batch_size))
        xs.append(data.client_x[c][idx])
        ys.append(data.client_y[c][idx])
    return {"x": np.stack(xs), "y": np.stack(ys)}


def client_weights(data: FederatedData, client_ids: Sequence[int]) -> np.ndarray:
    """Per-round aggregation weights p_c (float32), renormalised over the
    round's participants; a cohort of all-empty datasets gets uniform
    weights instead of 0/0."""
    w = np.array([len(data.client_y[c]) for c in client_ids], dtype=np.float64)
    if w.sum() <= 0:
        w = np.ones_like(w)
    return (w / w.sum()).astype(np.float32)


def val_batches(data: FederatedData, batch_size: int) -> List[Dict[str, np.ndarray]]:
    """Full validation split, including the ragged tail batch (< batch_size).
    Evaluators weight per-batch means by batch size."""
    n = len(data.val_y)
    out = []
    for i in range(0, n, batch_size):
        out.append({"x": data.val_x[i:i + batch_size],
                    "y": data.val_y[i:i + batch_size]})
    return out


# ---------------------------------------------------------------------------
# bucket construction + background prefetch
# ---------------------------------------------------------------------------

@dataclass
class BucketBatch:
    """Host tensors for ``n_rounds`` active rounds, padded to ``pad_to``
    rounds (padding repeats the last active round and is masked by
    ``active=False``)."""
    batches: Dict[str, np.ndarray]   # (B, N, K, b, ...)
    weights: np.ndarray              # (B, N)
    active: np.ndarray               # (B,) bool
    n_rounds: int


def slice_clients(bb: BucketBatch, lo: int, hi: int) -> BucketBatch:
    """The bucket's client rows [lo, hi) (leaves (B, hi - lo, ...)): one
    rank's block of a mesh round, cut on the host before the copy to its
    device (``MeshBackend.place_bucket``)."""
    return BucketBatch(batches={k: v[:, lo:hi] for k, v in
                                bb.batches.items()},
                       weights=bb.weights[:, lo:hi], active=bb.active,
                       n_rounds=bb.n_rounds)


def bucket_batches(rng: np.random.Generator, data: FederatedData, *,
                   n_rounds: int, k: int, clients_per_round: int,
                   batch_size: int, pad_to: Optional[int] = None,
                   sampler=None,
                   round_ids: Optional[Sequence[int]] = None) -> BucketBatch:
    """Draws EXACTLY the same rng stream as ``n_rounds`` sequential calls of
    sample_clients + round_batches + client_weights.

    ``sampler``: a ``ClientSampler`` deciding participation + weights per
    round (None = the uniform draw); ``round_ids``: the absolute 1-based
    round indices, forwarded to the sampler. Sample rows are gathered
    straight into the preallocated bucket arrays."""
    pad_to = pad_to or n_rounds
    if pad_to < n_rounds:
        raise ValueError(f"pad_to {pad_to} < n_rounds {n_rounds}")
    if round_ids is not None and len(round_ids) < n_rounds:
        raise ValueError(f"{len(round_ids)} round_ids for {n_rounds} rounds")
    n = min(clients_per_round, data.num_clients)
    feat = data.client_x[0].shape[1:]
    lead = (pad_to, n, k, batch_size)
    xs = np.empty(lead + feat, data.client_x[0].dtype)
    ys = np.empty(lead + data.client_y[0].shape[1:], data.client_y[0].dtype)
    weights = np.empty((pad_to, n), np.float32)
    for i in range(n_rounds):
        if sampler is None:
            ids = sample_clients(rng, data, clients_per_round)
            w = client_weights(data, ids)
        else:
            ids, w = sampler.round(
                rng, data, clients_per_round,
                round_ids[i] if round_ids is not None else None)
        for j, c in enumerate(ids):
            n_c = len(data.client_y[c])
            idx = rng.integers(0, n_c, size=k * batch_size)
            np.take(data.client_x[c], idx, axis=0,
                    out=xs[i, j].reshape((k * batch_size,) + feat))
            np.take(data.client_y[c], idx, axis=0,
                    out=ys[i, j].reshape((k * batch_size,)
                                         + data.client_y[0].shape[1:]))
        weights[i] = w
    for i in range(n_rounds, pad_to):     # masked-out padding rounds
        xs[i], ys[i], weights[i] = xs[n_rounds - 1], ys[n_rounds - 1], \
            weights[n_rounds - 1]
    active = np.zeros(pad_to, bool)
    active[:n_rounds] = True
    return BucketBatch(batches={"x": xs, "y": ys}, weights=weights,
                       active=active, n_rounds=n_rounds)


class _BuilderBase:
    """submit/get protocol shared by the sync and threaded builders.
    Requests are served strictly FIFO off one rng, so batch contents depend
    only on (rng state, submission order), never on timing.

    ``rng``: an int seed or a live ``np.random.Generator`` (used in place,
    so repeated trainer runs continue one sample stream). ``place_fn``:
    applied to each finished BucketBatch (the engine's host->device copy);
    on the threaded builder it runs on the worker, so the copy of round r+1
    overlaps round r's compute."""

    def __init__(self, data: FederatedData, clients_per_round: int,
                 batch_size: int,
                 rng: "Union[int, np.random.Generator]",
                 place_fn: Optional[Callable[["BucketBatch"],
                                             "BucketBatch"]] = None,
                 sampler=None):
        self.data = data
        self.clients_per_round = clients_per_round
        self.batch_size = batch_size
        self._rng = np.random.default_rng(rng)
        self._place_fn = place_fn
        self._sampler = sampler

    def _build(self, n_rounds: int, k: int, pad_to: Optional[int],
               rounds: Optional[Sequence[int]] = None) -> BucketBatch:
        bb = bucket_batches(self._rng, self.data, n_rounds=n_rounds, k=k,
                            clients_per_round=self.clients_per_round,
                            batch_size=self.batch_size, pad_to=pad_to,
                            sampler=self._sampler, round_ids=rounds)
        return self._place_fn(bb) if self._place_fn is not None else bb

    def submit(self, n_rounds: int, k: int, pad_to: Optional[int] = None,
               rounds: Optional[Sequence[int]] = None) -> None:
        raise NotImplementedError

    def get(self) -> BucketBatch:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyncBatchBuilder(_BuilderBase):
    """Builds on ``get`` in the caller's thread (prefetch disabled)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._pending: List = []

    def submit(self, n_rounds, k, pad_to=None, rounds=None):
        self._pending.append((n_rounds, k, pad_to, rounds))

    def get(self):
        return self._build(*self._pending.pop(0))


class BatchPrefetcher(_BuilderBase):
    """Double-buffered background builder: one daemon thread owns the rng
    and builds submitted requests FIFO into a bounded output queue (depth 1
    by default), so at most one request is staged ahead."""

    def __init__(self, data: FederatedData, clients_per_round: int,
                 batch_size: int, rng: "Union[int, np.random.Generator]",
                 depth: int = 1, place_fn=None, sampler=None):
        super().__init__(data, clients_per_round, batch_size, rng,
                         place_fn=place_fn, sampler=sampler)
        self._req: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="fedavg-batch-prefetch")
        self._thread.start()

    def _work(self):
        while True:
            req = self._req.get()
            if req is None:
                return
            try:
                item = ("ok", self._build(*req))
            except BaseException as e:      # surfaced on the next get();
                item = ("err", e)           # the worker keeps serving
            if not self._put(item):
                return

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def submit(self, n_rounds, k, pad_to=None, rounds=None):
        self._req.put((n_rounds, k, pad_to, rounds))

    def get(self):
        status, item = self._out.get()
        if status == "err":
            raise item
        return item

    def close(self):
        self._stop.set()
        self._req.put(None)
        while self._thread.is_alive():
            try:                                 # unblock a pending put
                self._out.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)


def make_builder(data: FederatedData, clients_per_round: int, batch_size: int,
                 rng: "Union[int, np.random.Generator]", *,
                 background: bool = True, place_fn=None,
                 sampler=None) -> _BuilderBase:
    cls = BatchPrefetcher if background else SyncBatchBuilder
    return cls(data, clients_per_round, batch_size, rng, place_fn=place_fn,
               sampler=sampler)
