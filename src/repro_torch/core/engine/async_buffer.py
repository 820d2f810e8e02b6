"""AsyncBufferedEngine: FedBuff-style buffered aggregation on a simulated
event clock (``repro.core.engine.async_buffer``).

The synchronous trainer waits for its whole cohort every round. This
engine keeps ``fed.clients_per_round`` clients in flight: each computes its
K-step update from the global version it last received, and its delta
arrives after a per-client duration drawn from the RuntimeModel's
heterogeneity model. Arrivals fold into an f32 buffer scaled by a
staleness weight; when ``buffer_size`` of them have folded the server
applies the buffer through the ordinary ServerOptimizer step and the
global version advances.

Determinism, the simulated event clock:

  * durations come from ``RuntimeModel.draw_client_times`` in counter mode
    (a function of (seed, dispatch index, client id)), so the trace is
    exact and needs no extra rng state;
  * the loop is a heap of ``(finish_time, seq, slot)`` in float64, ties
    resolved by dispatch order; every arrival of one time pops before the
    freed slots are redispatched, and an apply may fire mid-group;
  * the freed slots redispatch as one vmapped group from the current
    params. At heterogeneity 0 with ``buffer_size`` equal to the cohort the
    groups are whole cohorts, the draws consume the synchronous trainer's
    rng stream exactly, and the losses follow the synchronous run (the
    sync-parity oracle).

An arrival from start version v0 at version v has staleness s = v - v0 and
folds as ``buffer += w_c * weight(s) * hat_c``, ``buf_weight += w_c *
weight(s)``, with ``w_c`` its sampler weight inside its dispatch group and
``hat_c`` its delta through the uplink codec (``Transport.aggregate_slab``
on a one-row slab: the int8 decompress-reduce at N = 1 on every leaf) with
the slot's own error-feedback residual. The weight multiplies the reduced
``hat``; it is never folded into the codec's scale. The apply computes
``params + buffer / buf_weight``. Arrivals staler than ``max_staleness``
are dropped: counted, their slot refilled, their wire still charged.
Downlink codecs are refused: clients hold skewed versions, which one
broadcast reference cannot encode.

Everything checkpoints in the reference's layout: tree keys ``buffer`` and
``inflight`` beside the store's, meta ``async`` (heap, version vector,
per-slot metadata, buffer weight and count, counters), ``rng``,
``runtime_rng`` and ``ctrl``. A mid-buffer save resumes bitwise, and a
checkpoint of either package restores into the other.

The three device steps (a dispatch group's client compute, a fold, an
apply) run as bucket programs of an ``ExecutableRegistry``, keyed as the
reference's: ``(program_key, "async-dispatch" | "async-fold" |
"async-apply", codec signature, input signature)``. ``compile_count`` and
``shared_count`` count them as ``RoundEngine``'s, and ``dispatch_count``
counts their runs. Serving while training ticks the attached
``ServingLoop`` after every ``serve_every``-th buffer application. Not
ported: the engine on a ``MeshBackend`` (ROADMAP A13 (c)).
"""
from __future__ import annotations

import copy
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.engine.aggregators import LINEAR_AGGREGATORS
from repro_torch.core.engine.backends import LocalBackend, MeshBackend
from repro_torch.core.engine.client import make_client_update
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.engine.policies import get_staleness_weight
from repro_torch.core.engine.round import (BucketProgram,
                                          ExecutableRegistry, LossFn, _eta,
                                          _signature)
from repro_torch.core.engine.sampling import make_sampler
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.core.engine.trainer import History
from repro_torch.core.engine.transport import get_transport
from repro_torch.core.runtime_model import RuntimeModel
from repro_torch.core.schedules import DecayController
from repro_torch.data.pipeline import round_slabs
from repro_torch.data.synthetic import FederatedData
from repro_torch.device import DeviceLike
from repro_torch.optim import tree_map

PyTree = Any


def _refuse(fed: FedConfig, backend, sampler) -> None:
    """The engine's refusals, mirroring ``ExperimentSpec.validate`` for a
    FedConfig built by hand (reference :118-160)."""
    if fed.aggregator not in LINEAR_AGGREGATORS:
        raise ValueError(
            f"async buffered aggregation folds arrivals into a running "
            f"weighted sum and requires a linear aggregator "
            f"{LINEAR_AGGREGATORS}, got {fed.aggregator!r}: use "
            f"aggregation='sync' for robust aggregators")
    if fed.cohort_chunk:
        raise ValueError(
            "cohort_chunk does not compose with async aggregation: the "
            "async engine already streams arrivals one at a time; drop "
            "cohort_chunk")
    if getattr(backend, "strategy", "parallel") == "sequential":
        raise ValueError(
            "the mesh sequential strategy scans a whole synchronous "
            "cohort; async dispatch groups are ragged: use the parallel "
            "strategy")
    if isinstance(backend, MeshBackend):
        raise ValueError(
            "async buffered aggregation on a MeshBackend is not ported "
            "yet: it comes with ROADMAP A13 (c)")
    if fed.downlink != "none":
        raise ValueError(
            "async clients start from skewed global versions; the "
            "broadcast-reference downlink cannot encode one delta for all "
            "of them: set downlink='none'")
    if sampler.stateful_cohort:
        raise ValueError(
            f"sampler {sampler.name!r} pins one client a slot, but async "
            f"redispatches ragged groups of freed slots: use 'uniform' or "
            f"'weighted'")


class AsyncBufferedEngine:
    """The trainer of ``fed.aggregation="async"``: ``FedAvgTrainer``'s
    surface (``run``, ``save_state``, ``restore_state``, ``history``,
    ``dispatch_count``) on the buffered asynchronous model above.
    ``device``: where it runs (default ``cuda``); ``backend``: a
    ``LocalBackend`` (default), which brings its device."""

    def __init__(self, loss_fn: LossFn, init_params: PyTree,
                 data: FederatedData, fed: FedConfig,
                 runtime: RuntimeModel,
                 eval_fn: Optional[Callable[[PyTree],
                                            Dict[str, float]]] = None,
                 *, backend=None, device: DeviceLike = None,
                 registry: Optional[ExecutableRegistry] = None,
                 program_key: Optional[Tuple] = None):
        self.backend = backend if backend is not None \
            else LocalBackend(device)
        self.device = self.backend.device
        self.sampler = make_sampler(fed)
        _refuse(fed, self.backend, self.sampler)
        self.loss_fn = loss_fn
        self.data = data
        self.fed = fed
        self.eval_fn = eval_fn
        self.ctrl = DecayController(fed)

        self.n = min(fed.clients_per_round, data.num_clients)
        self.buffer_size = (self.n if fed.buffer_size is None
                            else int(fed.buffer_size))
        if not 1 <= self.buffer_size <= self.n:
            raise ValueError(
                f"buffer_size must be in [1, clients_per_round={self.n}], "
                f"got {self.buffer_size}: a larger buffer can never fill "
                f"past the in-flight cohort")
        self.staleness_weight = get_staleness_weight(fed.staleness_weight)
        self.max_staleness = fed.max_staleness

        self.server = get_server_optimizer(fed.server_optimizer)
        self.server_lr = fed.server_lr
        transport = get_transport(fed.transport, topk_frac=fed.topk_frac)
        if transport is not None and transport.error_feedback:
            # one residual slot an in-flight lane: concurrency is fixed, so
            # lane j's residual compensates the next update of that lane
            transport = transport.with_ef_slots(self.n)
        self.transport = transport
        self._codec_sig = (() if transport is None else transport.signature())

        # the store owns params, server state, the residual slots, the
        # version and the cost counters; no downlink, so it serves params
        self.store = GlobalModelStore()
        self.params = self.backend.place_params(init_params)
        self.server_state = self.server.init(self.params)
        self.transport_state = (() if transport is None
                                else transport.init_state(self.params))
        self.store.downlink_state = ()

        self.runtime = runtime
        if transport is not None:
            # charge the wire what the codec ships, on a copy whose
            # straggler rng continues the shared one's stream
            rt = copy.copy(runtime)
            rt._rng = np.random.default_rng()
            rt._rng.bit_generator.state = runtime._rng.bit_generator.state
            rt.uplink_compression = transport.compression_ratio(self.params)
            self.runtime = rt

        self._client = torch.func.vmap(make_client_update(loss_fn),
                                       in_dims=(None, 0, None))
        if registry is not None and program_key is None:
            raise ValueError(
                "a shared ExecutableRegistry requires a program_key (see "
                "RoundEngine)")
        self._registry = registry if registry is not None \
            else ExecutableRegistry()
        self._program_key = program_key if program_key is not None else ()
        self._executables: Dict[Tuple, BucketProgram] = {}
        self._own_keys: set = set()
        self._shared_keys: set = set()
        self.dispatch_count = 0
        self.history = History()
        self._np_rng = np.random.default_rng(fed.seed)

        # --- the simulation's state (all of it checkpoints) ---------------
        self._started = False
        self._sim_time = 0.0
        self._seq = 0                # event tie-break, monotone
        self._dispatch_idx = 0       # counter-mode duration stream index
        self._heap: List[Tuple[float, int, int]] = []
        zeros = lambda lead: tree_map(
            lambda p: torch.zeros(lead + tuple(p.shape), dtype=torch.float32,
                                  device=p.device), self.params)
        self._inflight = zeros((self.n,))     # per-slot deltas (n, ...)
        self._slot_client = np.full(self.n, -1, np.int64)
        self._slot_version = np.full(self.n, -1, np.int64)  # version vector
        self._slot_weight = np.zeros(self.n, np.float64)
        self._slot_first = np.zeros(self.n, np.float64)
        self._slot_last = np.zeros(self.n, np.float64)
        self._slot_k = np.zeros(self.n, np.int64)
        self._buffer = zeros(())
        self._buf_weight = 0.0
        self._buf_count = 0
        self._buf_first_losses: List[float] = []
        self._buf_staleness: List[int] = []
        self.applied_updates = 0
        self.dropped_updates = 0
        self.staleness_hist: Dict[int, int] = {}
        self._completed_rounds = 0
        # serve while training: set by ``api.build``; ticks ride buffer
        # applications
        self.serving = None
        self.serve_every = 0

    # the store owns the state; these names read and write it
    params = property(lambda self: self.store.params,
                      lambda self, v: setattr(self.store, "params", v))
    server_state = property(
        lambda self: self.store.server_state,
        lambda self, v: setattr(self.store, "server_state", v))
    transport_state = property(
        lambda self: self.store.transport_state,
        lambda self, v: setattr(self.store, "transport_state", v))
    _version = property(lambda self: self.store.version,
                        lambda self, v: setattr(self.store, "version", v))

    # ------------------------------------------------------------------
    # the three device steps: programs of the registry, each a function of
    # its arguments only, so an engine may run another's
    # ------------------------------------------------------------------
    def _dispatch_fn(self, params, batches, eta):
        """(params, batches (m, K, b, ...), eta) -> (f32 deltas (m, ...),
        first (m,), last (m,)): the clients' compute at dispatch."""
        client_params, first, last = self._client(params, batches, eta)
        deltas = tree_map(lambda cp, p: cp.to(torch.float32)
                          - p.to(torch.float32)[None], client_params, params)
        return deltas, first, last

    def _fold_fn(self, buffer, delta, w, ef):
        """Fold one arrival's ``delta`` into ``buffer`` (in place): through
        the codec (one-row slab with the slot's residual ``ef``) when there
        is one, then ``buffer += w * hat`` with ``w`` rounded to f32 as the
        reference's scalar. Returns (buffer, the slot's new residual)."""
        hat, new_ef = delta, ef
        if self.transport is not None:
            # zero params as broadcast views: the codec's delta is the
            # in-flight delta itself, and no params-sized zeros are held
            zero = tree_map(lambda d: torch.zeros(
                (), dtype=torch.float32, device=d.device).expand(d.shape),
                delta)
            hat, _true, new_ef = self.transport.aggregate_slab(
                zero, tree_map(lambda d: d[None], delta),
                torch.ones(1, dtype=torch.float32, device=self.device), ef)
        w32 = float(np.float32(w))
        tree_map(lambda b, h: b.add_(h * w32), buffer, hat)
        return buffer, new_ef

    def _apply_fn(self, params, buffer, buf_weight, server_state):
        """aggregate = params + buffer / buf_weight through the server
        step; the buffer is zeroed (in place) for the next fill. Returns
        (params, server_state, buffer)."""
        bw = np.float32(buf_weight)
        inv = float(np.float32(1.0) / bw) if bw > 0 else 0.0
        aggregate = tree_map(lambda p, b: p.to(torch.float32) + inv * b,
                             params, buffer)
        params, server_state = self.server.step(
            params, aggregate, server_state, self.server_lr)
        tree_map(lambda b: b.zero_(), buffer)
        return params, server_state, buffer

    def _run_exe(self, tag: str, fn, args):
        """Run ``fn`` on ``args`` through the program of its key, built on
        a miss (reference ``async_buffer.py:311-321``)."""
        key = ((self._program_key,) if self._program_key else ()) \
            + (tag, self._codec_sig) + _signature(args)
        exe = self._executables.get(key)
        if exe is None:
            exe, built = self._registry.get_or_build(
                key, lambda: BucketProgram(fn, self.device))
            self._executables[key] = exe
            (self._own_keys if built else self._shared_keys).add(key)
        self.dispatch_count += 1
        return exe(*args)

    @property
    def compile_count(self) -> int:
        return len(self._own_keys)

    @property
    def shared_count(self) -> int:
        return len(self._shared_keys)

    @property
    def registry(self) -> ExecutableRegistry:
        return self._registry

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------
    def _dispatch_group(self, slots: List[int]) -> None:
        """Draw a group for the freed ``slots``, compute their updates from
        the current params and schedule their arrivals: the group's draws
        are one slab of ``round_slabs`` (one sampler draw, then each
        client's batch indices in slot order), which at zero jitter with
        whole-cohort groups is the synchronous stream."""
        m = len(slots)
        r = self._version + 1                     # the round being fed
        k = self.ctrl.k_for_round(r)
        eta = self.ctrl.eta_for_round(r)
        sb = next(round_slabs(self._np_rng, self.data, k=k,
                              clients_per_round=m,
                              batch_size=self.fed.batch_size, chunk=m,
                              sampler=self.sampler, round_id=r))
        ids, w = sb.ids, sb.weights
        batches = self.backend.place_batches(sb.batches)
        deltas, first, last = self._run_exe(
            "async-dispatch", self._dispatch_fn,
            (self.params, batches, _eta(eta)))
        sl = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        tree_map(lambda t, d: t.index_copy_(0, sl, d), self._inflight,
                 deltas)
        first = first.cpu().numpy()
        last = last.cpu().numpy()
        times = self.runtime.draw_client_times(self._dispatch_idx, ids, k)
        self._dispatch_idx += 1
        for j, slot in enumerate(slots):
            self._slot_client[slot] = ids[j]
            self._slot_version[slot] = self._version
            self._slot_weight[slot] = float(w[j])
            self._slot_first[slot] = float(first[j])
            self._slot_last[slot] = float(last[j])
            self._slot_k[slot] = k
            heapq.heappush(self._heap, (float(self._sim_time + times[j]),
                                        self._seq, slot))
            self._seq += 1
        self.store.steps += k * m
        self.store.down_mbit += self.runtime.downlink_mbit_per_client * m

    def _fold_arrival(self, slot: int) -> None:
        """One arrival: a staleness-weighted fold, or a drop past
        ``max_staleness``. The wire is charged either way."""
        self.store.up_mbit += self.runtime.uplink_mbit_per_client
        s = int(self._version - self._slot_version[slot])
        self.staleness_hist[s] = self.staleness_hist.get(s, 0) + 1
        if self.max_staleness is not None and s > self.max_staleness:
            self.dropped_updates += 1
            return
        w = float(self._slot_weight[slot]) * float(self.staleness_weight(s))
        ef_on = self.transport is not None and self.transport.error_feedback
        ef = (tree_map(lambda t: t[slot:slot + 1], self.transport_state)
              if ef_on else ())
        delta = tree_map(lambda t: t[slot], self._inflight)
        self._buffer, new_ef = self._run_exe(
            "async-fold", self._fold_fn,
            (self._buffer, delta, np.float32(w), ef))
        if ef_on:
            tree_map(lambda t, n: t[slot:slot + 1].copy_(n),
                     self.transport_state, new_ef)
        self._buf_weight += w
        self._buf_count += 1
        self._buf_first_losses.append(float(self._slot_first[slot]))
        self._buf_staleness.append(s)

    def _apply_buffer(self, verbose: bool, eval_every: Optional[int]) -> None:
        self.params, self.server_state, self._buffer = self._run_exe(
            "async-apply", self._apply_fn,
            (self.params, self._buffer, np.float32(self._buf_weight),
             self.server_state))
        self.applied_updates += self._buf_count
        self._version += 1
        st = self.store
        round_loss = float(np.mean(self._buf_first_losses))
        self.ctrl.observe_round_losses(round_loss)
        st.min_loss = min(st.min_loss, round_loss)
        h = self.history
        r = self._version
        h.rounds.append(r)
        h.k.append(self.ctrl.k_for_round(r))
        h.eta.append(self.ctrl.eta_for_round(r))
        h.wall_clock_s.append(self._sim_time)     # the event clock is wall
        h.sgd_steps.append(st.steps)
        h.uplink_mbit.append(st.up_mbit)
        h.downlink_mbit.append(st.down_mbit)
        h.train_loss.append(round_loss)
        h.min_train_loss.append(st.min_loss)
        h.staleness.append(float(np.mean(self._buf_staleness)))
        h.applied_updates.append(self.applied_updates)
        h.dropped_updates.append(self.dropped_updates)
        self._buf_weight = 0.0
        self._buf_count = 0
        self._buf_first_losses = []
        self._buf_staleness = []
        if (self.serving is not None and self.serve_every
                and r % self.serve_every == 0):
            # hot-swap the version just applied into the decode service
            self.serving.tick(r, h)
        if eval_every and self.eval_fn is not None and r % eval_every == 0:
            metrics = self.eval_fn(self.params)
            err = metrics.get("error", 1.0 - metrics.get("acc", 0.0))
            self.ctrl.observe_validation(err)
            st.max_acc = max(st.max_acc, metrics.get("acc", 0.0))
            h.val_rounds.append(r)
            h.val_error.append(err)
            h.max_val_acc.append(st.max_acc)
        if verbose:
            print(f"apply {r:5d} K={h.k[-1]:3d} loss={round_loss:.4f} "
                  f"stale={h.staleness[-1]:.2f} W={self._sim_time:.1f}s "
                  f"applied={self.applied_updates} "
                  f"dropped={self.dropped_updates}")

    def run(self, rounds: Optional[int] = None, eval_every: int = 10,
            verbose: bool = False, resume: bool = False) -> History:
        """Advance the event clock until ``rounds`` buffers have been
        applied. The async engine has no schedule replay: a second call
        keeps advancing the same simulation, so ``resume`` changes
        nothing; it is accepted for ``FedAvgTrainer``'s surface."""
        del resume
        rounds = rounds if rounds is not None else self.fed.rounds
        if (self.serving is not None
                and self.serving.served_version != self.store.version):
            # a restored store is ahead of the loop's snapshot: swap before
            # the clock advances
            self.serving.swap()
        with self.backend.stream_context():
            if not self._started:
                self._dispatch_group(list(range(self.n)))
                self._started = True
            while self._version < rounds:
                if not self._heap:
                    raise RuntimeError("async event loop drained with no "
                                       "in-flight clients")
                t = self._heap[0][0]
                freed: List[int] = []
                # pop the whole same-time group in seq order, folding each
                # arrival and applying whenever the buffer fills, then
                # redispatch the freed slots as one group from the params
                # now
                while self._heap and self._heap[0][0] == t:
                    _, _, slot = heapq.heappop(self._heap)
                    self._sim_time = t
                    self._fold_arrival(slot)
                    freed.append(slot)
                    if self._buf_count >= self.buffer_size:
                        self._apply_buffer(
                            verbose, eval_every
                            if self.eval_fn is not None else None)
                self._dispatch_group(freed)
        self._completed_rounds = self._version
        return self.history

    # ------------------------------------------------------------------
    # checkpointing (bitwise resume)
    # ------------------------------------------------------------------
    def save_state(self, path: str,
                   extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Everything a bitwise continuation needs, in the reference's
        layout (reference :497-536)."""
        from repro_torch.checkpoint import save_checkpoint
        sd = self.store.state_dict()
        tree = {**sd["tree"], "buffer": self._buffer,
                "inflight": self._inflight}
        meta = {
            **(extra_meta or {}),
            "completed_rounds": self._completed_rounds,
            "history": self.history.as_dict(),
            "rng": self._np_rng.bit_generator.state,
            "runtime_rng": self.runtime._rng.bit_generator.state,
            "async": {
                "started": self._started,
                "sim_time": self._sim_time,
                "version": self._version,
                "seq": self._seq,
                "dispatch_idx": self._dispatch_idx,
                "heap": [[t, s, sl] for t, s, sl in self._heap],
                "slot_client": self._slot_client.tolist(),
                "slot_version": self._slot_version.tolist(),
                "slot_weight": self._slot_weight.tolist(),
                "slot_first": self._slot_first.tolist(),
                "slot_last": self._slot_last.tolist(),
                "slot_k": self._slot_k.tolist(),
                "buf_weight": self._buf_weight,
                "buf_count": self._buf_count,
                "buf_first_losses": self._buf_first_losses,
                "buf_staleness": self._buf_staleness,
                "applied_updates": self.applied_updates,
                "dropped_updates": self.dropped_updates,
                "staleness_hist": {str(k): v for k, v
                                   in self.staleness_hist.items()},
            },
            **sd["meta"],
            "ctrl": self.ctrl.state_dict(),
        }
        save_checkpoint(path, tree, meta=meta)

    def restore_state(self, path: str) -> None:
        """The inverse of ``save_state`` (of either package) on an engine
        built with the same configuration; tensors land on its device."""
        tree, meta = self.store.load_checkpoint_tree(
            path, extra_like={"buffer": self._buffer,
                              "inflight": self._inflight})
        self.store.restore_tree(tree)
        self._buffer = tree["buffer"]
        self._inflight = tree["inflight"]
        a = meta["async"]
        self._started = bool(a["started"])
        self._sim_time = float(a["sim_time"])
        self._seq = int(a["seq"])
        self._dispatch_idx = int(a["dispatch_idx"])
        self._heap = [(float(t), int(s), int(sl)) for t, s, sl in a["heap"]]
        heapq.heapify(self._heap)
        self._slot_client = np.asarray(a["slot_client"], np.int64)
        self._slot_version = np.asarray(a["slot_version"], np.int64)
        self._slot_weight = np.asarray(a["slot_weight"], np.float64)
        self._slot_first = np.asarray(a["slot_first"], np.float64)
        self._slot_last = np.asarray(a["slot_last"], np.float64)
        self._slot_k = np.asarray(a["slot_k"], np.int64)
        self._buf_weight = float(a["buf_weight"])
        self._buf_count = int(a["buf_count"])
        self._buf_first_losses = [float(x) for x in a["buf_first_losses"]]
        self._buf_staleness = [int(x) for x in a["buf_staleness"]]
        self.applied_updates = int(a["applied_updates"])
        self.dropped_updates = int(a["dropped_updates"])
        self.staleness_hist = {int(k): int(v)
                               for k, v in a["staleness_hist"].items()}
        self._completed_rounds = int(meta["completed_rounds"])
        self.history = History.from_dict(meta["history"])
        self._np_rng.bit_generator.state = meta["rng"]
        self.runtime._rng.bit_generator.state = meta["runtime_rng"]
        # meta without store_version: the applied-buffer count is the
        # version
        self.store.load_counters_meta(meta,
                                      default_version=int(a["version"]))
        self.ctrl.load_state_dict(meta["ctrl"])
