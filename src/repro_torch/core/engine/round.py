"""Round execution: the single-round core, the bucket functions and the
bucket program registry.

Layering, as in ``repro.core.engine.round``:

    ClientUpdate    (engine.client)      — K-step local SGD, vmapped over clients
    Aggregator      (engine.aggregators) — client stack -> aggregate
    ServerOptimizer (engine.server)      — aggregate -> next global params
    ExecutionBackend (engine.backends)   — where the fan-out runs: one device
                                           (LocalBackend) or the ranks of a
                                           mesh (MeshBackend)

``RoundEngine`` takes its round core from its backend and runs *buckets*:
consecutive rounds that share one quantized K, as one ``run_bucket``
dispatch over the bucket's round axis B. Each distinct input signature
(structure, shapes and dtypes of params, batches, weights, etas, active
and the states) gets exactly one ``BucketProgram`` in an
``ExecutableRegistry``, built the first time its key is seen, so with K
snapped to the geometric grid (``quantize_k``) ``compile_count`` is bounded
by the grid and counts the registry's entries exactly. Where the reference
AOT-compiles an XLA executable per key, a bucket program holds the bucket
function, which PyTorch runs eagerly; it is the unit a CUDA graph would
capture, keyed and counted the same way. A registry shared by several
engines (``registry=``, ``program_key=``) hands an entry built by one to
the others, which count it in ``shared_count``.

Buckets shorter than their shape are padded with ``active=False`` rounds.
The port does not compute a padding round: the host knows ``active``, so
the bucket function skips it, which leaves params, server state and codec
state bitwise untouched (the reference's ``jnp.where`` select). A padding
round's loss row is NaN and its adaptive downlink level -1; the trainer
reads only active rows.

With a transport or downlink codec (``engine.transport``) the engine threads
the codec state (``transport_state``, ``downlink_state``) through every
``run_bucket``; the state lives in a ``GlobalModelStore`` (the engine's own,
or the trainer's after ``bind_store``). A codec bound to a fixed cohort
(``Transport.with_ef_slots``) holds one residual a cohort slot, leaves
``(ef_slots, ...)``; the engine threads it the same way, and slot j meets
client cohort[j] in every round (reference ``round.py:313-364``, :503,
:553).

Streaming cohorts (``cohort_chunk=C``): ``run_round_chunked`` runs one
round as ceil(U/C) slabs of C clients through the backend's slab cores
(``make_slab_cores``), as ``"slab"`` and ``"slabfin"`` programs of the same
registry, so the device holds C clients' state at a time (reference
``round.py:531-590``). Per-client residual slices commit after the round's
finalize, never mid-round.

A backend with a stream of its own (a fleet slice on the card,
``LocalBackend.fleet_slices``) gets every round issued on that stream.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine.aggregators import (LINEAR_AGGREGATORS,
                                                 get_aggregator)
from repro_torch.core.engine.backends import (ExecutionBackend,
                                              LocalBackend,
                                              make_parallel_round_core)
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.core.engine.transport import get_downlink, get_transport
from repro_torch.data.pipeline import BucketBatch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]


def _eta(eta) -> float:
    """The client learning rate rounded to f32, as the reference feeds it."""
    return float(np.float32(eta))


def make_round_core(loss_fn: LossFn, aggregator, server, server_lr: float):
    """round_core(params, batches{(N,K,b,...)}, weights (N,), eta, state)
    -> (new_params, first_losses (N,), last_losses (N,), state)."""
    core = make_parallel_round_core(loss_fn, aggregator, server, server_lr)
    return lambda params, batches, weights, eta, state: core(
        params, batches, weights, eta, state)[:4]


def _round_inputs(batches, weights, etas, i: int):
    """Round ``i`` of a bucket: its batches (N, K, b, ...), weights (N,)
    and eta."""
    return ({k: v[i] for k, v in batches.items()}, weights[i],
            _eta(etas[i]))


def _stack_rows(rows):
    """(B, ...) from per-round rows; a padding round (None) is a NaN row
    shaped like the active ones."""
    like = next((r for r in rows if r is not None), None)
    if like is None:
        raise ValueError("a bucket needs at least one active round")
    return torch.stack([r if r is not None
                        else torch.full_like(like, math.nan) for r in rows])


def _stack_levels(levels):
    """(B,) int32 adaptive levels; -1 for a padding round."""
    like = next(lv for lv in levels if lv is not None)
    return torch.stack([lv if lv is not None else torch.full_like(like, -1)
                        for lv in levels])


def make_bucket_fn(round_core):
    """A loop over a K-bucket's rounds.

    bucket_fn(params, batches{(B,N,K,b,...)}, weights (B,N), etas (B,),
              active (B,) bool, server_state)
        -> (new_params, first_losses (B,N), last_losses (B,N), server_state)

    ``etas`` and ``active`` are host arrays; an inactive round is not run.
    """
    def bucket_fn(params, batches, weights, etas, active, server_state):
        firsts, lasts = [], []
        for i, act in enumerate(active):
            first = last = None
            if act:
                params, first, last, server_state = round_core(
                    params, *_round_inputs(batches, weights, etas, i),
                    server_state)
            firsts.append(first)
            lasts.append(last)
        return params, _stack_rows(firsts), _stack_rows(lasts), server_state

    return bucket_fn


def make_transport_bucket_fn(round_core):
    """The bucket loop for a transport-threaded core: the codec's
    error-feedback state threads the rounds beside params and server state,
    untouched by a padding round.

    bucket_fn(params, batches, weights, etas, active, server_state, t_state)
        -> (new_params, first_losses, last_losses, server_state, t_state)
    """
    def bucket_fn(params, batches, weights, etas, active, server_state,
                  t_state):
        firsts, lasts = [], []
        for i, act in enumerate(active):
            first = last = None
            if act:
                params, first, last, server_state, t_state = round_core(
                    params, *_round_inputs(batches, weights, etas, i),
                    server_state, t_state)
            firsts.append(first)
            lasts.append(last)
        return (params, _stack_rows(firsts), _stack_rows(lasts),
                server_state, t_state)

    return bucket_fn


def make_downlink_bucket_fn(round_core):
    """The bucket loop for a downlink core: the trailing state is the
    downlink state (or the ``(uplink, downlink)`` pair), and each round's
    adaptive level stacks into a ``(B,)`` int32 output, -1 for a padding
    round (the trainer charges no wire for it).

    bucket_fn(params, batches, weights, etas, active, server_state, extra)
        -> (new_params, first_losses, last_losses, server_state, extra,
            levels (B,) int32)
    """
    def bucket_fn(params, batches, weights, etas, active, server_state,
                  extra):
        firsts, lasts, levels = [], [], []
        for i, act in enumerate(active):
            first = last = level = None
            if act:
                params, first, last, server_state, extra, level = round_core(
                    params, *_round_inputs(batches, weights, etas, i),
                    server_state, extra)
            firsts.append(first)
            lasts.append(last)
            levels.append(level)
        return (params, _stack_rows(firsts), _stack_rows(lasts),
                server_state, extra, _stack_levels(levels))

    return bucket_fn


def _leaf_signature(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    if isinstance(x, np.ndarray):
        return x.shape, x.dtype.name
    return (), np.asarray(x).dtype.name


def _as_rows(tree, rows: int):
    """Shape-only (``meta``) stand-ins of ``tree``'s leaves with ``rows``
    leading rows: a slab's key whatever this rank's share of its rows."""
    return tree_map(lambda x: torch.empty(
        (rows,) + tuple(x.shape[1:]), dtype=torch.as_tensor(x[:0]).dtype,
        device="meta"), tree)


def _signature(args) -> Tuple:
    """Hashable (structure, leaf shapes and dtypes) key of the registry;
    tensors, numpy arrays and Python numbers alike."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if x is None:
            return None
        leaves.append(_leaf_signature(x))
        return "*"

    return walk(args), tuple(leaves)


class ExecutableRegistry:
    """The process's bucket programs, shareable across experiments.

    Entries are keyed ``(program_key, codec signature, input signature)``,
    so two experiments share a program exactly when they would build the
    same one for the same inputs. The fleet runner hands one registry to
    every sweep point; points whose model, bucket and codec signatures
    coincide build once and dispatch N times.

    ``get_or_build`` is thread-safe and single-flight: when packed sweep
    points race on one key, exactly one thread builds while the rest wait
    on the in-flight event, so the counters stay exact under packing.
    """

    def __init__(self):
        self._entries: Dict[Tuple, Any] = {}
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0          # lookups served from an existing entry
        self.misses = 0        # lookups that built a new entry

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def compile_count(self) -> int:
        """Distinct programs built into this registry (exact)."""
        return len(self._entries)

    def executables(self) -> Tuple[Any, ...]:
        with self._lock:
            return tuple(self._entries.values())

    def get_or_build(self, key: Tuple, build: Callable[[], Any]
                     ) -> Tuple[Any, bool]:
        """``(program, built)``: the entry for ``key``, or the result of
        ``build()`` stored under it. ``built`` is True only for the caller
        that built; a caller that waited on an in-flight build gets False,
        so per-engine counters never count one build twice."""
        while True:
            with self._lock:
                exe = self._entries.get(key)
                if exe is not None:
                    self.hits += 1
                    return exe, False
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    break
            ev.wait()           # another thread is building this key
        try:
            exe = build()
        except BaseException:
            with self._lock:
                del self._inflight[key]
            ev.set()
            raise
        with self._lock:
            self._entries[key] = exe
            del self._inflight[key]
            self.misses += 1
        ev.set()
        return exe, True


class BucketProgram:
    """One registry entry: the function that runs one key's buckets (or
    slabs, or async steps), built once, with the backend signature it was
    built for (a mesh's strategy, groups, acc_dtype and reduce).

    On the card its first run records the allocator's peak
    (``peak_bytes``, read by ``core.mem.executable_peak_bytes``): the
    device synchronises, the allocator's peak counter is reset, the
    function runs, and the peak is read after a second synchronisation.
    On the CPU ``peak_bytes`` stays 0, as the reference's where the runtime
    keeps no memory statistics."""

    def __init__(self, fn: Callable, device: DeviceLike,
                 backend_sig: Tuple = ()):
        self.fn = fn
        self.device = torch.device(device)
        #: the backend's ``program_signature()`` it was built for
        self.backend_sig = backend_sig
        self.peak_bytes = 0
        self._measured = self.device.type != "cuda"
        self._lock = threading.Lock()

    def __call__(self, *args):
        if not self._measured:
            with self._lock:
                first, self._measured = not self._measured, True
            if first:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                out = self.fn(*args)
                torch.cuda.synchronize(self.device)
                self.peak_bytes = torch.cuda.max_memory_allocated(
                    self.device)
                return out
        return self.fn(*args)


class RoundEngine:
    """Runs buckets of rounds through per-signature bucket programs; its
    backend decides where."""

    def __init__(self, loss_fn: LossFn, *, aggregator: str = "mean",
                 trim_fraction: float = 0.1, server: str = "avg",
                 server_lr: float = 1.0,
                 backend: Optional[ExecutionBackend] = None, transport=None,
                 topk_frac: float = 0.1, downlink=None,
                 downlink_ref: str = "f32", cohort_chunk=None,
                 registry: Optional[ExecutableRegistry] = None,
                 program_key: Optional[Tuple] = None,
                 device: DeviceLike = None):
        """``transport``: None/"none" keeps the plain aggregator path;
        "int8"/"int8x2"/"topk" (or a ``Transport``) aggregates compressed
        deltas and needs a linear aggregator. ``downlink``: None/"none"
        keeps the uncompressed broadcast; a codec name makes every round
        start from ``params_ref + decode(payload)``. ``downlink_ref``: the
        store of the broadcast reference and residual, "f32" or "q8";
        anything but "f32" needs a downlink codec. ``backend``: the round
        core and the placement (None: ``LocalBackend(device)``); a given
        backend brings its device, which ``device`` may only repeat.
        ``cohort_chunk``: stream each round in slabs of this many clients
        (``run_round_chunked``); needs a linear aggregator and no downlink
        codec. ``registry``: an ``ExecutableRegistry`` shared with other
        engines, which needs a ``program_key``: a hashable fingerprint of
        everything that shapes the bucket function but is not in its input
        signature (``api.sweep.spec_program_key``). Omitted, the engine
        owns a private registry."""
        if backend is None:
            backend = LocalBackend(device)
        elif device is not None and \
                torch.device(device).type != backend.device.type:
            raise ValueError(f"device={str(device)!r} but the {backend.name} "
                             f"backend runs on {backend.device}")
        self.backend = backend
        self.device = backend.device
        self.transport = get_transport(transport, topk_frac=topk_frac)
        if self.transport is not None and \
                self.transport.name != "none" and \
                aggregator not in LINEAR_AGGREGATORS:
            raise ValueError(
                f"transport {self.transport.name!r} requires a linear "
                f"aggregator {LINEAR_AGGREGATORS}, got {aggregator!r}")
        self.downlink = backend.bind_downlink(
            get_downlink(downlink, topk_frac=topk_frac,
                         ref_store=downlink_ref))
        if self.downlink is None and downlink_ref != "f32":
            raise ValueError(
                f"downlink_ref={downlink_ref!r} requires a downlink codec")
        self.server = get_server_optimizer(server)
        self.round_core = backend.make_round_core(
            loss_fn, aggregator=aggregator, trim_fraction=trim_fraction,
            server=self.server, server_lr=server_lr,
            transport=self.transport, downlink=self.downlink)
        self.cohort_chunk = cohort_chunk
        if cohort_chunk:
            if self.downlink is not None:
                raise ValueError(
                    "cohort_chunk cannot combine with a downlink codec: the "
                    "broadcast reference advances round-atomically and "
                    "does not stream over slabs")
            if aggregator not in LINEAR_AGGREGATORS:
                raise ValueError(
                    f"cohort_chunk requires a linear aggregator "
                    f"{LINEAR_AGGREGATORS}: streaming slabs fold into a "
                    f"running weighted sum, got {aggregator!r}")
            self.slab_core, self.finalize_core = backend.make_slab_cores(
                loss_fn, aggregator=aggregator, server=self.server,
                server_lr=server_lr, transport=self.transport)
        # the codecs' signatures are part of every registry key; the
        # downlink's nests around the uplink's only when there is one
        self._codec_sig = (() if self.transport is None
                           else self.transport.signature())
        if self.downlink is not None:
            self._codec_sig = (self._codec_sig, self.downlink.signature())
        # a mesh's strategy, groups, acc_dtype and reduce shape the program
        # too; they join the key after the codecs' (local keys unchanged)
        self._backend_sig = backend.program_signature()
        self._bucket_fn = self._make_bucket_fn()
        if registry is not None and program_key is None:
            raise ValueError(
                "a shared ExecutableRegistry requires a program_key: the "
                "registry is keyed across experiments, so the engine must "
                "know which program its entries belong to")
        self._registry = registry if registry is not None \
            else ExecutableRegistry()
        self._program_key = program_key if program_key is not None else ()
        # the entries this engine used, by full key: the ones it built
        # count in compile_count, the ones another engine built in
        # shared_count
        self._executables: Dict[Tuple, BucketProgram] = {}
        self._own_keys: set = set()
        self._shared_keys: set = set()
        self.dispatch_count = 0
        # the codec state lives in a store: this private one until a
        # trainer binds its own (``bind_store``)
        self._store = GlobalModelStore(downlink=self.downlink)
        #: the (B,) int32 adaptive downlink levels of the most recent
        #: bucket, on the device (-1: a padding round or a fixed-rate
        #: codec); None without a downlink
        self.last_downlink_levels = None

    def _make_bucket_fn(self):
        """The bucket function over the backend's round core, which always
        takes and returns both codec states and the level: each form below
        threads only the states the engine has, as the reference's."""
        core, has_t = self.round_core, self.transport is not None
        if self.downlink is not None:
            def downlink_core(params, batches, weights, eta, state, extra):
                t_state, d_state = extra if has_t else ((), extra)
                out = core(params, batches, weights, eta, state, t_state,
                           d_state)
                return (*out[:4], (out[4], out[5]) if has_t else out[5],
                        out[6])

            return make_downlink_bucket_fn(downlink_core)
        if has_t:
            return make_transport_bucket_fn(
                lambda params, batches, weights, eta, state, t_state: core(
                    params, batches, weights, eta, state, t_state)[:5])
        return make_bucket_fn(
            lambda params, batches, weights, eta, state: core(
                params, batches, weights, eta, state)[:4])

    def bind_store(self, store: GlobalModelStore) -> GlobalModelStore:
        """Adopt a trainer-owned store as the owner of the codec state;
        state the private store holds moves over, and so does the codec
        binding, so ``store.snapshot()`` loads through this downlink."""
        store.downlink = self.downlink
        store.gather = self.backend.gather_state
        store.transport_state = self._store.transport_state
        store.downlink_state = self._store.downlink_state
        self._store = store
        return store

    transport_state = property(
        lambda self: self._store.transport_state,
        lambda self, v: setattr(self._store, "transport_state", v))
    downlink_state = property(
        lambda self: self._store.downlink_state,
        lambda self, v: setattr(self._store, "downlink_state", v))

    def to_device(self, x) -> torch.Tensor:
        return self.backend.to_device(x)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """Host -> device copy of a bucket's batches and weights, this
        rank's client rows on a mesh (the builders' ``place_fn``)."""
        return self.backend.place_bucket(bb)

    def _lookup(self, key: Tuple, fn: Callable) -> BucketProgram:
        """The program for ``key``, built on a miss.

        The full key leads with ``program_key``, so a shared registry never
        aliases two experiments' programs; a private registry keeps the
        bare key (``key[0]`` the "slab"/"slabfin" tag of a chunked round).
        A key this engine built counts in ``compile_count``, one another
        engine built in ``shared_count``, never both."""
        if self._backend_sig:
            key = (self._backend_sig,) + key
        full_key = (self._program_key,) + key if self._program_key else key
        exe = self._executables.get(full_key)
        if exe is None:
            exe, built = self._registry.get_or_build(
                full_key, lambda: BucketProgram(fn, self.device,
                                                self._backend_sig))
            self._executables[full_key] = exe
            (self._own_keys if built else self._shared_keys).add(full_key)
        return exe

    def init_server_state(self, params: PyTree) -> Any:
        return self.server.init(params)

    def init_transport_state(self, params: PyTree) -> Any:
        """Create (and own) the uplink codec's error-feedback state."""
        self.transport_state = (() if self.transport is None
                                else self.transport.init_state(params))
        return self.transport_state

    def init_downlink_state(self, params: PyTree) -> Any:
        """Create (and own) the broadcast reference and downlink
        residual."""
        self.downlink_state = (() if self.downlink is None
                               else self.downlink.init_state(params))
        return self.downlink_state

    def run_bucket(self, params, batches, weights, etas, active,
                   server_state
                   ) -> Tuple[PyTree, torch.Tensor, torch.Tensor, Any]:
        """One bucket: batches leaves (B, N, K, b, ...), weights (B, N),
        etas and active (B,), host arrays of the whole cohort or placed by
        ``place_bucket`` (the backend's placement is idempotent). Returns
        (params, first_losses (B, N), last_losses (B, N), server_state);
        a padding round's loss rows are NaN."""
        be = self.backend
        with be.stream_context():
            params = be.place_params(params)
            server_state = be.place_state(server_state)
            batches = be.place_batches(batches)
            weights = be.place_weights(weights)
            etas, active = be.place_scalars(etas, active)
            has_t, has_d = self.transport is not None, \
                self.downlink is not None
            args = (params, batches, weights, etas, active, server_state)
            per_client = has_t and self.transport.ef_slots is not None
            if has_t:
                if self.transport_state is None:
                    self.init_transport_state(params)
                # per-client slots: this rank's clients' (a mesh)
                t_state = be.place_transport_state(self.transport_state,
                                                   per_client=per_client)
            if has_d:
                if self.downlink_state is None:
                    self.init_downlink_state(params)
                d_state = be.place_state(self.downlink_state)
                args += ((t_state, d_state) if has_t else d_state,)
            elif has_t:
                args += (t_state,)
            key = (self._codec_sig,) + _signature(be.signature_args(args))
            program = self._lookup(key, self._bucket_fn)
            self.dispatch_count += 1
            out = program(*args)
            params, firsts, lasts, server_state = out[:4]
            if has_d:
                self.last_downlink_levels = out[5]
                if has_t:
                    t_state, self.downlink_state = out[4]
                else:
                    self.downlink_state = out[4]
            elif has_t:
                t_state = out[4]
            if has_t:
                self.transport_state = be.collect_transport_state(
                    t_state, per_client=per_client)
        return params, firsts, lasts, server_state

    def run_round_chunked(self, params, slabs, eta, server_state
                          ) -> Tuple[PyTree, torch.Tensor, torch.Tensor, Any]:
        """One round as streamed C-client slabs.

        ``slabs``: ``pipeline.SlabBatch``es covering the round's cohort in
        order (host arrays or placed by ``place_slab``). The device holds
        the params-shaped f32 sums and the current slab's residual slice
        across slabs. Returns ``run_bucket``'s 4-tuple, the losses
        ``(1, U)``. Per-client residual slices are kept aside and replace
        ``transport_state`` only after the finalize, so a checkpoint
        between rounds never sees mid-round state; one dispatch a
        round."""
        if not self.cohort_chunk:
            raise ValueError("engine was built without cohort_chunk")
        be = self.backend
        with be.stream_context():
            params = be.place_params(params)
            server_state = be.place_state(server_state)
            t = self.transport
            if t is not None and self.transport_state is None:
                self.init_transport_state(params)
            per_client = t is not None and t.ef_slots is not None
            agg_ef = t is not None and t.error_feedback and not per_client
            # the residual whole on every rank for the round (a mesh
            # with sharded params holds blocks between rounds)
            state = be.gather_state(self.transport_state) if t else ()
            eta = _eta(eta)
            # the reference's slab key sees its zero-filled f32 sums from
            # the first slab on; the port starts from None, so the key
            # takes shape-only stand-ins of the sums
            sums = tree_map(lambda p: torch.empty(
                p.shape, dtype=torch.float32, device="meta"), params)
            acc_sig = (sums, sums if agg_ef else ())
            acc = (None, None)
            firsts, lasts, ef_parts, positions = [], [], [], []
            for sb in slabs:
                sb = be.place_slab(sb)
                ef = ()
                if per_client:
                    ef = tree_map(lambda s: s[sb.start:sb.stop], state)
                    positions.extend(range(sb.start, sb.stop))
                elif agg_ef:
                    ef = state
                # keyed on the whole slab's rows (``ids``), so every rank
                # of a mesh keys alike whatever its share of the slab
                rows = len(sb.ids)
                key = ("slab", self._codec_sig) + _signature(
                    be.signature_args((params, _as_rows(sb.batches, rows),
                                       _as_rows(sb.weights, rows), eta,
                                       acc_sig, _as_rows(ef, rows)
                                       if per_client else ef)))
                program = self._lookup(key, self.slab_core)
                acc, f, l, ef = program(params, sb.batches, sb.weights, eta,
                                        acc, ef)
                firsts.append(f)
                lasts.append(l)
                if per_client:
                    ef_parts.append(ef)
            if not firsts:
                raise ValueError("run_round_chunked got an empty slab stream")
            key = ("slabfin", self._codec_sig) + _signature(
                be.signature_args((params, acc_sig, server_state)))
            program = self._lookup(key, self.finalize_core)
            new_params, server_state, new_res = program(params, acc,
                                                        server_state)
            if per_client:
                # this rank's rows of every slab, gathered to the cohort
                self.transport_state = be.collect_transport_state(
                    tree_map(lambda *xs: torch.cat(xs, dim=0), *ef_parts),
                    per_client=True, positions=positions)
            elif agg_ef:
                self.transport_state = be.place_state(new_res)
            self.dispatch_count += 1
            return (new_params, torch.cat(firsts)[None],
                    torch.cat(lasts)[None], server_state)

    @property
    def compile_count(self) -> int:
        """Distinct bucket programs this engine built (exact). With a
        private registry it is the registry's size; programs adopted from
        a shared registry count in ``shared_count`` instead."""
        return len(self._own_keys)

    @property
    def shared_count(self) -> int:
        """Distinct programs this engine took from a shared registry
        without building them (0 with a private registry)."""
        return len(self._shared_keys)

    @property
    def registry(self) -> ExecutableRegistry:
        return self._registry


def make_round_fn(loss_fn: LossFn, *, server: str = "avg",
                  server_lr: float = 1.0, aggregator: str = "mean",
                  device: DeviceLike = None):
    """Single-round builder.

    round_fn(params, batches{(N,K,b,...)}, weights (N,), eta, server_state)
        -> (new_params, first_losses (N,), mean_last_loss, server_state)

    Returns ``(round_fn, srv_init)``; ``srv_init`` is None for the stateless
    ``avg`` server (its state is ``()``). Inputs may be numpy arrays or
    tensors; they are placed on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    srv = get_server_optimizer(server)
    core = make_round_core(loss_fn, get_aggregator(aggregator), srv,
                           server_lr)

    def round_fn(params, batches, weights, eta, server_state):
        place = lambda x: torch.as_tensor(x, device=device)
        new_params, first_losses, last_losses, server_state = core(
            tree_map(place, params), {k: place(v) for k, v in
                                      batches.items()},
            place(weights), _eta(eta), server_state)
        return new_params, first_losses, torch.mean(last_losses), \
            server_state

    srv_init = None if server == "avg" else srv.init
    return round_fn, srv_init
