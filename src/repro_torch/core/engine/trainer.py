"""FedAvgTrainer: Algorithm 1, driven round by round, on one device or,
with a ``MeshBackend``, with the cohort's clients spread over the ranks of
a mesh (one trainer a rank; every rank keeps the same History).

ClientSampler (who runs, with what weights) -> RoundScheduler (K-bucket
plan) -> BatchPrefetcher (host tensors for the next bucket, built and
copied to the device on a background thread) -> RoundEngine (one dispatch
a bucket, through the bucket program of its signature) -> DecayController
feedback. A sampler with a ``stateful_cohort``
(``fixed_cohort``) gives a codec with error feedback one residual slot a
client (``Transport.with_ef_slots``).

Synchronisation policy, as in ``repro.core.engine.trainer``:
  * loss-free schedules (fixed/dsgd/rounds/cosine x fixed/rounds) never
    block mid-plan: bucket r's losses are read back only after bucket r+1
    has been dispatched;
  * error/step schedules sync at every bucket boundary.

The builder is asked for whole buckets (``n_rounds=len(bucket)``, padded
to the bucket's shape; padding rounds draw nothing), so a bucket of shape 8
on CIFAR100 at paper width is 8 x 491.5 MB of batches on the device, twice
that with the prefetched next bucket. ``registry`` and ``program_key``
share bucket programs with other experiments (the fleet runner);
``compile_count`` and ``shared_count`` count them as the reference's.

The server-side state (params, server-optimizer state, codec state,
version, cost counters) lives in a ``GlobalModelStore``; the trainer's and
the engine's attributes of the same names read and write it. Serving while
training: ``api.build`` attaches a ``ServingLoop`` (``serving``) and its
cadence (``serve_every``); the scheduler cuts buckets at serve rounds, and
each serve bucket is absorbed, and the loop ticked, before the next
dispatch commits, which bounds the served version's staleness.
``save_state``/``restore_state`` checkpoint everything a bitwise
continuation needs, in the reference's layout, and ``run(...,
resume=True)`` continues from the first round not run.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.engine.aggregators import LINEAR_AGGREGATORS
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.engine.round import LossFn, RoundEngine
from repro_torch.core.engine.sampling import make_sampler
from repro_torch.core.engine.scheduler import Bucket, RoundScheduler
from repro_torch.core.engine.transport import get_transport
from repro_torch.core.runtime_model import RuntimeModel
from repro_torch.core.schedules import DecayController
from repro_torch.data import pipeline
from repro_torch.data.synthetic import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_map

PyTree = Any


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    k: List[int] = field(default_factory=list)
    eta: List[float] = field(default_factory=list)
    wall_clock_s: List[float] = field(default_factory=list)   # cumulative, Eq. 5
    sgd_steps: List[int] = field(default_factory=list)        # cumulative
    uplink_mbit: List[float] = field(default_factory=list)    # cumulative wire
    downlink_mbit: List[float] = field(default_factory=list)  # cumulative wire
    train_loss: List[float] = field(default_factory=list)     # Eq. 15 round mean
    min_train_loss: List[float] = field(default_factory=list) # Fig. 1 metric
    val_rounds: List[int] = field(default_factory=list)
    val_error: List[float] = field(default_factory=list)
    max_val_acc: List[float] = field(default_factory=list)    # Fig. 2 metric
    # async buffered aggregation (empty for sync runs)
    staleness: List[float] = field(default_factory=list)      # per-apply mean
    applied_updates: List[int] = field(default_factory=list)  # cumulative
    dropped_updates: List[int] = field(default_factory=list)  # cumulative
    serve_rounds: List[int] = field(default_factory=list)     # ServingLoop.tick
    serve_tokens_per_sec: List[float] = field(default_factory=list)
    serve_swap_us: List[float] = field(default_factory=list)  # snapshot swap
    serve_staleness: List[int] = field(default_factory=list)  # versions behind

    def as_dict(self) -> Dict[str, list]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, list]) -> "History":
        """The inverse of ``as_dict``; missing fields start empty, and
        fields this schema lacks are dropped with a warning."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            warnings.warn(
                f"History.from_dict: ignoring unknown field(s) {unknown} "
                f"(checkpoint written by a different History schema?)",
                stacklevel=2)
        return cls(**{k: list(v) for k, v in d.items() if k in names})


def _refuse_async(fed: FedConfig) -> None:
    """This trainer is the synchronous round; without the refusal an async
    configuration would run sync silently."""
    if fed.aggregation != "sync":
        raise ValueError(
            f"fed.aggregation={fed.aggregation!r}: FedAvgTrainer runs the "
            f"synchronous round; build the experiment with "
            f"repro_torch.api.build, or construct "
            f"core.engine.AsyncBufferedEngine")


class FedAvgTrainer:
    def __init__(self, loss_fn: LossFn, init_params: PyTree,
                 data: FederatedData, fed: FedConfig,
                 runtime: RuntimeModel,
                 eval_fn: Optional[Callable[[PyTree], Dict[str, float]]] = None,
                 *, device: DeviceLike = None, backend=None,
                 registry=None, program_key=None):
        """``device``: where the rounds run (default ``cuda``, which raises
        without a card); ``init_params`` are copied there. ``backend``: an
        ``engine.backends.ExecutionBackend`` (default ``LocalBackend``);
        with a ``MeshBackend`` every rank runs this trainer on the same
        seed and ``init_params``, and it brings its own device.
        ``registry``/``program_key``: a shared ``ExecutableRegistry`` and
        the experiment's program fingerprint, passed to the
        ``RoundEngine`` (default: a private registry)."""
        _refuse_async(fed)
        self.sampler = make_sampler(fed)
        if (self.sampler.needs_weighted_aggregation
                and fed.aggregator not in LINEAR_AGGREGATORS):
            # an availability shortfall pads the cohort at weight 0, which
            # median/trimmed_mean would aggregate as full participants
            # (reference trainer.py:142)
            raise ValueError(
                f"sampler {self.sampler.name!r} encodes participation in "
                f"the aggregation weights and needs a weight-respecting "
                f"aggregator {LINEAR_AGGREGATORS}, got {fed.aggregator!r}")
        transport = get_transport(fed.transport, topk_frac=fed.topk_frac)
        if (transport is not None and transport.error_feedback
                and self.sampler.stateful_cohort):
            # a fixed cohort: slot j is the same client every round, so the
            # codec keeps one residual a client (reference trainer.py:153)
            transport = transport.with_ef_slots(fed.clients_per_round)
        self.engine = RoundEngine(loss_fn, aggregator=fed.aggregator,
                                  trim_fraction=fed.trim_fraction,
                                  server=fed.server_optimizer,
                                  server_lr=fed.server_lr,
                                  transport=transport,
                                  topk_frac=fed.topk_frac,
                                  downlink=fed.downlink,
                                  downlink_ref=fed.downlink_ref,
                                  cohort_chunk=fed.cohort_chunk,
                                  backend=backend, registry=registry,
                                  program_key=program_key, device=device)
        self.device = self.engine.device
        self.store = self.engine.bind_store(GlobalModelStore())
        self.params = tree_map(self.engine.to_device, init_params)
        self.server_state = self.engine.init_server_state(self.params)
        self.engine.init_transport_state(self.params)
        self.engine.init_downlink_state(self.params)
        self.data = data
        self.fed = fed
        self.runtime = self._wire_runtime(runtime)
        self.eval_fn = eval_fn
        self.ctrl = DecayController(fed)
        self.history = History()
        self._np_rng = np.random.default_rng(fed.seed)
        self._completed_rounds = 0
        # serve while training: set by ``api.build`` when the spec serves
        self.serving = None
        self.serve_every = 0

    # the store owns the state; these names read and write it (``params``
    # reads whole leaves where a mesh holds sharded blocks)
    params = property(lambda self: self.store.gather(self.store.params),
                      lambda self, v: setattr(self.store, "params", v))
    server_state = property(
        lambda self: self.store.server_state,
        lambda self, v: setattr(self.store, "server_state", v))

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    @property
    def shared_count(self) -> int:
        """Bucket programs taken from a shared registry without building
        them."""
        return self.engine.shared_count

    @property
    def dispatch_count(self) -> int:
        return self.engine.dispatch_count

    def _wire_runtime(self, runtime: RuntimeModel) -> RuntimeModel:
        """Charge each wire leg what its codec ships, on a copy of the
        runtime model (one may be shared by trainers with other codecs)
        whose straggler rng continues the shared one's stream."""
        up, down = self.engine.transport, self.engine.downlink
        if up is None and down is None:
            return runtime
        rt = copy.copy(runtime)
        rt._rng = np.random.default_rng()
        rt._rng.bit_generator.state = runtime._rng.bit_generator.state
        if up is not None:
            rt.uplink_compression = up.compression_ratio(self.params)
        if down is not None:
            rt.downlink_compression = down.compression_ratio(self.params)
            if hasattr(down, "level_ratios"):   # adaptive: per-level charge
                rt.downlink_level_ratios = down.level_ratios(self.params)
        return rt

    def run(self, rounds: Optional[int] = None, eval_every: int = 10,
            verbose: bool = False, resume: bool = False) -> History:
        """Run rounds 1..``rounds`` of the schedule. A repeated call replays
        the schedule from round 1 and continues the sample stream;
        ``resume=True`` continues a restored run (``restore_state``) from
        the first round not run."""
        rounds = rounds if rounds is not None else self.fed.rounds
        start = self._completed_rounds + 1 if resume else 1
        if start > rounds:
            return self.history
        sched = RoundScheduler(
            self.ctrl, self.fed, total_rounds=rounds,
            eval_every=eval_every if self.eval_fn is not None else None,
            serve_every=self.serve_every if self.serving is not None
            else None,
            start_round=start)
        if (self.serving is not None
                and self.serving.served_version != self.store.version):
            # a restored (or rerun) store is ahead of the loop's snapshot:
            # swap, so the first tick's staleness measures this run
            self.serving.swap()
        builder = pipeline.make_builder(
            self.data, self.fed.clients_per_round, self.fed.batch_size,
            self._np_rng,
            background=self.fed.prefetch and sched.loss_free,
            place_fn=self.engine.place_bucket,
            sampler=self.sampler, chunk=self.fed.cohort_chunk,
            place_slab_fn=self.engine.backend.place_slab)
        try:
            with self.engine.backend.stream_context():
                if sched.loss_free:
                    self._run_pipelined(sched, builder, verbose)
                else:
                    self._run_feedback(sched, builder, verbose)
        finally:
            builder.close()
        self._completed_rounds = rounds
        return self.history

    # ------------------------------------------------------------------
    def _submit(self, builder, bucket: Bucket) -> None:
        """Announce a bucket to the builder: a whole K-bucket padded to its
        shape, or under streaming cohorts the bucket's one round as its
        slabs."""
        if self.fed.cohort_chunk:
            builder.submit_slabs(bucket.k, round_id=bucket.rounds[0])
        else:
            builder.submit(len(bucket), bucket.k, pad_to=bucket.shape_rounds,
                           rounds=bucket.rounds)

    def _dispatch(self, bucket: Bucket, builder) -> torch.Tensor:
        """Run one bucket in one engine dispatch; returns the (B, N)
        first-step losses, still on the device (padding rows NaN). With an
        adaptive downlink a last column holds each round's level, so one
        read brings back both."""
        if self.fed.cohort_chunk:
            return self._dispatch_chunked(bucket, builder)
        bb = builder.get()
        pad = bucket.shape_rounds - len(bucket)
        etas = np.asarray(list(bucket.etas) + [bucket.etas[-1]] * pad,
                          np.float32)
        self.params, firsts, _lasts, self.server_state = \
            self.engine.run_bucket(self.store.params, bb.batches, bb.weights,
                                   etas, bb.active, self.server_state)
        if self.runtime.downlink_level_ratios is not None:
            firsts = torch.cat([firsts, self.engine.last_downlink_levels
                                .to(firsts.dtype)[:, None]], dim=1)
        self.store.advance(len(bucket))     # params committed for B rounds
        return firsts

    def _dispatch_chunked(self, bucket: Bucket, builder) -> torch.Tensor:
        """One streaming round (the scheduler makes a chunked bucket one
        round): its ceil(U/C) slabs pulled off the builder and folded by
        the engine. Returns the (1, U) first-step losses."""
        n = min(self.fed.clients_per_round, self.data.num_clients)
        c = min(max(int(self.fed.cohort_chunk), 1), n)
        slabs = (builder.get() for _ in range(-(-n // c)))
        self.params, firsts, _lasts, self.server_state = \
            self.engine.run_round_chunked(self.store.params, slabs,
                                          bucket.etas[0], self.server_state)
        self.store.advance()
        return firsts

    def _run_pipelined(self, sched: RoundScheduler, builder,
                       verbose: bool) -> None:
        plan = sched.plan()
        pending: Optional[Tuple[Bucket, torch.Tensor]] = None
        nxt = next(plan, None)
        if nxt is not None:
            self._submit(builder, nxt)
        while nxt is not None:
            cur, nxt = nxt, next(plan, None)
            if nxt is not None:   # the scheduler announces the next bucket
                self._submit(builder, nxt)
            firsts = self._dispatch(cur, builder)
            if pending is not None:     # read bucket r-1 while r computes
                self._absorb(*pending)
                pending = None
            if cur.eval_after or cur.serve_after:
                # a serve bucket is absorbed at once: its tick must run
                # before the next dispatch commits
                self._absorb(cur, firsts)
                if cur.eval_after:
                    self._eval(cur.rounds[-1], verbose)
            else:
                pending = (cur, firsts)
        if pending is not None:
            self._absorb(*pending)

    def _run_feedback(self, sched: RoundScheduler, builder,
                      verbose: bool) -> None:
        # plan() is lazy: each step consults the controller, which has
        # absorbed the previous bucket's losses by then
        for bucket in sched.plan():
            self._submit(builder, bucket)
            self._absorb(bucket, self._dispatch(bucket, builder))
            if bucket.eval_after:
                self._eval(bucket.rounds[-1], verbose)

    # ------------------------------------------------------------------
    def _absorb(self, bucket: Bucket, firsts: torch.Tensor) -> None:
        """Read a finished bucket's losses (and adaptive downlink levels)
        back and account its rounds."""
        losses = firsts.cpu().numpy()             # device sync
        levels = None
        if self.runtime.downlink_level_ratios is not None:
            losses, levels = losses[:, :-1], losses[:, -1]
        h, st = self.history, self.store
        for i, r in enumerate(bucket.rounds):
            round_loss = float(np.mean(losses[i]))
            self.ctrl.observe_round_losses(round_loss)
            cost = self.runtime.round_cost(
                bucket.k,
                downlink_level=None if levels is None else int(levels[i]))
            st.wall += cost.wall_clock_s
            st.steps += cost.sgd_steps
            st.up_mbit += cost.uplink_mbit
            st.down_mbit += cost.downlink_mbit
            st.serve_queries += cost.serve_queries
            st.min_loss = min(st.min_loss, round_loss)
            h.rounds.append(r)
            h.k.append(bucket.k)
            h.eta.append(bucket.etas[i])
            h.wall_clock_s.append(st.wall)
            h.sgd_steps.append(st.steps)
            h.uplink_mbit.append(st.up_mbit)
            h.downlink_mbit.append(st.down_mbit)
            h.train_loss.append(round_loss)
            h.min_train_loss.append(st.min_loss)
            if (self.serving is not None and self.serve_every
                    and r % self.serve_every == 0):
                self.serving.tick(r, h)

    # ------------------------------------------------------------------
    # full-state checkpointing
    # ------------------------------------------------------------------
    def save_state(self, path: str,
                   extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint everything a bitwise continuation needs: the store's
        tree (params, server-optimizer state, codec state, per-client
        residual slots with their leading axis) and counters, the numpy
        sample stream, the straggler stream, the controller's feedback
        state and the history. ``extra_meta`` entries go into
        ``meta.json`` too (``FederatedExperiment.save`` embeds the spec).
        Restore with ``restore_state`` and continue with ``run(rounds,
        resume=True)``."""
        from repro_torch.checkpoint import save_checkpoint
        sd = self.store.state_dict()
        meta = {
            **(extra_meta or {}),
            "completed_rounds": self._completed_rounds,
            "history": self.history.as_dict(),
            "rng": self._np_rng.bit_generator.state,
            "runtime_rng": self.runtime._rng.bit_generator.state,
            "wall": self.store.wall,
            **sd["meta"],
            "ctrl": self.ctrl.state_dict(),
        }
        save_checkpoint(path, sd["tree"], meta=meta)

    def restore_state(self, path: str) -> None:
        """The inverse of ``save_state`` (of either package) on a trainer
        built with the same configuration: the live trainer's state gives
        every template, so tensors land on its device in its dtypes."""
        tree, meta = self.store.load_checkpoint_tree(path)
        self.store.restore_tree(tree)
        self._completed_rounds = int(meta["completed_rounds"])
        self.history = History.from_dict(meta["history"])
        h = self.history
        if len(h.downlink_mbit) < len(h.rounds):
            # a checkpoint from before downlink accounting: backfill the
            # series so the per-round lists stay aligned
            h.downlink_mbit = ([0.0] * (len(h.rounds) - len(h.downlink_mbit))
                               + h.downlink_mbit)
        self._np_rng.bit_generator.state = meta["rng"]
        if "runtime_rng" in meta:
            self.runtime._rng.bit_generator.state = meta["runtime_rng"]
        self.store.wall = float(meta["wall"])
        self.store.load_counters_meta(
            meta, default_version=self._completed_rounds)
        self.ctrl.load_state_dict(meta["ctrl"])

    def _eval(self, r: int, verbose: bool) -> None:
        metrics = self.eval_fn(self.params)
        err = metrics.get("error", 1.0 - metrics.get("acc", 0.0))
        self.ctrl.observe_validation(err)
        st = self.store
        st.max_acc = max(st.max_acc, metrics.get("acc", 0.0))
        h = self.history
        h.val_rounds.append(r)
        h.val_error.append(err)
        h.max_val_acc.append(st.max_acc)
        if verbose:
            print(f"round {r:5d} K={h.k[-1]:3d} eta={h.eta[-1]:.4f} "
                  f"loss={h.train_loss[-1]:.4f} val_err={err:.4f} "
                  f"W={st.wall:.1f}s steps={st.steps}")


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def make_eval_fn(loss_fn: LossFn, data: FederatedData, batch_size: int = 128,
                 device: DeviceLike = None):
    """Validation accuracy/error over the global validation split, with
    per-batch means weighted by batch size (the ragged tail batch counts
    exactly its share). A loss without an ``acc`` metric (the LMs') counts
    accuracy 0, as ``repro.core.engine.trainer.make_eval_fn`` (:503) does.
    ``device``: where the batches go (default ``cuda``)."""
    dev = resolve_device(device)
    batches = pipeline.val_batches(data, batch_size)

    def eval_fn(params) -> Dict[str, float]:
        loss_sum = acc_sum = 0.0
        n_tot = 0
        with torch.no_grad():
            for b in batches:
                n = len(b["y"])
                l, metrics = loss_fn(params, {k: torch.as_tensor(v, device=dev)
                                              for k, v in b.items()})
                loss_sum += float(l) * n
                acc_sum += float(metrics.get("acc", 0.0)) * n
                n_tot += n
        acc = acc_sum / max(n_tot, 1)
        return {"loss": loss_sum / max(n_tot, 1), "acc": acc,
                "error": 1.0 - acc}

    return eval_fn
