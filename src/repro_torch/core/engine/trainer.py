"""FedAvgTrainer: Algorithm 1, driven round by round, on one device or,
with a ``MeshBackend``, with the cohort's clients spread over the ranks of
a mesh (one trainer a rank; every rank keeps the same History).

ClientSampler (who runs, with what weights) -> RoundScheduler (K-bucket
plan) -> BatchPrefetcher (host tensors for the next round, built and
copied to the device on a background thread) -> RoundEngine (the rounds of
a bucket) -> DecayController feedback. A sampler with a ``stateful_cohort``
(``fixed_cohort``) gives a codec with error feedback one residual slot a
client (``Transport.with_ef_slots``).

Synchronisation policy, as in ``repro.core.engine.trainer``:
  * loss-free schedules (fixed/dsgd/rounds/cosine x fixed/rounds) never
    block mid-plan: bucket r's losses are read back only after bucket r+1
    has been dispatched;
  * error/step schedules sync at every bucket boundary.

Difference from the reference: the builder is asked for one round at a
time (``n_rounds=1``), and each bucket runs as one engine dispatch per
round. The sample stream is the same (padding rounds draw nothing), and a
CIFAR100 round at paper width is a 491.5 MB batch, which the reference's
8-round buckets would multiply. The trainer owns its state (params, server
state, counters); the reference's ``GlobalModelStore`` waits for
checkpointing.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.engine.aggregators import LINEAR_AGGREGATORS
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
    serve_rounds: List[int] = field(default_factory=list)     # ServingLoop.tick
    serve_tokens_per_sec: List[float] = field(default_factory=list)
    serve_swap_us: List[float] = field(default_factory=list)  # snapshot swap
    serve_staleness: List[int] = field(default_factory=list)  # versions behind


def _refuse_unported(fed: FedConfig) -> None:
    """Raise on configuration this slice of the port does not implement,
    naming the field, rather than running something else."""
    unported = [("cohort_chunk", bool(fed.cohort_chunk)),
                ("aggregation", fed.aggregation != "sync")]
    for name, bad in unported:
        if bad:
            raise ValueError(f"fed.{name}={getattr(fed, name)!r} is not "
                             f"ported yet")


class FedAvgTrainer:
    def __init__(self, loss_fn: LossFn, init_params: PyTree,
                 data: FederatedData, fed: FedConfig,
                 runtime: RuntimeModel,
                 eval_fn: Optional[Callable[[PyTree], Dict[str, float]]] = None,
                 *, device: DeviceLike = None, backend=None):
        """``device``: where the rounds run (default ``cuda``, which raises
        without a card); ``init_params`` are copied there. ``backend``: an
        ``engine.backends.ExecutionBackend`` (default ``LocalBackend``);
        with a ``MeshBackend`` every rank runs this trainer on the same
        seed and ``init_params``, and it brings its own device."""
        _refuse_unported(fed)
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
                                  backend=backend, device=device)
        self.device = self.engine.device
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
        self._wall = 0.0
        self._steps = 0
        self._up_mbit = 0.0
        self._down_mbit = 0.0
        self._min_loss = float("inf")
        self._max_acc = 0.0

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
            verbose: bool = False) -> History:
        """Run rounds 1..``rounds`` of the schedule. A repeated call replays
        the schedule from round 1 and continues the sample stream."""
        rounds = rounds if rounds is not None else self.fed.rounds
        sched = RoundScheduler(
            self.ctrl, self.fed, total_rounds=rounds,
            eval_every=eval_every if self.eval_fn is not None else None)
        builder = pipeline.make_builder(
            self.data, self.fed.clients_per_round, self.fed.batch_size,
            self._np_rng,
            background=self.fed.prefetch and sched.loss_free,
            place_fn=self.engine.place_bucket,
            sampler=self.sampler)
        try:
            if sched.loss_free:
                self._run_pipelined(sched, builder, verbose)
            else:
                self._run_feedback(sched, builder, verbose)
        finally:
            builder.close()
        return self.history

    # ------------------------------------------------------------------
    @staticmethod
    def _submit(builder, bucket: Bucket) -> None:
        """Announce a bucket to the builder, one round per request."""
        for r in bucket.rounds:
            builder.submit(1, bucket.k, pad_to=1, rounds=[r])

    def _dispatch(self, bucket: Bucket, builder) -> torch.Tensor:
        """Run one bucket's rounds; returns the (B, N) first-step losses,
        still on the device. With an adaptive downlink a last column holds
        each round's level, so one read brings back both."""
        rows = []
        per_level = self.runtime.downlink_level_ratios is not None
        for eta in bucket.etas:
            bb = builder.get()                  # one round: B = 1
            self.params, f, _lasts, self.server_state = \
                self.engine.run_bucket(
                    self.params, {k: v[0] for k, v in bb.batches.items()},
                    bb.weights[0], eta, self.server_state)
            if per_level:
                f = torch.cat([f, self.engine.last_downlink_levels
                               .to(f.dtype).reshape(1)])
            rows.append(f)
        return torch.stack(rows)

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
            if cur.eval_after:
                self._absorb(cur, firsts)
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
        h = self.history
        for i, r in enumerate(bucket.rounds):
            round_loss = float(np.mean(losses[i]))
            self.ctrl.observe_round_losses(round_loss)
            cost = self.runtime.round_cost(
                bucket.k,
                downlink_level=None if levels is None else int(levels[i]))
            self._wall += cost.wall_clock_s
            self._steps += cost.sgd_steps
            self._up_mbit += cost.uplink_mbit
            self._down_mbit += cost.downlink_mbit
            self._min_loss = min(self._min_loss, round_loss)
            h.rounds.append(r)
            h.k.append(bucket.k)
            h.eta.append(bucket.etas[i])
            h.wall_clock_s.append(self._wall)
            h.sgd_steps.append(self._steps)
            h.uplink_mbit.append(self._up_mbit)
            h.downlink_mbit.append(self._down_mbit)
            h.train_loss.append(round_loss)
            h.min_train_loss.append(self._min_loss)

    def _eval(self, r: int, verbose: bool) -> None:
        metrics = self.eval_fn(self.params)
        err = metrics.get("error", 1.0 - metrics.get("acc", 0.0))
        self.ctrl.observe_validation(err)
        self._max_acc = max(self._max_acc, metrics.get("acc", 0.0))
        h = self.history
        h.val_rounds.append(r)
        h.val_error.append(err)
        h.max_val_acc.append(self._max_acc)
        if verbose:
            print(f"round {r:5d} K={h.k[-1]:3d} eta={h.eta[-1]:.4f} "
                  f"loss={h.train_loss[-1]:.4f} val_err={err:.4f} "
                  f"W={self._wall:.1f}s steps={self._steps}")


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
