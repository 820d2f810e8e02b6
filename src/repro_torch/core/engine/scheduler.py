"""RoundScheduler — groups rounds into K-buckets for amortised execution.

A *bucket* is a run of consecutive rounds that (a) share one (quantized) K,
(b) fits the configured bucket length, and (c) does not cross an eval
boundary (eval needs host params, which only exist between buckets). Each
bucket executes as one jitted multi-round scan (`engine.round`).

Two planning modes (DESIGN.md §6.4):

* **loss-free** — both schedules are pure functions of the round index
  (K in {fixed, dsgd, rounds, cosine}, eta in {fixed, rounds}).  The whole
  plan is computed upfront, so the batch prefetcher can build bucket r+1
  while bucket r runs on device, and the trainer never syncs mid-bucket.
* **feedback** — error/step schedules need loss/validation signals, which
  are only observed at bucket boundaries.  Buckets are planned lazily, one
  at a time, with length ``fed.feedback_bucket_rounds`` (default 1, which
  reproduces the per-round feedback of the seed loop exactly; larger values
  trade schedule staleness for dispatch amortisation).

Executable-shape policy (bounds compiles to the K grid): each K gets
exactly ONE executable length — the full bucket length if any of its
segments is long enough to amortise it, else 1 (per-round dispatch, i.e.
exactly the seed loop's cost).  Short tails of long runs are padded with
masked-out rounds rather than given a second shape, so the engine's compile
cache holds at most one entry per distinct quantized K.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from repro_torch.configs.base import FedConfig
from repro_torch.core.schedules import DecayController

LOSS_FREE_K = ("fixed", "dsgd", "rounds", "cosine")
LOSS_FREE_ETA = ("fixed", "rounds")


@dataclass(frozen=True)
class Bucket:
    rounds: List[int]        # 1-based round indices executed (active)
    k: int                   # shared local-step count
    etas: List[float]        # per-round client learning rates
    shape_rounds: int        # executable leading dim (>= len(rounds))
    eval_after: bool         # trainer should eval at this bucket's end
    serve_after: bool = False  # serving tick at this bucket's end (§14)

    def __len__(self) -> int:
        return len(self.rounds)


def is_loss_free(fed: FedConfig) -> bool:
    return (fed.k_schedule in LOSS_FREE_K
            and fed.eta_schedule in LOSS_FREE_ETA)


class RoundScheduler:
    def __init__(self, ctrl: DecayController, fed: FedConfig, *,
                 total_rounds: int, eval_every: Optional[int] = None,
                 serve_every: Optional[int] = None, start_round: int = 1):
        """``eval_every`` of None means no eval_fn: no eval cut points.
        ``serve_every`` of None/0 means no serving loop: no serve cut
        points (the plan — and hence every executable shape — is untouched,
        keeping serve-off programs bit-for-bit).  With serving on, buckets
        additionally cut at ``serve_every`` multiples so the trainer can
        absorb + hot-swap immediately, bounding served-version staleness
        at one round (DESIGN.md §14).
        ``start_round`` > 1 resumes a checkpointed run mid-schedule: rounds
        [start_round, total_rounds] are planned with their *absolute*
        indices, so round-indexed K/eta schedules and eval cut points are
        identical to the uninterrupted run's."""
        self.ctrl = ctrl
        self.fed = fed
        self.total_rounds = total_rounds
        self.start_round = max(int(start_round), 1)
        self.eval_every = eval_every
        self.serve_every = serve_every or None
        self.loss_free = is_loss_free(fed)
        cap = max(fed.bucket_rounds if self.loss_free
                  else fed.feedback_bucket_rounds, 1)
        if eval_every is not None:
            cap = min(cap, max(eval_every, 1))
        if self.serve_every is not None:
            cap = min(cap, max(self.serve_every, 1))
        if getattr(fed, "cohort_chunk", None):
            # streaming cohorts (DESIGN.md §11) dispatch slab-by-slab within
            # a round — the multi-round bucket scan doesn't apply, so every
            # bucket is exactly one round
            cap = 1
        self.bucket_cap = cap

    # ------------------------------------------------------------------
    def _is_eval_round(self, r: int) -> bool:
        if self.eval_every is None:
            return False
        return r % self.eval_every == 0 or r == self.total_rounds

    def _is_serve_round(self, r: int) -> bool:
        return self.serve_every is not None and r % self.serve_every == 0

    def _cut_after(self, r: int) -> bool:
        """Must the bucket containing round r end at r?"""
        return (self._is_eval_round(r) or self._is_serve_round(r)
                or r == self.total_rounds)

    # ------------------------------------------------------------------
    def _segments(self) -> List[List[int]]:
        """Maximal constant-K stretches between cut points (loss-free)."""
        segs: List[List[int]] = []
        cur: List[int] = []
        k_prev = None
        for r in range(self.start_round, self.total_rounds + 1):
            k = self.ctrl.k_for_round(r)
            if cur and k != k_prev:
                segs.append(cur)
                cur = []
            cur.append(r)
            k_prev = k
            if self._cut_after(r):
                segs.append(cur)
                cur = []
        if cur:
            segs.append(cur)
        return segs

    def _best_shape(self, seg_lens: List[int]) -> int:
        """One executable length for a K, given its segment lengths: minimise
        computed rounds (padding) plus one round-equivalent per dispatch (the
        amortisation the bucket exists for), preferring longer shapes on
        ties.  E.g. segments of 10 with cap 8 pick 5 (zero padding), a lone
        2-round segment picks 2, and a 23-round run picks 8 (one padded
        tail) rather than degenerating to per-round dispatch."""
        def cost(s: int) -> tuple:
            computed = sum((l + s - 1) // s * s for l in seg_lens)
            dispatches = sum((l + s - 1) // s for l in seg_lens)
            return (computed + dispatches, -s)

        return min(range(1, self.bucket_cap + 1), key=cost)

    def _plan_loss_free(self) -> Iterator[Bucket]:
        segs = self._segments()
        seg_lens: Dict[int, List[int]] = {}
        for seg in segs:
            k = self.ctrl.k_for_round(seg[0])
            seg_lens.setdefault(k, []).append(len(seg))
        shape_for_k = {k: self._best_shape(lens)
                       for k, lens in seg_lens.items()}
        for seg in segs:
            k = self.ctrl.k_for_round(seg[0])
            shape = shape_for_k[k]
            for i in range(0, len(seg), shape):
                rounds = seg[i:i + shape]
                yield Bucket(rounds=rounds, k=k,
                             etas=[self.ctrl.eta_for_round(r) for r in rounds],
                             shape_rounds=shape,
                             eval_after=self._is_eval_round(rounds[-1]),
                             serve_after=self._is_serve_round(rounds[-1]))

    def _plan_feedback(self) -> Iterator[Bucket]:
        r = self.start_round
        while r <= self.total_rounds:
            k = self.ctrl.k_for_round(r)
            rounds, etas = [r], [self.ctrl.eta_for_round(r)]
            while (not self._cut_after(rounds[-1])
                   and len(rounds) < self.bucket_cap):
                nxt = rounds[-1] + 1
                # the controller state is frozen between observations, so
                # this only cuts on round-indexed K changes (e.g.
                # k_schedule='rounds' with eta_schedule='error')
                if self.ctrl.k_for_round(nxt) != k:
                    break
                rounds.append(nxt)
                etas.append(self.ctrl.eta_for_round(nxt))
            yield Bucket(rounds=rounds, k=k, etas=etas,
                         shape_rounds=self.bucket_cap,
                         eval_after=self._is_eval_round(rounds[-1]),
                         serve_after=self._is_serve_round(rounds[-1]))
            r = rounds[-1] + 1

    def plan(self) -> Iterator[Bucket]:
        """Yield buckets in execution order.

        Feedback-mode buckets are planned lazily: each ``next()`` consults
        the controller, so the trainer must feed observations (losses /
        validation) for bucket i before requesting bucket i+1.
        """
        if self.loss_free:
            return self._plan_loss_free()
        return self._plan_feedback()
