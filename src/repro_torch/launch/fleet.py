"""Fleet runner: one spec, an override grid, one device
(``repro.launch.fleet``).

Fans a base ``ExperimentSpec`` over a dotted-path sweep grid and runs every
point through two fleet-wide mechanisms:

  * **shared bucket programs**: every point looks its buckets up in one
    ``ExecutableRegistry``; points whose program fingerprint
    (``sweep.spec_program_key``) and bucket input signatures coincide
    build a program once and dispatch it N times. With ``--share-k-grid``
    the runner pins one ``fed.k_grid0`` anchor (the grid's largest
    ``fed.k0``), so a ``fed.k0`` sweep collapses onto shared bucket
    signatures.
  * **packing**: points run concurrently on a thread pool, each on its own
    backend slice (``ExecutionBackend.fleet_slices``: on the card, fresh
    ``LocalBackend``s that each own a CUDA stream, so the points' rounds
    overlap on the card), each with its own prefetch thread. A mesh spec's
    slices are ``MeshBackend``s on disjoint sub-meshes
    (``backends.mesh.carve_submeshes``), cycled over the points: a rank
    runs only the points of the slice that holds it, one after another
    in that slice's worker (two threads sharing a process group would
    order its collectives differently on each rank), while slices on
    disjoint groups run at once; then every
    point's result is gathered to every rank, so each holds the whole
    leaderboard.

The result is one leaderboard and CSV (``CSV_FIELDS``): final and min
loss, rounds, wall seconds and rounds a second, up- and downlink Mbit,
``peak_mb``, and the exact compile, shared and dispatch counts of each
point. ``peak_mb`` is ``core.mem.trainer_peak_mb`` at the point's end: the
CUDA allocator's high-water mark since the previous reading (0 on the
CPU). A serial fleet's is the point's own. The allocator is process-wide,
so under packing it is the device's peak over the concurrent points.

    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu \\
        --sweep fed.k0=2,4,8 transport.name=none,int8 --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --spec run.json \\
        --sweep fed.k0=2,4,8 --share-k-grid

``--compile-cache`` is accepted and reports the cache unavailable: the
port builds no compiled artefact to keep between invocations.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.api import ExperimentSpec, build
from repro_torch.api.sweep import SweepPoint, expand_sweep, spec_program_key
from repro_torch.core.engine.round import ExecutableRegistry
from repro_torch.core.mem import trainer_peak_mb
from repro_torch.device import DeviceLike, resolve_device

CSV_FIELDS = ("label", "overrides", "final_loss", "min_loss", "rounds",
              "wall_s", "rounds_per_sec", "uplink_mbit", "downlink_mbit",
              "peak_mb", "compiles", "shared", "dispatches")


def enable_persistent_cache(path: str) -> bool:
    """The reference wires JAX's persistent compilation cache here. The
    port compiles no program (a bucket program runs eagerly), so there is
    nothing to keep across invocations: False, the reference's answer on a
    runtime without a cache, and the fleet runs as it would anyway."""
    del path
    return False


@dataclass(frozen=True)
class PointResult:
    """One sweep point's row."""
    label: str
    overrides: Tuple[str, ...]
    spec: ExperimentSpec
    final_loss: float
    min_loss: float
    rounds: int
    wall_s: float
    rounds_per_sec: float
    uplink_mbit: float
    downlink_mbit: float
    peak_mb: float
    compile_count: int
    shared_count: int
    dispatch_count: int

    def as_row(self) -> dict:
        return {"label": self.label, "overrides": " ".join(self.overrides),
                "final_loss": f"{self.final_loss:.6f}",
                "min_loss": f"{self.min_loss:.6f}",
                "rounds": self.rounds, "wall_s": f"{self.wall_s:.3f}",
                "rounds_per_sec": f"{self.rounds_per_sec:.3f}",
                "uplink_mbit": f"{self.uplink_mbit:.2f}",
                "downlink_mbit": f"{self.downlink_mbit:.2f}",
                "peak_mb": f"{self.peak_mb:.2f}",
                "compiles": self.compile_count,
                "shared": self.shared_count,
                "dispatches": self.dispatch_count}


@dataclass
class FleetResult:
    points: List[PointResult]
    wall_s: float              # the whole fleet's wall clock
    packed: bool
    compile_count: int         # distinct programs built fleet-wide
    shared_count: int          # the points' registry adoptions, summed
    dispatch_count: int

    def leaderboard(self) -> str:
        """A text table, best final loss first."""
        rows = sorted(self.points, key=lambda p: p.final_loss)
        head = (f"{'label':<28} {'loss':>9} {'min':>9} {'r/s':>7} "
                f"{'up':>8} {'down':>8} {'peakMB':>7} {'cmp':>4} {'shr':>4}")
        lines = [head, "-" * len(head)]
        for p in rows:
            lines.append(
                f"{p.label:<28} {p.final_loss:>9.4f} {p.min_loss:>9.4f} "
                f"{p.rounds_per_sec:>7.2f} {p.uplink_mbit:>8.1f} "
                f"{p.downlink_mbit:>8.1f} {p.peak_mb:>7.1f} "
                f"{p.compile_count:>4d} {p.shared_count:>4d}")
        lines.append(f"fleet: {len(self.points)} point(s) in "
                     f"{self.wall_s:.2f}s "
                     f"({'packed' if self.packed else 'serial'}), "
                     f"{self.compile_count} compile(s), "
                     f"{self.shared_count} shared, "
                     f"{self.dispatch_count} dispatch(es)")
        return "\n".join(lines)

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
            w.writeheader()
            for p in sorted(self.points, key=lambda p: p.final_loss):
                w.writerow(p.as_row())


def share_k_grid(points: Sequence[SweepPoint]) -> List[SweepPoint]:
    """Pin one ``quantize_k`` anchor, the grid's largest ``fed.k0``, on
    every point (``fed.k_quantize`` on), so points that differ only in
    ``fed.k0`` snap to the same K values and share bucket programs."""
    anchor = max(p.spec.fed.k0 for p in points)
    return [SweepPoint(label=p.label, overrides=p.overrides,
                       spec=p.spec.with_overrides(
                           "fed.k_quantize=true",
                           f"fed.k_grid0={anchor}").validate())
            for p in points]


def _slice_ranks(backend) -> Optional[Tuple[int, ...]]:
    """The global ranks of a mesh backend's mesh, in mesh order (None for
    a single-device backend)."""
    mesh = getattr(backend, "mesh", None)
    if mesh is None:
        return None
    return tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())


def _program_key_for(spec: ExperimentSpec, backend) -> Tuple:
    """A packed point's registry program key: the spec's fingerprint, plus
    a mesh slice's ranks (the reference adds the slice's device ids,
    ``fleet.py:137-146``), so points on different sub-meshes never share
    an entry."""
    key = spec_program_key(spec)
    ranks = _slice_ranks(backend)
    if ranks is not None:
        key = key + (("ranks", ranks),)
    return key


def _run_point(point: SweepPoint, backend, registry: ExecutableRegistry,
               rounds: Optional[int], verbose: bool,
               device: DeviceLike) -> PointResult:
    """Build and run one point; with a slice backend, everything it issues
    on the card (its build included) goes on the slice's stream. The
    program key is ``_program_key_for``'s."""
    program_key = _program_key_for(point.spec, backend) \
        if registry is not None else None
    ctx = (backend.stream_context() if backend is not None
           else contextlib.nullcontext())
    with ctx:
        exp = build(point.spec, backend=backend, registry=registry,
                    program_key=program_key, device=device)
        tr = exp.trainer
        t0 = time.perf_counter()
        h = exp.run(rounds, verbose=False)
        if tr.device.type == "cuda":
            torch.cuda.current_stream(tr.device).synchronize()
        wall = time.perf_counter() - t0
    n = len(h.rounds)
    res = PointResult(
        label=point.label, overrides=point.overrides, spec=point.spec,
        final_loss=float(h.train_loss[-1]) if h.train_loss else float("nan"),
        min_loss=float(min(h.min_train_loss)) if h.min_train_loss
        else float("nan"),
        rounds=n, wall_s=wall,
        rounds_per_sec=n / wall if wall > 0 else 0.0,
        uplink_mbit=float(h.uplink_mbit[-1]) if h.uplink_mbit else 0.0,
        downlink_mbit=float(h.downlink_mbit[-1]) if h.downlink_mbit else 0.0,
        peak_mb=trainer_peak_mb(tr),
        compile_count=tr.compile_count, shared_count=tr.shared_count,
        dispatch_count=tr.dispatch_count)
    if verbose:
        print(f"[fleet] {res.label}: loss {res.final_loss:.4f} in "
              f"{res.wall_s:.2f}s ({res.compile_count} compiled, "
              f"{res.shared_count} shared)")
    return res


def _slices_for(points: Sequence[SweepPoint], packed: bool,
                device: DeviceLike) -> List[Any]:
    """One backend a point. A packed fleet whose points share one backend
    section takes slices of ONE parent backend; mixed-backend grids and
    serial fleets let ``build`` make each point's backend from its own
    spec (None)."""
    if not packed:
        return [None] * len(points)
    from repro_torch.api.experiment import _make_backend
    sections = {p.spec.backend for p in points}
    if len(sections) != 1:
        return [None] * len(points)
    parent = _make_backend(points[0].spec, resolve_device(device))
    return parent.fleet_slices(len(points))


def _lanes(backends: Sequence[Any]) -> Dict[Any, List[int]]:
    """The point indices that run one after another, by lane, for the
    lanes this rank runs: a mesh slice's points share its lane (keyed by
    its ranks), held only by the slice's ranks; any other point is a lane
    of its own."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    lanes: Dict[Any, List[int]] = {}
    for i, b in enumerate(backends):
        ranks = _slice_ranks(b)
        if ranks is None:
            lanes[("point", i)] = [i]
        elif rank in ranks:
            lanes.setdefault(ranks, []).append(i)
    return lanes


def _gather_points(mine: Dict[int, PointResult], n: int
                   ) -> List[PointResult]:
    """Every point's result on every rank: each rank's own points
    all-gathered, a point taken from the lowest rank that ran it."""
    every: List[Optional[Dict[int, PointResult]]] = \
        [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out: Dict[int, PointResult] = {}
    for part in every:
        for i, r in part.items():
            out.setdefault(i, r)
    return [out[i] for i in range(n)]


def run_fleet(base: Optional[ExperimentSpec] = None,
              sweep: Sequence[str] = (), *,
              points: Optional[Sequence[SweepPoint]] = None,
              packed: bool = True, workers: Optional[int] = None,
              rounds: Optional[int] = None,
              registry: Optional[ExecutableRegistry] = None,
              share_grid: bool = False, verbose: bool = False,
              device: DeviceLike = None) -> FleetResult:
    """Run a sweep as one fleet.

    ``base`` + ``sweep`` expand through ``expand_sweep`` (or pass
    pre-expanded ``points``). ``packed=True`` runs the points concurrently
    on backend slices; False runs them one after another (sharing the
    registry all the same). ``share_grid`` pins a fleet-wide
    ``fed.k_grid0`` anchor. ``registry`` defaults to a fresh one.
    ``device``: where the points run (default ``cuda``). A packed mesh
    fleet is collective: every rank of the world calls it alike, runs its
    slice's points, and gets every point's result; its counts add up the
    points' own."""
    if points is None:
        points = expand_sweep(*sweep, base=base)
    points = list(points)
    if not points:
        raise ValueError("run_fleet: empty sweep grid")
    if share_grid:
        points = share_k_grid(points)
    registry = registry if registry is not None else ExecutableRegistry()
    backends = _slices_for(points, packed, device)
    dev = resolve_device(device)
    if dev.type == "cuda":                  # each point's peak_mb reading
        torch.cuda.reset_peak_memory_stats(dev)     # starts from here
    t0 = time.perf_counter()

    def run_lane(idx):
        return {i: _run_point(points[i], backends[i], registry, rounds,
                              verbose, device) for i in idx}

    lanes = _lanes(backends)
    mine: Dict[int, PointResult] = {}
    if packed and len(lanes) > 1:
        with ThreadPoolExecutor(max_workers=workers or len(lanes)) as pool:
            for f in [pool.submit(run_lane, idx) for idx in lanes.values()]:
                mine.update(f.result())
    else:
        for idx in lanes.values():
            mine.update(run_lane(idx))
    gathered = len(mine) < len(points)    # slices of other ranks ran some
    results = (_gather_points(mine, len(points)) if gathered
               else [mine[i] for i in range(len(points))])
    wall = time.perf_counter() - t0
    return FleetResult(
        points=results, wall_s=wall, packed=packed,
        compile_count=(sum(r.compile_count for r in results) if gathered
                       else registry.compile_count),
        shared_count=sum(r.shared_count for r in results),
        dispatch_count=sum(r.dispatch_count for r in results))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="base ExperimentSpec (default: ExperimentSpec())")
    ap.add_argument("--set", action="append", default=[], metavar="PATH=V",
                    dest="overrides",
                    help="base-spec dotted-path override, repeatable")
    ap.add_argument("--sweep", nargs="+", default=[], metavar="PATH=V1,V2",
                    help="sweep axes, e.g. --sweep fed.k0=2,4,8 "
                         "transport.name=int8,topk (cross product)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds a point (default: each spec's "
                         "fed.rounds)")
    ap.add_argument("--serial", action="store_true",
                    help="run points one after another instead of packed "
                         "(still sharing the registry)")
    ap.add_argument("--workers", type=int, default=None,
                    help="most packed points at once (default: all)")
    ap.add_argument("--share-k-grid", action="store_true",
                    help="pin fed.k_grid0 to the grid's largest fed.k0 so "
                         "k0 sweep points share bucket programs")
    ap.add_argument("--csv", default=None, metavar="FILE.csv",
                    help="write the leaderboard CSV here")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="the reference's persistent compilation cache "
                         "(unavailable: the port compiles nothing)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> FleetResult:
    args = make_parser().parse_args(argv)
    if args.compile_cache:
        ok = enable_persistent_cache(args.compile_cache)
        print(f"[fleet] persistent compile cache: "
              f"{'on, ' + args.compile_cache if ok else 'unavailable'}")
    base = ExperimentSpec.load(args.spec) if args.spec else ExperimentSpec()
    if args.overrides:
        base = base.with_overrides(*args.overrides)
    if not args.sweep:
        raise SystemExit("fleet: --sweep is required (e.g. --sweep "
                         "fed.k0=2,4,8)")
    result = run_fleet(base, args.sweep, packed=not args.serial,
                       workers=args.workers, rounds=args.rounds,
                       share_grid=args.share_k_grid,
                       verbose=not args.quiet, device=args.device)
    print(result.leaderboard())
    if args.csv:
        result.to_csv(args.csv)
        print(f"[fleet] csv -> {args.csv}")
    return result


if __name__ == "__main__":
    main()
