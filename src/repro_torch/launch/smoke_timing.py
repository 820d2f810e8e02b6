"""Wall seconds of ``chip_smoke.py`` for two or more checkouts, in turns on
one card.

Unpack the other checkout into a directory that ``.gitignore`` lists
(``git archive <commit> | tar -x -C build/parent``), then run, from the
root of this checkout::

    python3 src/repro_torch/launch/smoke_timing.py <tag> \
        parent=build/parent change=.

Each ``label=path`` runs ``python3 chip_smoke.py`` from ``path``, in the
order given (alternate the order between calls: a call's second run is
often the slower). Its output goes to ``chiprun_out/<tag>_<label>.log``.
For each run it prints one JSON line: the exit code, the wall seconds, the
seconds of every phase and part line that carries ``"s"`` (phase
``kernel``'s rows excepted, where ``"s"`` counts top-k entries; summed by
phase, and by part or ``what`` where a line is not a phase's summary), and
phase ``tensor_parallel``'s parts with their ms a step; then the log's
last 600 bytes. It imports no part of the port.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

TP_KEYS = ("part", "arch", "s", "prefill_ms", "ms_per_token", "decode_s",
           "encdec_s", "within_budget", "decode_within_budget",
           "encdec_within_budget", "strategy", "run", "ms", "train_s",
           "train_within_budget")


def digest(log: Path) -> dict:
    """Phase seconds and phase ``tensor_parallel``'s parts of one log."""
    phases, tp = {}, []
    for line in log.read_text().splitlines():
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if d.get("phase") == "tensor_parallel":
            tp.append({k: d[k] for k in TP_KEYS if k in d})
        # a phase-kernel row's "s" is its top-k count, not seconds
        if "s" in d and "phase" in d and d["phase"] != "kernel":
            key = d["phase"] + ("" if d.get("summary") else
                                "." + str(d.get("part", d.get("what", ""))))
            phases[key] = round(phases.get(key, 0) + d["s"], 1)
    return {"phases_s": phases, "tensor_parallel": tp}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or any("=" not in a for a in argv[1:]):
        print(__doc__, file=sys.stderr)
        return 2
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    for spec in argv[1:]:
        label, path = spec.split("=", 1)
        log = out / f"{argv[0]}_{label}.log"
        t = time.time()
        with open(log, "w") as f:
            rc = subprocess.call([sys.executable, "chip_smoke.py"], cwd=path,
                                 stdout=f, stderr=subprocess.STDOUT)
        print(json.dumps({"run": label, "rc": rc,
                          "wall_s": round(time.time() - t, 1),
                          **digest(log)}), flush=True)
        print(log.read_text()[-600:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
