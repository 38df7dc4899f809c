"""Readings for the limits of a cell's check, in one process on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 12 --first-seed <n>
        [--seconds 2] [--faults 3]

For each seed: the cell's set-up, a short window at the cell's own load and
sizes, then the check's numbers of the program and of the control (the
reference in TF32, put in the program's place) on the same inputs; for the
first ``--faults`` seeds also the numbers with each fault of ``faults.py``
planted in the port. One JSON line per reading, then a summary line: the
largest reading of the program (the lower reading), the smallest of the
control and of each fault (the upper ones). The benchmark's runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import faults, harness  # noqa: E402


def readings(cell, seed, seconds, device, control=False):
    """The program's check numbers after a short window, and the control's
    on the same inputs when ``control``."""
    loop = harness.loop_class(cell)(cell.config, cell.traffic, seed, device,
                                    harness.reference(cell))
    loop.setup()
    loop.run(seconds)
    loop.release()
    return loop.readings(), (loop.readings(control=True) if control else None)


def main(argv=None, device="cuda:0", root: Path = ROOT, base: Path = harness.BASE) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=(1 << 31) + 1000)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_json(root / "BENCHMARK.json"), args.workload,
                             root, base)
    entry_cfg = cell.config["entries"][cell.loop]
    seen: dict = {}

    def report(kind, seed, values):
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, **values}), flush=True)
        for k, v in values.items():
            seen.setdefault(kind, {}).setdefault(k, []).append(v)

    for i in range(args.seeds):
        seed = args.first_seed + i
        program, control = readings(cell, seed, args.seconds, device, control=True)
        report("program", seed, program)
        report("control", seed, control)
        if i < args.faults:
            for fault in faults.names(cell.loop):
                with faults.planted(fault, cell.loop, entry_cfg):
                    report(f"fault:{fault}", seed, readings(cell, seed, args.seconds, device)[0])
    summary = {kind: {k: (max(v) if kind == "program" else min(v)) for k, v in vals.items()}
               for kind, vals in seen.items()}
    print(json.dumps({"cell": cell.name, "summary": summary, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
