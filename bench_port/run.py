"""The benchmark of ``nnaudio_tpu_torch`` on one NVIDIA H100.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(imports, the kernels' build on a first run, the transform, a seeded pool of
inputs made on the device, a warm-up of every shape), then a closed loop for
``--seconds``; with ``--trace 1`` a short stretch of the same loop under
``torch.profiler`` follows. Then the program's state is freed, the answers
that the window kept are checked against the plain reference, and the last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared beside its limit, which are also
the last lines of standard error. Without a card, or with fewer cards than
the cell asks for, it exits 2 and prints no result; if JAX or the JAX
package is loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

#: seconds of the traced stretch that follows the window in a ``--trace 1`` run
TRACE_SECONDS = 0.5


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _number(v):
    """A finite float as it is, anything else as its text (JSON has no NaN)."""
    v = float(v)
    return v if v - v == 0 else str(v)


def main(argv=None, device=None, root: Path = ROOT, base: Path = harness.BASE,
         start: float | None = None) -> int:
    """One run. ``device`` set (a test's ``'cpu'``) skips the look for cards
    and the traced stretch's device reading."""
    args = parse(argv)
    start = START if start is None else start
    cell = harness.find_cell(harness.load_json(root / "BENCHMARK.json"), args.workload,
                             root, base)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"

    loop = harness.loop_class(cell)(cell.config, cell.traffic, args.seed, device,
                                    harness.reference(cell))
    loop.setup()
    setup_s = time.perf_counter() - start
    window = loop.run(args.seconds)
    trace = None
    if args.trace:
        from bench_port import trace as tracing

        trace = tracing.traced(loop.run, TRACE_SECONDS)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    loop.release()

    readings = loop.readings()
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    missing = set(cell.limits) - set(readings)
    correct = not missing and all(c["value"] <= c["limit"] for c in checks.values())

    ctx = harness.Context(cell=cell, window=window, trace=trace, work=harness.work(cell))
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = setup_s if m["name"] == "setup_s" else harness.reader(m["name"], base)(ctx)
        if value is None:
            if not args.trace:
                print(f"end-to-end metric {m['name']} read nothing", file=sys.stderr)
                return 1
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3

    info = {"platform": "gpu" if on_card else torch.device(device).type,
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": peak}
    if on_card:
        info["power"] = power_limit()
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    result = {"correct": correct, "attempted": window["attempted"], "failed": 0,
              "metrics": metrics, "device": info}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {n: _number(v) for n, v in c.items()} for k, c in checks.items()}
    for k in sorted(missing):
        print(f"check {k}: no reading", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
