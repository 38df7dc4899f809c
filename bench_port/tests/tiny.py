"""A copy of the benchmark's tree with the real configurations, limits and
readers and tiny traffic under the real mixes' names, for CPU runs.

The three first mixes' tiny sizes are :data:`TINY_TRAFFIC`; any other mix
brings its own, the ``"tiny"`` object of its traffic file, which is the
whole mix for CPU runs."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_TRAFFIC = {
    "serve_b32x10s": {"loop": "offline", "batch": 2, "clip_seconds": 1.0, "pool": 2, "sample": 2},
    "train_b32x10s": {"loop": "train", "batch": 4, "clip_seconds": 0.5, "pool": 3},
    "stream_32x2048": {"loop": "stream", "streams": 2, "chunk": 2048, "stream_seconds": 0.5,
                       "pool": 2, "sample": 2},
}


def tiny_traffic() -> dict:
    """Every mix's tiny traffic by the mix's name."""
    mixes = dict(TINY_TRAFFIC)
    for path in sorted((BENCH / "traffic").glob("*.json")):
        if path.stem not in mixes:
            mixes[path.stem] = json.loads(path.read_text())["tiny"]
    return mixes


def window(loop: str) -> str:
    """``--seconds`` of a CPU run of a cell of ``loop``: a stream's check
    compares only whole streams, so its window holds several even on a
    loaded machine (a tiny stream is 5 steps of some 40 ms under four test
    workers)."""
    return "3" if loop == "stream" else "0.3"


def tree(tmp: Path) -> tuple[Path, Path]:
    """``(root, base)``: a checkout root holding ``BENCHMARK.json`` and the
    benchmark's folder ``base`` with tiny traffic."""
    base = tmp / "bench"
    for part in ("configs", "limits", "metrics"):
        shutil.copytree(BENCH / part, base / part)
    (base / "traffic").mkdir()
    for name, mix in tiny_traffic().items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        c["file"] = f"bench/configs/{Path(c['file']).name}"
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, base


def cells() -> list[str]:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
