"""The harness on the CPU: finding a cell's parts by name, whole runs at
tiny sizes, the faults and the control coming out not correct, the run
without a card, and the imports that no file may make."""
import ast
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from bench_port import calibrate, faults, harness, run
from bench_port.tests import tiny

SEED = (1 << 31) + 12345


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: test workers that each spread the tiny
    cells' small operators over every core slow one another down by tens of
    times (a tiny stream then completes no whole stream in its window)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tree(tmp_path):
    return tiny.tree(tmp_path)


def loop_of(cell):
    return tiny.tiny_traffic()[cell.split(".")[1]]["loop"]


def run_cell(tree, cell, capsys):
    root, base = tree
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   tiny.window(loop_of(cell))], device="cpu", root=root, base=base)
    out, err = capsys.readouterr()
    return rc, out, err


def test_discovery_finds_a_config_a_mix_and_a_metric_by_name(tmp_path):
    base = tmp_path / "bench"
    (base / "configs").mkdir(parents=True)
    shutil.copy(tiny.BENCH / "configs" / "mel128_22k.json", base / "configs" / "mel128_22k.json")
    (base / "traffic").mkdir()
    (base / "traffic" / "new_mix.json").write_text(json.dumps(tiny.TINY_TRAFFIC["serve_b32x10s"]))
    (base / "limits").mkdir()
    (base / "limits" / "mel128_22k.new_mix.json").write_text('{"rel_l2": 1e-4}')
    (base / "metrics").mkdir()
    (base / "metrics" / "probe.count.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = {
        "configs": [{"name": "mel128_22k", "file": "bench/configs/mel128_22k.json"}],
        "workloads": [{"name": "mel128_22k.new_mix", "config": "mel128_22k",
                       "traffic": "new_mix", "chips": 1}],
        "end_to_end": [{"name": "audio_s_per_s", "unit": "audio-s/s",
                        "workloads": ["mel128_22k.new_mix"]},
                       {"name": "other_rate", "unit": "1/s", "workloads": ["elsewhere"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "probe.count", "unit": "1", "moves": "audio_s_per_s"},
                      {"name": "unmoved", "unit": "1", "moves": "other_rate"}],
    }
    cell = harness.find_cell(bench, "mel128_22k.new_mix", tmp_path, base)
    assert cell.loop == "offline" and cell.traffic["batch"] == 2
    assert cell.config["settings"]["n_mels"] == 128
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["probe.count"]
    assert harness.reader("probe.count", base)(None) == 42.0
    assert harness.loop_class(cell).__module__ == "bench_port.loops.offline"
    assert harness.reference(cell).__name__ == "bench_port.reference.mel128_22k"
    with pytest.raises(KeyError):
        harness.find_cell(bench, "absent", tmp_path, base)


def test_every_metric_has_a_reader_and_every_cell_its_parts():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(harness.reader(m["name"]))
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"], tiny.ROOT)
        assert harness.loop_class(cell) and harness.reference(cell) and harness.work(cell)
        assert cell.per_layer and len(cell.end_to_end) >= 2


@pytest.mark.parametrize("cell", tiny.cells())
def test_a_whole_run_is_correct_and_ends_with_its_checks(tree, cell, capsys):
    rc, out, err = run_cell(tree, cell, capsys)
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    limits = json.loads((tree[1] / "limits" / f"{cell}.json").read_text())
    assert set(result["checks"]) == set(limits)
    assert err.strip().splitlines()[-len(limits):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in result["checks"].items()]
    names = {m for m in result["metrics"]}
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("cell,fault", [(c, f) for c in tiny.cells()
                                        for f in faults.names(loop_of(c))])
def test_a_planted_fault_comes_out_not_correct(tree, cell, fault, capsys):
    root, base = tree
    found = harness.find_cell(harness.load_json(root / "BENCHMARK.json"), cell, root, base)
    with faults.planted(fault, found.loop, found.config["entries"][found.loop]):
        rc, out, err = run_cell(tree, cell, capsys)
    assert rc == 0, err
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False


@pytest.mark.parametrize("cell", tiny.cells())
def test_the_control_fails_a_limit_the_program_holds(tree, cell, capsys):
    root, base = tree
    calibrate.main(["--workload", cell, "--seeds", "1", "--seconds", tiny.window(loop_of(cell)),
                    "--faults", "0",
                    "--first-seed", str(SEED)], device="cpu", root=root, base=base)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    program, control = summary["summary"]["program"], summary["summary"]["control"]
    limits = summary["limits"]
    assert all(program[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits)


def test_a_loop_declares_its_faults_and_a_mix_its_tiny_size(tmp_path, monkeypatch):
    assert faults.names("offline") == faults.FAULTS["offline"]
    planted = []
    probe = types.ModuleType("bench_port.loops.probe")
    probe.FAULTS = ("slow", "wrong")
    probe.plant = lambda fault, cfg: planted.append((fault, cfg)) or 7
    monkeypatch.setitem(sys.modules, probe.__name__, probe)
    assert "probe" not in faults.FAULTS and faults.names("probe") == ("slow", "wrong")
    assert faults.planted("wrong", "probe", {"call": "x"}) == 7
    assert planted == [("wrong", {"call": "x"})]
    with pytest.raises(ValueError):
        faults.planted("altered", "probe", {"call": "x"})
    root, base = tiny.tree(tmp_path)
    for path in (tiny.BENCH / "traffic").glob("*.json"):
        written = json.loads((base / "traffic" / path.name).read_text())
        if path.stem in tiny.TINY_TRAFFIC:
            assert written == tiny.TINY_TRAFFIC[path.stem]
        else:
            mix = json.loads(path.read_text())
            assert written == mix["tiny"] and written["loop"] == mix["loop"]


def _python(args, cwd, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240, **kw)


def test_without_a_card_run_exits_nonzero_and_prints_nothing():
    done = _python(["bench_port/run.py", "--workload", tiny.cells()[0], "--seed", str(SEED),
                    "--seconds", "1"], cwd=tiny.ROOT)
    assert done.returncode == 2 and done.stdout == ""


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = ("import sys; sys.path.insert(0, '.'); from bench_port import run; "
              f"sys.exit(run.main(['--workload', '{tiny.cells()[0]}', '--seed', '1', "
              "'--seconds', '0.1'], device='cpu'))")
    done = _python(["-c", script], cwd=tmp_path)
    assert done.returncode != 0 and done.stdout == ""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root, base = tiny.tree(tmp_path)
    script = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
              "from bench_port import run, harness; "
              f"rc = run.main(['--workload', '{tiny.cells()[0]}', '--seed', '3', '--seconds', "
              "'0.2'], device='cpu', root=Path(sys.argv[2]), base=Path(sys.argv[3])); "
              "print('FORBIDDEN', harness.forbidden_modules()); sys.exit(rc)")
    done = _python(["-c", script, str(tiny.ROOT), str(root), str(base)], cwd=tmp_path)
    assert done.returncode == 0, done.stderr
    assert "FORBIDDEN []" in done.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_no_file_imports_jax_or_the_jax_package():
    for path in tiny.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_and_the_counts_import_nothing_of_the_port():
    for part in ("reference", "work"):
        for path in (tiny.BENCH / part).rglob("*.py"):
            for name in _imports(path):
                assert name.split(".")[0] != "nnaudio_tpu_torch", (path, name)


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["nnaudio_tpu_torch", "nnaudio_tpu_torch.ops",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["jax", "jaxlib.xla_client", "nnaudio_tpu.features",
                                      "flax"]) == ["flax", "jax", "jaxlib", "nnaudio_tpu"]


def test_trace_reduction_on_made_up_events():
    from types import SimpleNamespace as NS

    from bench_port import trace

    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    ev = lambda name, a, b: NS(name=name, time_range=NS(start=a, end=b))
    host = [ev(trace.WINDOW, 0, 100), ev(trace.CALL, 10, 50), ev("aten::pad", 20, 30)]
    starts = [e.time_range.start for e in host]
    assert trace._host_at(starts, host, 25) == "aten::pad"
    assert trace._host_at(starts, host, 40) == "port Python inside a call"
    assert trace._host_at(starts, host, 60) == "harness, between calls"
    t = trace.Trace(window_s=1.0, busy_s=0.5,
                    kernel_s={"framed_tc_kernel<float, 112>": 0.3, "kchunk_tc_kernel": 0.1,
                              "elementwise": 0.1},
                    launches=[trace.Launch("sgemm", 0.2, ("aten::bmm", "aten::einsum",
                                                          "_PairBackward")),
                              trace.Launch("sgemm", 0.1, ("aten::mm", "aten::matmul")),
                              trace.Launch("copy", 0.05, ("aten::copy_", "_PairBackward"))],
                    idle_by_host=[("port Python inside a call", 0.4), ("aten::pad", 0.1)],
                    stats={}, host_stats={})
    assert t.seconds_of("framed_tc", "kchunk_") == pytest.approx(0.4)
    assert t.launched_under("_PairBackward", ("aten::mm", "aten::bmm")) == pytest.approx(0.2)
    b = t.breakdown()
    assert b["device_ops"][0] == ["framed_tc_kernel<float, 112>", 0.3]
    assert b["idle_gaps"] == [["port Python inside a call", 0.4], ["aten::pad", 0.1]]
