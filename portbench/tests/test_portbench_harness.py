"""The harness: every cell and metric found by name in data, a new cell
from new files alone, the result line's contract, no quiet fall back to the
CPU, and the check that JAX never loaded."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.common import BENCH, DATA, ROOT, run_tiny
from portbench.harness import cell, env

BENCHMARK = cell.load_benchmark()


@pytest.mark.parametrize("wl", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_loads_from_data(wl):
    conf = cell.find(BENCHMARK["configs"], wl["config"], "config")
    spec = cell.load_json(os.path.join(ROOT, conf["file"]))
    cfg = cell.build_config(spec)
    for path, value in spec["program"].items():
        node = cfg
        for part in path.split("."):
            node = getattr(node, part)
        if path.endswith("compute_dtype"):
            assert str(node).endswith(value)
        else:
            assert (list(node) if isinstance(node, tuple) else node) == value
    traffic = cell.load_json(cell.data_file(cell.DEFAULT, BENCHMARK,
                                            "traffic", wl["traffic"]))
    driver = cell.load_module("drivers", traffic["workflow"])
    assert callable(driver.run)
    limits = cell.load_json(cell.data_file(cell.DEFAULT, BENCHMARK,
                                           "limits", wl["name"]))
    assert limits and all("limit" in v for v in limits.values()
                          if isinstance(v, dict))
    # the cell compares some of the numbers its driver gives (the tests'
    # tiny cell of the same workflow compares them all), each by name
    tiny = cell.load_json(os.path.join(
        DATA, "limits", f"tiny.{traffic['workflow']}.json"))
    named = {k for k, v in limits.items() if isinstance(v, dict)}
    assert named and named <= {k for k, v in tiny.items()
                               if isinstance(v, dict)}


@pytest.mark.parametrize("m", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    assert callable(cell.load_module("metrics", m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
    for w in m.get("workloads", []):
        cell.find(BENCHMARK["workloads"], w, "workload")


def test_every_cell_reports_setup_and_a_metric_of_each_kind():
    for wl in BENCHMARK["workloads"]:
        e2e = {m["name"] for m in cell.cell_metrics(BENCHMARK, wl["name"],
                                                    False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.cell_metrics(BENCHMARK, wl["name"], True)


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark gains a cell (new traffic, limits) and a
    per-layer metric (new reader) by new files and new entries alone; the
    new cell runs and reports the new metric."""
    work = tmp_path / "checkout"
    shutil.copytree(BENCH, work / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "tiny.lam_new", "config": "tiny",
                               "traffic": "lam_new", "chips": 1,
                               "why": "a cell added by data"})
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["per_layer"].append({"name": "host_read_ms.new", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "host sweep",
                               "moves": "lam_device_ms_per_img",
                               "workloads": ["tiny.lam_new"]})
    for e in bench["end_to_end"]:
        if e["name"] == "lam_device_ms_per_img":
            e["workloads"].append("tiny.lam_new")
    (work / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = work / "portbench"
    shutil.copy(os.path.join(DATA, "tiny.json"), pb / "configs" / "tiny.json")
    shutil.copy(os.path.join(DATA, "traffic", "tiny_lam.json"),
                pb / "traffic" / "lam_new.json")
    shutil.copy(os.path.join(DATA, "limits", "tiny.lam_sweep.json"),
                pb / "limits" / "tiny.lam_new.json")
    (pb / "metrics" / "host_read_ms.new.py").write_text(
        "from portbench.harness import readers\n\n\ndef read(reading):\n"
        "    return readers.host_ms(reading, ('read',))\n")
    env_ = dict(os.environ, PYTHONPATH=ROOT)
    out = {}
    for trace in (0, 1):
        p = subprocess.run(
            [sys.executable, str(pb / "run.py"), "--workload",
             "tiny.lam_new", "--seed", "5", "--seconds", "1.5", "--trace",
             str(trace), "--device", "cpu"], capture_output=True,
            text=True, env=env_, cwd=str(work), timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        out[trace] = json.loads(p.stdout.strip().splitlines()[-1])
    # the device's time is never read from a run on the CPU
    assert out[0]["correct"] and set(out[0]["metrics"]) == {"setup_s"}
    assert "host_read_ms.new" in out[1]["metrics"]


def test_result_line_keys():
    rc, line, err = run_tiny("lam", seed=2 ** 31 + 9)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    # lam_device_ms_per_img is a device number: none from the CPU
    assert set(line["metrics"]) == {"setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert [ln.split()[1] for ln in last] == list(line["checks"])
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_line_has_per_layer_metrics_and_window():
    rc, line, _ = run_tiny("lam", seed=4, trace=1)
    assert rc == 0
    assert {"host_prep_ms.lam", "wall_img_per_s.lam"} <= set(line["metrics"])
    assert line["metrics"]["wall_img_per_s.lam"]["value"] > 0
    assert "lam_device_ms_per_img" not in line["metrics"]
    # device shares are never read from a CPU run
    assert "device_idle.lam" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_is_an_error_not_a_fall_back():
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "voc-vitb16-fast.lam_sweep", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["excel_tpu_torch", "excel_tpu_torch.engine.evaluate", "numpy",
          "jaxtyping", "flax_like"]
    assert env.forbidden_modules(ok) == []
    assert env.forbidden_modules(ok + ["excel_tpu.models.clip"]) == \
        ["excel_tpu"]
    assert env.forbidden_modules(["jax._src.core", "jaxlib", "flax"]) == \
        ["flax", "jax", "jaxlib"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "excel_tpu",
                        types.ModuleType("excel_tpu"))
    rc, line, err = run_tiny("lam", seed=3, seconds=1.0)
    assert rc == 4 and line is None
    assert "excel_tpu" in err


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder (no
    program) exits with an error and prints no result."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "voc-vitb16-fast.lam_sweep", "--seed", "7", "--seconds", "2",
         "--trace", "0", "--device", "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "excel_tpu_torch" in p.stderr


def test_benchmark_file_meets_the_contract():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert len(os.path.join(ROOT, "BENCHMARK.json")) and \
        os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in b["end_to_end"])


def test_witness_runs_the_cells_own_traffic():
    """The float32 witness (data/witness/BENCHMARK.json) reads copies of
    its cells' traffic files: they are the same."""
    wit = os.path.join(DATA, "witness", "BENCHMARK.json")
    wb = cell.load_benchmark(wit)
    for w in wb["workloads"]:
        assert cell.load_json(cell.data_file(wit, wb, "traffic",
                                             w["traffic"])) == \
            cell.load_json(cell.data_file(cell.DEFAULT, BENCHMARK,
                                          "traffic", w["traffic"]))


@pytest.mark.parametrize("trace,device_e2e,expect", [
    (False, True, 5.0), (True, True, None), (False, False, None)])
def test_device_time_is_read_over_the_whole_untraced_window(
        trace, device_e2e, expect):
    """An untraced run of a cell whose end-to-end metric is the device's
    time traces the device's activity alone from before the window's clock
    starts to after it stops; a traced run's partial trace never gives it."""
    import types
    from portbench.harness.context import Window

    calls = []

    class FakeTracer:
        active = started = False

        def start(self, device_only=False):
            calls.append(("start", device_only))
            self.active = self.started = True

        def stop(self):
            calls.append(("stop",))
            self.active = False

        def reduce(self):
            return {"busy_s": 0.5, "kernels": 10}

    spans = types.SimpleNamespace(mark=lambda: None, tracing=False)
    ctx = types.SimpleNamespace(
        trace=trace, device_e2e=device_e2e, seconds=1.0,
        device=types.SimpleNamespace(type="cuda"), tracer=FakeTracer(),
        spans=spans, synchronize=lambda: None,
        trace_bounds=lambda: (0.25, 0.75))
    win = Window(ctx)
    win.open()
    win.close()
    assert win.device_ms_per(100) == expect
    if expect is not None:
        assert calls == [("start", True), ("stop",)]
