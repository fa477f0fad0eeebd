"""Running a cell of the benchmark in this process at a tiny size on the
CPU (the kernels' plain versions), for the benchmark's own tests."""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCHMARK = os.path.join(DATA, "BENCHMARK.json")
CELLS = {"lam": "lam_sweep", "msc": "msc", "train": "train"}


def tiny_args(kind: str, seed: int = 7, seconds: float = 2.0,
              trace: int = 0, config: str = "tiny", control=None):
    """A run of the tests' own benchmark (data/BENCHMARK.json): its cell
    `<config>.<workflow>` on the CPU."""
    args = ["--workload", f"{config}.{CELLS[kind]}", "--seed", str(seed),
            "--seconds", str(seconds), "--trace", str(trace), "--device",
            "cpu", "--benchmark", BENCHMARK]
    if control:
        args += ["--control", control]
    return args


def run_tiny(kind: str, **kw):
    """(exit code, the result line or None, standard error)."""
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(tiny_args(kind, **kw))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
