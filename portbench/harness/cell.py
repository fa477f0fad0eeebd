"""A cell from data: BENCHMARK.json names it, its configuration file, its
traffic file, its limits file and its per-layer metrics' readers, all
found by name: the data files under the first of its `paths`, the drivers
and readers (code) under the benchmark's folder."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


DEFAULT = os.path.join(ROOT, "BENCHMARK.json")


def load_benchmark(path: str = DEFAULT) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_file(bench_path: str, conf: dict) -> str:
    """A configuration's file, relative to its BENCHMARK.json."""
    return os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                        conf["file"])


def data_file(bench_path: str, bench: dict, kind: str, name: str) -> str:
    """<first of paths>/<kind>/<name>.json beside a BENCHMARK.json: a
    traffic mix by its name, a cell's limits by the cell's."""
    return os.path.join(os.path.dirname(os.path.abspath(bench_path)),
                        bench["paths"][0], kind, name + ".json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: its end-to-end metrics
    with --trace 0, its per-layer metrics with --trace 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _dtype(name):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def build_config(spec: dict):
    """The program's ExcelConfig of a configuration file: the preset it
    names, `fast()` where it says so, then every value under "program"
    (dotted field paths) set as the file states it."""
    from excel_tpu_torch import config as C

    cfg = getattr(C, spec["preset"])()
    if spec.get("fast"):
        cfg = C.fast(cfg)
    groups: dict = {}
    for path, value in spec["program"].items():
        group, _, field = path.rpartition(".")
        if field == "compute_dtype":
            value = _dtype(value)
        elif isinstance(value, list):
            value = tuple(value)
        groups.setdefault(group, {})[field] = value
    top = groups.pop("", {})
    for group, fields in groups.items():
        cfg = dataclasses.replace(
            cfg, **{group: dataclasses.replace(getattr(cfg, group),
                                               **fields)})
    return dataclasses.replace(cfg, **top)
