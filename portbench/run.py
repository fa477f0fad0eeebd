"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(configs/<name>.json) and a traffic mix (traffic/<name>.json) whose
"workflow" picks the driver (drivers/<workflow>.py); its limits are in
limits/<cell>.json and each per-layer metric's reader in
metrics/<metric>.py. --trace 0 reports the cell's end-to-end metrics (those read from the
device trace from a trace of the device's activity over the whole window),
--trace 1 its per-layer metrics from a device trace of part of the window.
Both check the window's outputs against the plain float32 reference and
print each number compared beside its limit, last, on standard error and
in the result line.

Exit codes: 0 with a result line; 2 bad arguments; 3 no card, or fewer
than the cell needs; 4 JAX or the JAX package was loaded. Hidden options
serve the benchmark's own tests and control runs: --device cpu (plain
versions of the kernels, for tiny configurations), --benchmark <file>
(another BENCHMARK.json, whose data files lie under its own `paths`:
the tests' tiny cells, the float32 witness), --control <precision> (the
reference at that precision stands in for the program's outputs in the
comparison) and --fault half_batch | altered (training: the program's
step runs on the first half of each batch, its mean over those rows; or
its pseudo-labels are altered where they are made; the check must come
out false).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# one intra-op CPU thread: the program's own threads (the eval sweeps'
# prefetch thread, the loader's pool) are untouched, and no idle OpenMP
# pool spins beside them (with 8 such threads a sweep's rate swung 42-58
# img/s between runs of one seed)
os.environ["OMP_NUM_THREADS"] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import cell, env  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--benchmark", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=("bfloat16", "float8"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", choices=("half_batch", "altered"),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, t_process=None) -> int:
    args = parse(argv)
    env.set_cache_dirs(ROOT)
    path = args.benchmark or cell.DEFAULT
    bench = cell.load_benchmark(path)
    wl = cell.find(bench["workloads"], args.workload, "workload")
    conf = cell.find(bench["configs"], wl["config"], "config")
    spec = cell.load_json(cell.config_file(path, conf))
    traffic = cell.load_json(cell.data_file(path, bench, "traffic",
                                            wl["traffic"]))
    limits = {k: v for k, v in cell.load_json(cell.data_file(
        path, bench, "limits", wl["name"])).items() if isinstance(v, dict)}

    import torch
    torch.set_num_threads(1)
    from portbench.harness.context import Context
    from portbench.harness.trace import Tracer
    from portbench.harness import report

    if args.device.startswith("cuda"):
        try:
            env.require_cards(wl["chips"])
        except env.NoCards as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 3
    device = torch.device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    cfg = cell.build_config(spec)
    driver = cell.load_module("drivers", traffic["workflow"])
    workdir = tempfile.mkdtemp(prefix="portbench-")
    ctx = Context(workload=wl, cfg=cfg, spec=spec, traffic=traffic,
                  limits=limits, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, workdir=workdir,
                  t_process=T_PROCESS if t_process is None else t_process,
                  control=args.control, fault=args.fault,
                  device_e2e=any(m["source"] == "device_trace" for m in
                                 cell.cell_metrics(bench, wl["name"], False)),
                  tracer=Tracer(device.type == "cuda"))
    try:
        outcome = driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = report.result_line(bench, ctx, outcome)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    report.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
