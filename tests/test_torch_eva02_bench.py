"""The benchmark's EVA02-CLIP-L/14-336 cell, found by name as the harness
finds it (BENCHMARK.json, portbench/harness/cell.py): its configuration,
traffic mix, limits, driver and per-layer metrics' readers; the three new
count functions against hand counts at EVA02-L/14's shapes; and the
driver run at a tiny EVA02-shaped cell on the CPU (the kernels' plain
versions), where the bf16 program passes its check and the float8 control
fails it."""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench.harness import cell
from portbench.harness.eva02_counts import (qkv_rope_bytes,
                                            swiglu_gate_bytes, swiglu_layer)
from portbench.harness.flops import encoder_flops

CONFIG = "voc-eva02l14-fast"
CELL = "voc-eva02l14-fast.lam_sweep"
NEW_METRICS = ("swiglu_roofline.lam", "swiglu_gate_roofline.lam",
               "qkv_rope_roofline.lam")
LISTED = ("lam_device_ms_per_img", "wall_img_per_s.lam", "host_prep_ms.lam",
          "device_idle.lam", "mfu.lam", "attn_roofline.lam",
          "par_roofline.lam")
TINY = os.path.join(cell.BENCH_DIR, "tests", "data", "BENCHMARK_eva02.json")


@pytest.fixture(scope="module")
def bench():
    return cell.load_benchmark()


def test_the_configuration_is_eva02_at_published_widths(bench):
    from excel_tpu_torch.config import fast, voc_config, with_backbone

    conf = cell.find(bench["configs"], CONFIG, "config")
    assert conf["reduced"] == []
    assert conf["source"].endswith("model_configs/EVA02-CLIP-L-14-336.json")
    spec = cell.load_json(cell.config_file(cell.DEFAULT, conf))
    cfg = cell.build_config(spec)
    assert cfg == with_backbone(fast(voc_config()), "eva02-clip-l-14-336")
    c = cfg.clip
    assert (c.vision_layers, c.vision_width, c.vision_heads, c.hidden,
            c.patch_size, c.image_size, c.tokens, c.pretrain_grid,
            c.rope_grid, c.ln_eps, c.block, c.embed_dim) == \
        (24, 1024, 16, 2730, 14, 336, 577, 24, 16, 1e-6, "eva02", 768)
    assert len(spec["assumed"]) >= 5


def test_the_cell_traffic_limits_and_driver(bench):
    wl = cell.find(bench["workloads"], CELL, "workload")
    assert (wl["config"], wl["chips"]) == (CONFIG, 1)
    mix = cell.load_json(cell.data_file(cell.DEFAULT, bench, "traffic",
                                        wl["traffic"]))
    vith = cell.load_json(cell.data_file(cell.DEFAULT, bench, "traffic",
                                         "lam_sweep_voc_openclip"))
    assert mix["workflow"] == "lam_sweep_eva02"
    assert dict(mix, workflow=None) == dict(vith, workflow=None)
    limits = cell.load_json(cell.data_file(cell.DEFAULT, bench, "limits",
                                           CELL))
    for key in ("lam_err", "attn_err", "label_miss"):
        assert 0 < limits[key]["lower"] < limits[key]["limit"] \
            < limits[key]["upper"], key
    driver = cell.load_module("drivers", mix["workflow"])
    base = driver._sweep_module()
    assert isinstance(base.R, driver.FlatMaps)
    from portbench.reference import eva02

    assert base.R.lam_image is eva02.lam_image
    from excel_tpu_torch.config import tiny_config, with_backbone
    from portbench.harness import weights_eva02

    # the program is served the padded copy; the reference the drawn tree
    cfg = with_backbone(tiny_config(), "eva02-clip-l-14-336", tiny=True)
    ctx = types.SimpleNamespace(cfg=cfg, spec={"background_rows": 3},
                                seed=2 ** 31 + 77, device=torch.device("cpu"))
    params, text = base.model_inputs(ctx)
    numbers = base.reference_numbers(cfg, params, text)
    assert (numbers["rope_grid"], numbers["eps"], numbers["heads"]) == \
        (16, 1e-6, 2)
    drawn = weights_eva02.clip_visual(cfg.clip, ctx.seed, ctx.device)
    for i in (0, 3):
        mlp = params["clip"]["visual"]["blocks"][i]["mlp"]
        ref = numbers["visual"]["blocks"][i]["mlp"]
        want = drawn["visual"]["blocks"][i]["mlp"]
        assert mlp["fc"]["w"].shape == (2 * 344, 128)
        assert mlp["proj"]["w"].shape == (128, 344)
        for key in ("fc", "proj"):
            assert torch.equal(ref[key]["w"], want[key]["w"]), key
            assert torch.equal(ref[key]["b"], want[key]["b"]), key


def test_the_metrics_and_their_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in LISTED:
        assert CELL in {**e2e, **layer}[name]["workloads"], name
    assert "workloads" not in e2e["setup_s"]
    for name in NEW_METRICS:
        m = layer[name]
        assert (m["unit"], m["source"], m["moves"], m["workloads"]) == \
            ("%", "device_trace", "lam_device_ms_per_img", [CELL])
        assert m["layer"] in ("encoder MLP", "encoder attention")
    for name in LISTED[1:] + NEW_METRICS:
        assert callable(cell.load_module("metrics", name).read), name
    metrics = [m["name"] for m in cell.cell_metrics(bench, CELL, True)]
    assert set(NEW_METRICS) <= set(metrics)
    assert "mlp_roofline.lam" not in metrics


def test_counts_against_hand_counts():
    """At EVA02-L/14's lam batch (4 images of 577 tokens, width 1024, 16
    heads of 64, hidden 2,730, bf16): the SwiGLU's 6 n c h FLOPs, within
    0.03% of the 16 n c^2 that encoder_flops counts for an MLP; the gate's
    2 h read and h written a token; the rotating split's qkv read, q, k, v
    written and its table read once."""
    b, n, c, h = 4, 577, 1024, 2730
    flops, nbytes = swiglu_layer(b, n, c, h, 2, 2)
    assert flops == 6 * 4 * 577 * 1024 * 2730 == 38_712_360_960
    assert nbytes == 2 * (2 * 4 * 577 * 1024) + 2 * (3 * 1024 * 2730
                                                     + 2 * 2730 + 1024) \
        + 4 * 2 * 2730
    assert abs(flops / (16 * b * n * c * c) - 1) < 3e-4
    assert swiglu_gate_bytes(b * n, h, 2) == 3 * 2308 * 2730 * 2 \
        + 2 * 2730 * 2 + 2 * 2730 * 4
    assert qkv_rope_bytes(b, n, c, 64, 2) == 2 * (4 * 577 * 3072) * 2 \
        + 3072 * 2 + 2 * 576 * 64 * 4
    from excel_tpu_torch.config import ClipConfig, BACKBONES

    eva = ClipConfig(**BACKBONES["eva02-clip-l-14-336"]["full"])
    counted = encoder_flops(eva, 336)
    true = counted - eva.vision_layers * (16.0 * n * c * c
                                          - 6.0 * n * c * h)
    assert abs(true / counted - 1) < 3e-4


def _run(seed, trace=0, control=None):
    """(exit code, the result line, standard error) of one run of the tiny
    cell in a process of its own, as the benchmark's command runs one: the
    harness refuses a process that has loaded JAX, which this suite's
    conftest does."""
    args = [sys.executable, os.path.join(cell.BENCH_DIR, "run.py"),
            "--workload", "tiny.lam_sweep_eva02", "--seed", str(seed),
            "--seconds", "2", "--trace", str(trace), "--device", "cpu",
            "--benchmark", TINY]
    if control:
        args += ["--control", control]
    proc = subprocess.run(args, cwd=cell.ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else None, \
        proc.stderr


def test_tiny_cell_bf16_passes_and_float8_control_fails():
    rc, line, err = _run(2 ** 31 + 11)
    assert rc == 0, err[-2000:]
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"missing_outputs", "lam_err", "attn_err",
                                   "label_mismatch_median", "label_miss"}
    rc, line, _ = _run(2 ** 31 + 11, control="float8")
    assert rc == 0 and not line["correct"]


def test_tiny_cell_traced_line_reports_what_a_cpu_run_can_read():
    rc, line, _ = _run(5, trace=1)
    assert rc == 0 and line["correct"]
    assert {"host_prep_ms.lam", "wall_img_per_s.lam"} <= set(line["metrics"])
    # device shares are never read from a run on the CPU
    assert not set(NEW_METRICS) & set(line["metrics"])
