"""The benchmark's SigLIP So400m/14 cell, found by name as the harness finds
it (BENCHMARK.json, portbench/harness/cell.py): its configuration, traffic
mix, limits, driver and per-layer metrics' readers; the count functions of
harness/siglip_counts.py against hand counts at So400m/14's shapes; and the
driver run at a tiny SigLIP-shaped cell on the CPU (the kernels' plain
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
from portbench.harness import flops as F
from portbench.harness import siglip_counts as SC

CONFIG = "voc-siglip-so400m14-fast"
CELL = "voc-siglip-so400m14-fast.lam_sweep"
NEW_METRIC = "map_head_roofline.lam"
LISTED = ("lam_device_ms_per_img", "wall_img_per_s.lam", "host_prep_ms.lam",
          "device_idle.lam", "mfu.lam", "attn_roofline.lam",
          "par_roofline.lam", "mlp_roofline.lam")
TINY = os.path.join(cell.BENCH_DIR, "tests", "data", "BENCHMARK_siglip.json")
SIGLIP = "siglip-so400m-14-384"


@pytest.fixture(scope="module")
def bench():
    return cell.load_benchmark()


def test_the_configuration_is_siglip_at_published_widths(bench):
    from excel_tpu_torch.config import fast, voc_config, with_backbone

    conf = cell.find(bench["configs"], CONFIG, "config")
    assert conf["reduced"] == []
    assert conf["source"] == ("https://huggingface.co/google/"
                              "siglip-so400m-patch14-384/blob/main/"
                              "config.json")
    spec = cell.load_json(cell.config_file(cell.DEFAULT, conf))
    cfg = cell.build_config(spec)
    assert cfg == with_backbone(fast(voc_config()), SIGLIP)
    c = cfg.clip
    assert (c.vision_layers, c.vision_width, c.vision_heads, c.hidden,
            c.patch_size, c.image_size, c.tokens, c.pretrain_grid,
            c.ln_eps, c.block, c.embed_dim, c.patch_start, c.tokenizer,
            c.activation, c.image_stats) == \
        (27, 1152, 16, 4304, 14, 378, 729, 27, 1e-6, "siglip", 1152, 0,
         "siglip", "gelu_tanh", ((127.5,) * 3, (127.5,) * 3))
    assert c.vision_width // c.vision_heads == 72
    assert (c.text_layers, c.text_width, c.text_heads, c.context_length,
            c.vocab_size, c.text_mlp_hidden, c.text_causal, c.text_pool) \
        == (27, 1152, 16, 64, 32000, 4304, False, "last")
    assert (cfg.head.in_channels, cfg.head.num_blocks,
            cfg.data.crop_size) == (1152, 27, 378)
    assert any("378" in a for a in spec["assumed"])
    assert len(spec["assumed"]) >= 5


def test_the_cell_traffic_limits_and_driver(bench):
    wl = cell.find(bench["workloads"], CELL, "workload")
    assert (wl["config"], wl["chips"]) == (CONFIG, 1)
    mix = cell.load_json(cell.data_file(cell.DEFAULT, bench, "traffic",
                                        wl["traffic"]))
    vith = cell.load_json(cell.data_file(cell.DEFAULT, bench, "traffic",
                                         "lam_sweep_voc_openclip"))
    assert mix["workflow"] == "lam_sweep_siglip"
    assert dict(mix, workflow=None) == dict(vith, workflow=None)
    limits = cell.load_json(cell.data_file(cell.DEFAULT, bench, "limits",
                                           CELL))
    for key in ("lam_err", "attn_err", "label_miss"):
        assert 0 < limits[key]["lower"] < limits[key]["limit"] \
            < limits[key]["upper"], key
    driver = cell.load_module("drivers", mix["workflow"])
    base = driver._sweep_module()
    assert isinstance(base.R, driver.FlatMaps)
    assert base.F.encoder_flops is SC.encoder_flops
    assert base.F.svc_flops is F.svc_flops
    assert base.S.Capture is driver.Capture
    from excel_tpu_torch.config import tiny_config, with_backbone
    from portbench.harness import weights_siglip

    cfg = with_backbone(tiny_config(), SIGLIP, tiny=True)
    ctx = types.SimpleNamespace(cfg=cfg, spec={"background_rows": 3},
                                seed=2 ** 31 + 77, device=torch.device("cpu"))
    params, text = base.model_inputs(ctx)
    numbers = base.reference_numbers(cfg, params, text)
    assert (numbers["eps"], numbers["heads"]) == (1e-6, 2)
    assert text.shape == (cfg.num_fg + 3, 144)
    drawn = weights_siglip.clip_visual(cfg.clip, ctx.seed, ctx.device)
    v = params["clip"]["visual"]
    assert torch.equal(v["map_head"]["probe"],
                       drawn["visual"]["map_head"]["probe"])
    assert set(v) == {"patch_embed", "patch_bias", "positional_embedding",
                      "blocks", "ln_post", "map_head"}
    assert v["positional_embedding"].shape == (16, 144)
    assert v["blocks"][0]["mlp"]["fc"]["w"].shape == (536, 144)
    # the check reads the attention after a CLS row and column: the
    # driver's capture puts zeros there
    cap = driver.Capture([{"name": "a", "label": torch.zeros(2, 2)}])
    cap.prepared([{"name": "a"}])
    cap.next_batch()
    attn = torch.rand(1, 16, 16)
    cap.take("attn", attn)
    got = cap.out[0]["attn"]
    assert got.shape == (17, 17) and torch.equal(got[1:, 1:], attn[0])
    assert not got[0].any() and not got[:, 0].any()


def test_the_metrics_and_their_readers(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in LISTED:
        assert CELL in {**e2e, **layer}[name]["workloads"], name
    assert "workloads" not in e2e["setup_s"]
    m = layer[NEW_METRIC]
    assert (m["unit"], m["source"], m["moves"], m["workloads"],
            m["layer"]) == ("%", "device_trace", "lam_device_ms_per_img",
                            [CELL], "encoder pooling head")
    for name in LISTED[1:] + (NEW_METRIC,):
        assert callable(cell.load_module("metrics", name).read), name
    metrics = [m["name"] for m in cell.cell_metrics(bench, CELL, True)]
    assert NEW_METRIC in metrics
    assert not {"swiglu_roofline.lam", "qkv_rope_roofline.lam"} & \
        set(metrics)


def test_counts_against_hand_counts():
    """At So400m/14's lam batch (4 images of 729 tokens, width 1152, 16
    heads of 72, hidden 4,304, bf16): the head's products counted by hand,
    its bytes, and the tower's FLOPs: flops.encoder_flops (a CLS row, MLPs
    of 4 c, a projection) counts the blocks 4.4% high, and no head."""
    b, n, c, h = 4, 729, 1152, 4304
    per = SC.map_head_flops(n, c, h)
    assert per == (2 * c * c + 4 * n * c * c + 4 * n * c + 2 * n * c * c
                   + 2 * 730 * c * c + 4 * 730 * c * h)
    assert 18e9 < per < 23e9
    flops, nbytes = SC.map_head_layer(b, n, c, h, 2, 2)
    assert flops == 4 * (per - 2 * c * c) + 2 * c * c
    assert nbytes == 2 * (2 * 4 * 729 * 1152) + 2 * (4 * 730 * 1152) \
        + 2 * (4 * c * c + 4 * c + 2 * c * h + h + c) + 4 * 5 * c
    from excel_tpu_torch.config import BACKBONES, ClipConfig

    sig = ClipConfig(**dict(BACKBONES[SIGLIP]["full"], attn_out_layers=6))
    counted = SC.encoder_flops(sig, 378)
    plain = 8 * n * c * c + 4 * n * n * c + 4 * n * c * h
    surgery = 10 * n * c * c + 12 * n * n * c + 4 * n * c * h
    assert counted == 2 * n * c * 3 * 196 + 22 * plain + 5 * surgery + per
    assert 695e9 < counted - per < 705e9
    assert 0.04 < F.encoder_flops(sig, 378) / (counted - per) - 1 < 0.05


def _run(seed, trace=0, control=None):
    """(exit code, the result line, standard error) of one run of the tiny
    cell in a process of its own, as the benchmark's command runs one: the
    harness refuses a process that has loaded JAX, which this suite's
    conftest does."""
    args = [sys.executable, os.path.join(cell.BENCH_DIR, "run.py"),
            "--workload", "tiny.lam_sweep_siglip", "--seed", str(seed),
            "--seconds", "2", "--trace", str(trace), "--device", "cpu",
            "--benchmark", TINY]
    if control:
        args += ["--control", control]
    proc = subprocess.run(args, cwd=cell.ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else None, \
        proc.stderr


@pytest.mark.parametrize("control", [None, "float8"],
                         ids=["bf16", "float8_control"])
def test_tiny_cell_bf16_passes_and_float8_control_fails(control):
    rc, line, err = _run(2 ** 31 + 11, control=control)
    assert rc == 0, err[-2000:]
    assert line["correct"] == (control is None), line["checks"]
    assert set(line["checks"]) == {"missing_outputs", "lam_err", "attn_err",
                                   "label_mismatch_median", "label_miss"}


def test_tiny_cell_traced_line_reports_what_a_cpu_run_can_read():
    rc, line, _ = _run(5, trace=1)
    assert rc == 0 and line["correct"]
    assert {"host_prep_ms.lam", "wall_img_per_s.lam"} <= set(line["metrics"])
    # device shares are never read from a run on the CPU
    assert NEW_METRIC not in line["metrics"]
