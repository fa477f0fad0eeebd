"""The lam_sweep_openclip driver at a tiny OpenCLIP-shaped cell on the CPU
(tiny_config with ViT-H/14's head dim 80, exact GELU and patch 14 at grid
4, fast): the bf16 program passes its check, the float8 control fails it,
the traced line reports the cell's per-layer metrics that a CPU run can
read, and the encoder MLP's count is 16 n c^2 an image."""
import contextlib
import io
import json
import os

import torch

from portbench.harness import cell
from portbench.harness.mlp_counts import mlp_layer
from portbench.reference import openclip
from portbench.tests.common import DATA

BENCHMARK = os.path.join(DATA, "BENCHMARK_openclip.json")
CELL = "tiny.lam_sweep_openclip"


def _run(seed, trace=0, control=None):
    """(exit code, the result line, standard error) of one run of CELL."""
    from portbench import run

    args = ["--workload", CELL, "--seed", str(seed), "--seconds", "2",
            "--trace", str(trace), "--device", "cpu", "--benchmark",
            BENCHMARK]
    if control:
        args += ["--control", control]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(args)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


def test_bf16_program_passes_and_float8_control_fails():
    rc, line, err = _run(2 ** 31 + 11)
    assert rc == 0, err[-2000:]
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"missing_outputs", "lam_err", "attn_err",
                                   "label_mismatch_median", "label_miss"}
    rc, line, _ = _run(2 ** 31 + 11, control="float8")
    assert rc == 0 and not line["correct"]


def test_traced_line_reports_what_a_cpu_run_can_read():
    rc, line, _ = _run(5, trace=1)
    assert rc == 0 and line["correct"]
    assert {"host_prep_ms.lam", "wall_img_per_s.lam"} <= set(line["metrics"])
    # device shares (mfu, the rooflines, mlp_roofline among them) are
    # never read from a run on the CPU
    assert "mlp_roofline.lam" not in line["metrics"]


def test_the_driver_checks_against_the_openclip_reference():
    driver = cell.load_module("drivers", "lam_sweep_openclip")
    base = driver._sweep_module()
    assert isinstance(base.R, driver.FlatMaps)
    assert base.R.lam_image is openclip.lam_image
    from excel_tpu_torch.config import tiny_config, with_backbone

    cfg = with_backbone(tiny_config(), "openclip-vit-h-14", tiny=True)
    numbers = base.reference_numbers(
        cfg, {"clip": {"visual": {}}}, torch.zeros(2, 3))
    assert (numbers["activation"], numbers["heads"]) == ("gelu", 2)


def test_mlp_count_is_16_n_c2_an_image():
    flops, nbytes = mlp_layer(4, 577, 1280, 5120, 2, 2)
    assert flops == 16 * 4 * 577 * 1280 ** 2
    assert nbytes == 2 * (2 * 4 * 577 * 1280) + 2 * (2 * 1280 * 5120
                                                      + 5120 + 1280)


def test_flat_refined_maps_leave_label_miss():
    """An image whose refined map is constant (uniform attention, a constant
    LAM) counts its misses under label_miss_flat; one with a peaked map
    under label_miss."""
    driver = cell.load_module("drivers", "lam_sweep_openclip")
    flat = driver.FlatMaps()
    m = {"caa": 0.5, "dilations": (1,), "iters": 1}
    guide = torch.rand(3, 8, 8, generator=torch.Generator().manual_seed(0))
    gap = torch.full((8, 8), 0.1)
    hw = 16
    flat.cams_from_state(m, torch.full((1, hw), 0.5), torch.ones(hw, hw),
                         guide)
    assert flat.flat
    out = flat.gap_summary(gap)
    assert (out["miss"], out["miss_flat"]) == (0.0, 1.0)
    lams = torch.zeros(1, hw)
    lams[0, 5] = 1.0
    flat.cams_from_state(m, lams, torch.eye(hw) + 0.01, guide)
    assert not flat.flat
    out = flat.gap_summary(gap)
    assert (out["miss"], out["miss_flat"]) == (1.0, 0.0)
    assert flat.images == [(True, 1.0), (False, 1.0)]
