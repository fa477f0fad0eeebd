"""The port stands alone: no module of excel_tpu_torch and no line of
chip_smoke.py or of the port's kernel timing tools imports jax or
excel_tpu; with jax, excel_tpu, Pillow, regex and scikit-learn blocked
(the port must need none of them where the card is) every module
imports, the eval and train CLIs and the attribute-bank tool run, the
ResNet tower runs and a JPEG is read; and its entry points refuse to fall
back to the CPU when no GPU is present."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "excel_tpu")
# absent where the card is: blocked when the port runs below
BLOCKED = FORBIDDEN + ("PIL", "regex", "sklearn")


def _port_files():
    files = [os.path.join(ROOT, f) for f in (
        "chip_smoke.py", "tools/attention_ab.py", "tools/par_ab.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "excel_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {m}" for m in names
                    if _forbidden(m)]
    assert not bad, bad
    assert len(_port_files()) > 15


def test_port_imports_with_jax_blocked(tmp_path):
    """Import every port module (and chip_smoke) in a fresh interpreter in
    which importing jax, excel_tpu, PIL, regex or sklearn raises; then
    tokenize and run the eval CLIs at the tiny config on a 2-image
    synthetic tree (CAM overlays and palette PNGs written, the PNGs
    rescored; infer_seg and infer_lam with the host CRF, the lattice built
    by g++), the train CLI for 2 steps with validation, TensorBoard events
    and PNG panels, make_attr_bank (the tiny config with the tokenizer's
    context and vocabulary; its own KMeans), a tiny ResNet tower's forward,
    and read_image / read_label on the JPEG fixtures (the decoder built by
    g++)."""
    modules = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        modules.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                       else rel)
    code = f"""
import importlib.abc, importlib.machinery, sys
class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError("blocked " + spec.name)
    def exec_module(self, module):
        pass
class Block:
    # a spec without an origin whose import raises: `import x` fails, and a
    # probe by importlib.util.find_spec (torch's, for optional packages)
    # sees nothing to load
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {BLOCKED!r}):
            return importlib.machinery.ModuleSpec(name, Refuse())
sys.meta_path.insert(0, Block())
sys.path.insert(0, {ROOT!r})
import importlib
for m in {modules!r}:
    importlib.import_module(m)
from excel_tpu_torch.text.tokenizer import tokenize
assert tokenize(["a clean origami cat."]).shape == (1, 77)
from excel_tpu_torch.cli import infer_lam, infer_seg, rescore
flags = ["--device", "cpu", "--tiny", "--random-init", "--synthetic", "2",
         "--work-dir", {str(tmp_path)!r}, "--batch-size", "2"]
infer_lam.main(flags + ["--training-free", "--save-cam"])
seg = infer_seg.main(flags + ["--scales", "1.0", "--save-preds"])
again = rescore.main(flags + ["--pred-dir", {str(tmp_path / "preds")!r}])
assert again["miou"] == seg["miou"]
_, crf = infer_seg.main(flags + ["--scales", "1.0", "--crf"])
_, lam_crf = infer_lam.main(flags + ["--training-free", "--crf",
                                     "--crf-stream", "--save-preds"])
assert crf["pAcc"] > 0 and lam_crf["pAcc"] > 0
from excel_tpu_torch.cli import train
state = train.main(flags + ["--max-iters", "2", "--eval-iters", "2",
                            "--log-iters", "1", "--tensorboard", "--viz"])
assert state.step == 2
import dataclasses
import numpy as np
import torch
from excel_tpu_torch.cli import common, make_attr_bank
tiny = common.tiny_config
common.tiny_config = lambda: dataclasses.replace(tiny(), clip=dataclasses.replace(
    tiny().clip, context_length=77, vocab_size=49408))
bank = {str(tmp_path / "bank.npz")!r}
make_attr_bank.main(["--tiny", "--random-init", "--device", "cpu",
                     "--out", bank])
with np.load(bank) as z:
    assert z["cluster_bank"].shape == (32, 12) and z["class_flags"].shape == (20, 12)
    assert (z["class_flags"].sum(axis=1) >= 1).all()
from excel_tpu_torch.models import resnet
g = torch.Generator().manual_seed(0)
sd = {{}}
def conv(key, o, i, k):
    sd[key] = torch.randn(o, i, k, k, generator=g) * (i * k * k) ** -0.5
def bn(prefix, c):
    sd[prefix + ".weight"], sd[prefix + ".bias"] = torch.ones(c), torch.zeros(c)
    sd[prefix + ".running_mean"], sd[prefix + ".running_var"] = torch.zeros(c), torch.ones(c)
for j, (o, i) in enumerate(((4, 3), (4, 4), (8, 4)), 1):
    conv(f"visual.conv{{j}}.weight", o, i, 3)
    bn(f"visual.bn{{j}}", o)
cin = 8
for li in range(1, 5):
    p = f"visual.layer{{li}}.0"
    planes = 8 * 2 ** (li - 1)
    conv(p + ".conv1.weight", planes, cin, 1); bn(p + ".bn1", planes)
    conv(p + ".conv2.weight", planes, planes, 3); bn(p + ".bn2", planes)
    conv(p + ".conv3.weight", planes * 4, planes, 1); bn(p + ".bn3", planes * 4)
    conv(p + ".downsample.0.weight", planes * 4, cin, 1); bn(p + ".downsample.1", planes * 4)
    cin = planes * 4
sd["visual.attnpool.positional_embedding"] = torch.randn(5, 256, generator=g)
for name, out in (("q_proj", 256), ("k_proj", 256), ("v_proj", 256), ("c_proj", 16)):
    sd[f"visual.attnpool.{{name}}.weight"] = torch.randn(out, 256, generator=g) / 16
    sd[f"visual.attnpool.{{name}}.bias"] = torch.zeros(out)
cfg = resnet.infer_resnet_config(sd)
params = resnet.convert_resnet_tower(sd, cfg, device="cpu")
out = resnet.resnet_forward(params, torch.randn(2, 96, 64, 3, generator=g), cfg)
assert out.shape == (2, 7, 16) and torch.isfinite(out).all()
import json, os
from excel_tpu_torch.data.datasets import read_image, read_label
fixtures = os.path.join({ROOT!r}, "tests", "torch_fixtures", "jpeg")
with open(os.path.join(fixtures, "expected.json")) as f:
    expected = json.load(f)
for name in ("synth_000000.jpg", "progressive.jpg"):
    assert list(read_image(os.path.join(fixtures, name)).shape) == expected[name]["shape"]
assert list(read_label(os.path.join(fixtures, "grey.jpg")).shape) == expected["grey.jpg"]["shape"]
assert not any(k.split(".")[0] in {BLOCKED!r} for k in sys.modules)
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path):
    from excel_tpu_torch.cli import train
    from excel_tpu_torch.config import tiny_config
    from excel_tpu_torch.models.params import init_clip_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_clip_params(tiny_config().clip)
    assert init_clip_params(tiny_config().clip, device="cpu")[
        "logit_scale"].device.type == "cpu"
    from excel_tpu_torch.models.head import init_head_params

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_head_params(cfg.head, cfg.num_classes)
    assert next(init_head_params(cfg.head, cfg.num_classes, device="cpu")
                .parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--tiny", "--random-init", "--synthetic", "2",
                    "--work-dir", str(tmp_path), "--max-iters", "1"])
