"""The port stands alone: no module of excel_tpu_torch and no line of
chip_smoke.py or of the port's kernel timing tools imports jax or
excel_tpu; with jax, excel_tpu, Pillow and regex blocked (the machine with
the card has neither of the last two) every module imports and the eval
CLIs run; and its entry points refuse to fall back to the CPU when no GPU
is present."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "excel_tpu")
# absent where the card is: blocked when the port runs below
BLOCKED = FORBIDDEN + ("PIL", "regex")


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
    which importing jax, excel_tpu, PIL or regex raises; then tokenize and
    run the eval CLIs at the tiny config on a 2-image synthetic tree (CAM
    overlays and palette PNGs written, the PNGs rescored)."""
    modules = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        modules.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                       else rel)
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {BLOCKED!r}):
            raise ImportError("blocked " + name)
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
assert not any(k.split(".")[0] in {BLOCKED!r} for k in sys.modules)
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked():
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
