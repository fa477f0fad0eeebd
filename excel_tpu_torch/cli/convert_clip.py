"""Convert an OpenAI CLIP checkpoint (.pt) into the weights file the port's
CLIs read (`--clip-params`): the JAX package's `save_params_npz` format,
which either package loads (counterpart of excel_tpu/cli/convert_clip.py).

    python -m excel_tpu_torch.cli.convert_clip ViT-B-16.pt clip_vit_b16.npz

The checkpoint may be a `torch.jit` archive (as OpenAI publishes them) or a
plain state dict. A one-time conversion on the host; it needs no GPU.
"""
from __future__ import annotations

import argparse
import zipfile

import numpy as np
import torch


def load_torch_state_dict(path: str) -> dict:
    """{name: float32 numpy array} of a jit archive's or a saved state
    dict's tensors (a {"state_dict": ...} wrapper is unwrapped)."""
    obj = torch.jit.load(path, map_location="cpu").state_dict() \
        if _is_jit_archive(path) else torch.load(path, map_location="cpu",
                                                 weights_only=True)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: np.asarray(v.float().numpy() if hasattr(v, "numpy") else v)
            for k, v in obj.items()}


def _is_jit_archive(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith("constants.pkl") for n in z.namelist())
    except zipfile.BadZipFile:
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="OpenAI CLIP .pt (jit archive or state dict)")
    ap.add_argument("dst", help="output .npz")
    args = ap.parse_args(argv)

    from ..models.params import (convert_torch_state_dict, infer_clip_config,
                                 save_npz_tree)

    sd = load_torch_state_dict(args.src)
    sd = {k: v for k, v in sd.items()
          if not k.startswith("input_resolution")
          and k not in ("context_length", "vocab_size")}
    cfg = infer_clip_config(sd)
    print(f"detected: vision {cfg.vision_layers}x{cfg.vision_width} "
          f"patch {cfg.patch_size}, text {cfg.text_layers}x{cfg.text_width}, "
          f"embed {cfg.embed_dim}")
    save_npz_tree(args.dst, convert_torch_state_dict(sd, cfg))
    print(f"saved -> {args.dst}")
    return cfg


if __name__ == "__main__":
    main()
