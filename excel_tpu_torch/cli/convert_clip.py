"""Convert a CLIP checkpoint (.pt) in OpenAI's key layout into the weights
file the port's CLIs read (`--clip-params`): the JAX package's
`save_params_npz` format, which either package loads (counterpart of
excel_tpu/cli/convert_clip.py).

    python -m excel_tpu_torch.cli.convert_clip ViT-B-16.pt clip_vit_b16.npz
    python -m excel_tpu_torch.cli.convert_clip --backbone openclip-vit-h-14 \
        open_clip_pytorch_model.bin clip_vit_h14.npz
    python -m excel_tpu_torch.cli.convert_clip --backbone eva02-clip-l-14-336 \
        EVA02_CLIP_L_336_psz14_s6B.pt clip_eva02_l14.npz

The checkpoint may be a `torch.jit` archive (as OpenAI publishes them) or a
plain state dict (OpenCLIP's, or EVA-CLIP's with its own vision names:
`visual.blocks.i.attn.{q,k,v}_proj`, `q_bias`, `v_bias`,
`inner_attn_ln`, `mlp.{w1,w2,w3,ffn_ln}`; models/params.
convert_eva_state_dict). The head width and the activation are not in
its shapes: `--backbone` names the tower (`config.BACKBONES`), whose
widths the shapes must match; without it, OpenAI's rule (heads = width /
64, QuickGELU), and an EVA-CLIP checkpoint is refused. The CLIs take the
same name. A one-time conversion on the host; it needs no GPU.
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
    ap.add_argument("src", help="CLIP .pt / .bin (jit archive or state "
                                "dict) in OpenAI's key layout")
    ap.add_argument("dst", help="output .npz")
    ap.add_argument("--backbone", default=None,
                    help="the tower by name (heads and activation from it; "
                         "default: OpenAI's width / 64 and QuickGELU)")
    args = ap.parse_args(argv)

    from ..models.params import (convert_torch_state_dict, infer_clip_config,
                                 save_npz_tree)

    sd = load_torch_state_dict(args.src)
    sd = {k: v for k, v in sd.items()
          if not k.startswith("input_resolution")
          and k not in ("context_length", "vocab_size")}
    cfg = infer_clip_config(sd, args.backbone)
    mlp = (f"SwiGLU {cfg.hidden}, rotary q/k" if cfg.block == "eva02"
           else cfg.activation)
    print(f"detected: vision {cfg.vision_layers}x{cfg.vision_width} "
          f"({cfg.vision_heads} heads) patch {cfg.patch_size}, text "
          f"{cfg.text_layers}x{cfg.text_width} ({cfg.text_heads} heads), "
          f"embed {cfg.embed_dim}, {mlp}")
    save_npz_tree(args.dst, convert_torch_state_dict(sd, cfg))
    print(f"saved -> {args.dst}")
    return cfg


if __name__ == "__main__":
    main()
