"""Convert a reference ExCEL checkpoint (model_iter_*.pth) into a head
`.npz` (counterpart of excel_tpu/cli/convert_head.py).

The reference's train scripts save the whole DDP-wrapped model's state
dict, `module.`-prefixed, the frozen CLIP encoder's weights included. Only
the trained LVC head (SegFormer fuse + decoder) differs from CLIP, so this
keeps that subtree and writes it in the JAX package's `save_head_npz`
layout, which the `--head` flag of both packages' CLIs reads.

    python -m excel_tpu_torch.cli.convert_head model_iter_30000.pth head.npz
    python -m excel_tpu_torch.cli.convert_head --dataset coco ckpt.pth h.npz

A one-time conversion on the host; it needs no GPU.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="reference .pth (full ExCEL_model state "
                                "dict, DDP 'module.' prefix ok)")
    ap.add_argument("dst", help="output head .npz")
    ap.add_argument("--dataset", default="voc", choices=["voc", "coco"],
                    help="head geometry preset (block/layer counts)")
    args = ap.parse_args(argv)

    from ..config import coco_config, voc_config
    from ..engine.checkpoint import save_head_npz
    from ..models.excel import convert_torch_head
    from .convert_clip import load_torch_state_dict

    sd = load_torch_state_dict(args.src)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    cfg = coco_config() if args.dataset == "coco" else voc_config()
    head = convert_torch_head(sd, cfg)
    save_head_npz(args.dst, head)
    n = sum(v.size for v in sd.values())
    kept = sum(p.numel() for p in head.parameters())
    print(f"wrote {args.dst}: {kept:,} head params "
          f"(of {n:,} in the checkpoint; frozen CLIP weights dropped)")
    return head


if __name__ == "__main__":
    main()
