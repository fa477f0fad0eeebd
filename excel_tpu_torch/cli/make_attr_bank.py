"""Offline TSE attribute-bank tool (counterpart of
excel_tpu/cli/make_attr_bank.py).

Encodes each class's descriptor sentences with the CLIP text tower on
`--device` (default cuda), L2-normalises them on the host, KMeans-clusters
all of them (`utils/kmeans`: what scikit-learn 1.9.0's
`KMeans(n_clusters=K, random_state=0).fit` computes, without scikit-learn)
and saves cluster_bank [embed, K] and class_flags [C, K] as .npz: the bank
that `ops/tse.load_attr_bank` reads. The bundled
assets/attributes/*_bank_*.npz came from the reference's precomputed
banks; this tool regenerates them from the descriptor JSONs (e.g. for a new
dataset or cluster count).

    python -m excel_tpu_torch.cli.make_attr_bank --dataset voc \
        --clip-params assets/clip_vit_b16.npz --out my_bank.npz
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import asset_path
from ..device import resolve_device
from ..models.clip import text_forward
from ..text.tokenizer import require_clip_tokenizer, tokenize
from ..utils.kmeans import kmeans
from .common import add_common_args, build_config, exact_matmuls, load_clip


def descriptors_from_txt(txt_path: str, class_names: list[str],
                         prompt: str = "a clean origami {}. ",
                         entries_per_cls: int = 20) -> dict:
    """Raw GPT-4 descriptor dump -> {class: [prefixed sentences]}: per
    class, skip 2 header lines, take `entries_per_cls` quoted lines, strip
    the JSON-ish quoting, prefix the prompt template."""
    with open(txt_path) as f:
        content = f.readlines()
    descriptors = {}
    index_up = 0
    for cls in class_names:
        index_low = index_up + 2
        index_up = index_low + entries_per_cls
        values = content[index_low:index_up]
        index_up += 2
        descriptors[cls] = [prompt.format(cls)
                            + item.strip('  "').strip('",\n')
                            for item in values]
    return descriptors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--descriptors", default=None,
                    help="descriptor JSON (default: bundled per dataset)")
    ap.add_argument("--from-txt", default=None,
                    help="raw GPT-4 descriptor txt dump; converted to the "
                         "descriptor JSON first (transform_txt2json.py "
                         "semantics), written next to --out")
    ap.add_argument("--clusters", type=int, default=None,
                    help="K (default: 112 VOC / 224 COCO)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    exact_matmuls()
    cfg = build_config(args)
    require_clip_tokenizer(cfg.clip.tokenizer)
    clip_params = load_clip(args, cfg, device)
    ds_name = "pascal_voc" if args.dataset == "voc" else "ms_coco"
    desc_file = args.descriptors or asset_path(
        "attributes", f"{ds_name}_descriptors.json")
    k = args.clusters or cfg.num_attr_clusters

    if args.from_txt:
        from ..text.class_names import class_list
        names = class_list(ds_name)[1:]          # drop background
        descriptions = descriptors_from_txt(args.from_txt, names)
        json_path = args.out.rsplit(".", 1)[0] + "_descriptors.json"
        with open(json_path, "w") as fp:
            json.dump(descriptions, fp, indent=4)
        print(f"converted {args.from_txt} -> {json_path}")
    else:
        with open(desc_file) as f:
            descriptions = json.load(f)

    # per-class sentence embeddings, L2-normalised on the host
    all_emb, class_idx = [], []
    with torch.no_grad():
        for ci, (class_name, sentences) in enumerate(descriptions.items()):
            tokens = torch.from_numpy(
                tokenize([s.lower() for s in sentences])).to(device)
            emb = text_forward(clip_params, tokens, cfg.clip).cpu().numpy()
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            all_emb.append(emb)
            class_idx.extend([ci] * len(sentences))
            print(f"encoded {class_name}: {emb.shape[0]} sentences")
    emb_all = np.concatenate(all_emb, axis=0)
    class_idx = np.asarray(class_idx)

    km = kmeans(emb_all, k, seed=0)

    num_classes = len(descriptions)
    flags = np.zeros((num_classes, k), np.float32)
    for ci in range(num_classes):
        flags[ci, np.unique(km.labels_[class_idx == ci])] = 1.0

    # warn on classes with identical cluster signatures
    uniq, counts = np.unique(flags, axis=0, return_counts=True)
    if not (counts == 1).all():
        print("WARNING: classes share identical cluster activations")

    np.savez(args.out, cluster_bank=km.cluster_centers_.T.astype(np.float32),
             class_flags=flags)
    print(f"saved bank [{cfg.clip.embed_dim}, {k}] + flags "
          f"[{num_classes}, {k}] -> {args.out}")


if __name__ == "__main__":
    main()
