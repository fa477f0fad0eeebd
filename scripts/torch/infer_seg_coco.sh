#!/usr/bin/env bash
# The port's reference-style wrapper (cf. scripts/infer_seg_coco.sh and the reference's infer_seg_coco.sh);
# it runs on the card unless the extra arguments say --device cpu:
#   bash scripts/torch/infer_seg_coco.sh <data_root> <work_dir> <head.npz> [extra...]
set -eu
data_root=${1:?data root}; work_dir=${2:?work dir}; head=${3:?head npz}
shift 3
exec python -m excel_tpu_torch.cli.infer_seg --dataset coco --data-root "$data_root" \
    --clip-params assets/clip_vit_b16.npz --work-dir "$work_dir" --head "$head" --fast "$@"
