#!/usr/bin/env bash
# The port's reference-style wrapper (cf. scripts/run_train.sh and the reference's run_train.sh);
# it runs on the card unless the extra arguments say --device cpu:
#   bash scripts/torch/run_train.sh <dataset voc|coco> <data_root> <work_dir> [extra args...]
set -eu
dataset=${1:?dataset (voc|coco)}; data_root=${2:?data root}; work_dir=${3:?work dir}
shift 3
exec python -m excel_tpu_torch.cli.train --dataset "$dataset" --data-root "$data_root" \
    --clip-params assets/clip_vit_b16.npz --work-dir "$work_dir" --fast "$@"
