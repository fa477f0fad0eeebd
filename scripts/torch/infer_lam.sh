#!/usr/bin/env bash
# The port's reference-style wrapper (cf. scripts/infer_lam.sh and the reference's infer_lam.sh);
# it runs on the card unless the extra arguments say --device cpu:
#   bash scripts/torch/infer_lam.sh <dataset> <data_root> <work_dir> [--training-free | --head head.npz] [extra...]
set -eu
dataset=${1:?dataset}; data_root=${2:?data root}; work_dir=${3:?work dir}
shift 3
exec python -m excel_tpu_torch.cli.infer_lam --dataset "$dataset" --data-root "$data_root" \
    --clip-params assets/clip_vit_b16.npz --work-dir "$work_dir" --fast "$@"
