#!/bin/bash
# ALPNet training/validation launcher of the PyTorch/CUDA port, on the card
# — the repo's backbone.sh with the same surface, defaults and arguments:
#   protosam_tpu_torch/backbone.sh [training|validation] [ct|mri] [LABEL_SET]
set -e

MODE=$1
MODALITY=$2
LABEL_SET=${3:-0}
MODEL_NAME=${MODEL_NAME:-'dlfcn_res101'}
INPUT_SIZE=${INPUT_SIZE:-256}
EVAL_FOLD=${EVAL_FOLD:-0}
SEED=${SEED:-1234}
SUPERPIX_SCALE=${SUPERPIX_SCALE:-"MIDDLE"}

case $MODALITY in
    ct)  DATASET='SABS_Superpix';  SUPP_ID='[6]' ;;
    mri) DATASET='CHAOST2_Superpix'; SUPP_ID='[4]' ;;
    *) echo "modality must be ct or mri"; exit 1 ;;
esac
if [ "$INPUT_SIZE" -gt 256 ]; then
    DATASET=${DATASET}'_672'
fi

# label-set -> exclude-class mapping (reference backbone.sh:53-67)
if [ "$LABEL_SET" -eq 0 ]; then
    EXCLUDE='[2, 3]'       # kidneys held out
else
    EXCLUDE='[1, 4]'       # liver/spleen held out (CHAOS ids)
fi

LOGDIR=${LOGDIR:-"./runs/backbone_${MODEL_NAME}_${MODALITY}_set${LABEL_SET}"}
mkdir -p "$LOGDIR"

if [ "$MODE" == "training" ]; then
    python3 -m protosam_tpu_torch.training with \
        "dataset=$DATASET" "modelname=$MODEL_NAME" "eval_fold=$EVAL_FOLD" \
        "exclude_cls_list=$EXCLUDE" "label_sets=$LABEL_SET" "seed=$SEED" \
        "superpix_scale=$SUPERPIX_SCALE" "path.log_dir=$LOGDIR" \
        "input_size=($INPUT_SIZE, $INPUT_SIZE)"
elif [ "$MODE" == "validation" ]; then
    python3 -m protosam_tpu_torch.validation with \
        "dataset=$DATASET" "modelname=$MODEL_NAME" "eval_fold=$EVAL_FOLD" \
        "label_sets=$LABEL_SET" "seed=$SEED" "support_idx=$SUPP_ID" \
        "path.log_dir=$LOGDIR" "input_size=($INPUT_SIZE, $INPUT_SIZE)"
else
    echo "mode must be training or validation"; exit 1
fi
