#!/bin/bash
# ProtoSAM inference launcher of the PyTorch/CUDA port, on the card — the
# repo's run_protosam.sh with the same surface, defaults and arguments:
#   protosam_tpu_torch/run_protosam.sh [ct|mri|polyp] [LABEL_SET]
set -e

MODEL_NAME=${MODEL_NAME:-'dinov2_l14'}      # dinov2_l14 | dinov2_l14_reg | dinov2_b14 | dinov2_g14 | dlfcn_res101
COARSE_PRED_ONLY=${COARSE_PRED_ONLY:-"False"}
PROTOSAM_SAM_VER=${PROTOSAM_SAM_VER:-"sam_h"}  # sam_h | sam_b | medsam
INPUT_SIZE=${INPUT_SIZE:-672}
ORGAN=${ORGAN:-"rk"}                        # rk | lk | liver | spleen
PROTO_GRID=8
EVAL_FOLD=${EVAL_FOLD:-0}
SEED=${SEED:-42}
DO_CCA=${DO_CCA:-"True"}
SKIP_SLICES=${SKIP_SLICES:-"True"}
LORA=${LORA:-0}
RELOAD_PATH=${RELOAD_PATH:-"None"}

MODALITY=$1
if [ "$MODALITY" != "ct" ] && [ "$MODALITY" != "mri" ] && [ "$MODALITY" != "polyp" ]; then
    echo "modality must be either ct, mri or polyp"; exit 1
fi

case $MODALITY in
    ct)   DATASET='SABS_Superpix';  SUPP_ID='[6]' ;;
    mri)  DATASET='CHAOST2_Superpix'; SUPP_ID='[4]' ;;
    polyp) DATASET='polyps'; ORGAN='polyps'; SUPP_ID='[0]' ;;
esac
if [ "$INPUT_SIZE" -gt 256 ] && [ "$MODALITY" != "polyp" ]; then
    DATASET=${DATASET}'_672'
fi

LOGDIR=${LOGDIR:-"./runs/protosam_${MODEL_NAME}_${MODALITY}"}
mkdir -p "$LOGDIR"

python3 -m protosam_tpu_torch.validation_protosam with \
    "modelname=$MODEL_NAME" \
    "base_model=alpnet" \
    "coarse_pred_only=$COARSE_PRED_ONLY" \
    "protosam_sam_ver=$PROTOSAM_SAM_VER" \
    "curr_cls=$ORGAN" \
    "reload_model_path=$RELOAD_PATH" \
    "eval_fold=$EVAL_FOLD" \
    "dataset=$DATASET" \
    "proto_grid_size=$PROTO_GRID" \
    "seed=$SEED" \
    "do_cca=$DO_CCA" \
    "skip_no_organ_slices=$SKIP_SLICES" \
    "lora=$LORA" \
    "support_idx=$SUPP_ID" \
    "path.log_dir=$LOGDIR" \
    "input_size=($INPUT_SIZE, $INPUT_SIZE)"
