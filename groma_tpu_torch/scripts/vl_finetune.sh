#!/bin/bash
# The PyTorch/CUDA port's copy of scripts/vl_finetune.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# Stage 3: instruction finetuning (reference: scripts/vl_finetune.sh:
# unfreeze llm; FSDP across cards under torchrun, train_vl.py).
PRETRAIN_PATH=$1
OUTPUT_DIR=$2
mkdir -p $OUTPUT_DIR
python -m groma_tpu_torch.train.train_vl \
    --model_name_or_path $PRETRAIN_PATH \
    --dataset_config groma_tpu_torch/data/configs/vl_finetune.py \
    --freeze_perceiver True \
    --freeze_llm False \
    --num_train_epochs 1 \
    --per_device_train_batch_size 16 \
    --learning_rate 1e-5 \
    --warmup_ratio 0.03 \
    --model_max_length 2048 \
    --gradient_checkpointing True \
    --save_steps 2500 \
    --box_score_thres 0.15 \
    --output_dir $OUTPUT_DIR \
    | tee $OUTPUT_DIR/train.log
