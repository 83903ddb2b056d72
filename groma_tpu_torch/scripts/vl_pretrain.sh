#!/bin/bash
# The PyTorch/CUDA port's copy of scripts/vl_pretrain.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# Stage 2: vision-language alignment pretraining
# (reference: scripts/vl_pretrain.sh: freeze perceiver+llm, lr 1e-4).
LLM_PATH=$1
PERCEIVER_PATH=$2
OUTPUT_DIR=$3
mkdir -p $OUTPUT_DIR
python -m groma_tpu_torch.train.train_vl \
    --llm $LLM_PATH \
    --perceiver $PERCEIVER_PATH \
    --dataset_config groma_tpu_torch/data/configs/vl_pretrain.py \
    --freeze_perceiver True \
    --freeze_llm True \
    --num_train_epochs 2 \
    --per_device_train_batch_size 16 \
    --gradient_accumulation_steps 1 \
    --learning_rate 1e-4 \
    --warmup_ratio 0.03 \
    --model_max_length 2048 \
    --save_steps 2500 \
    --box_score_thres 0.15 \
    --output_dir $OUTPUT_DIR \
    | tee $OUTPUT_DIR/train.log
