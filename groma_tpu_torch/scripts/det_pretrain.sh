#!/bin/bash
# The PyTorch/CUDA port's copy of scripts/det_pretrain.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# Stage 1: detection pretraining (reference: scripts/det_pretrain.sh).
# One process on one card; across cards, run the same module under
# torchrun --nproc_per_node N (train_det.py).
DINO_PATH=$1
OUTPUT_DIR=$2
mkdir -p $OUTPUT_DIR
python -m groma_tpu_torch.train.train_det \
    --vis_encoder $DINO_PATH \
    --dataset_config groma_tpu_torch/data/configs/det_pretrain.py \
    --num_classes 1 \
    --num_queries 300 \
    --num_feature_levels 1 \
    --num_train_epochs 12 \
    --learning_rate 2e-4 \
    --weight_decay 1e-4 \
    --max_grad_norm 1.0 \
    --warmup_steps 100 \
    --logging_steps 100 \
    --per_device_train_batch_size 64 \
    --save_strategy epoch \
    --output_dir $OUTPUT_DIR \
    | tee $OUTPUT_DIR/train.log
