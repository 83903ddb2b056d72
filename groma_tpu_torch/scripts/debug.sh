#!/bin/bash
# The PyTorch/CUDA port's copy of scripts/debug.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# Tiny smoke run (reference: scripts/debug.sh 0.001-epoch single-GPU).
python -m groma_tpu_torch.train.train_vl \
    --llm checkpoints/vicuna-7b-v1.5 \
    --perceiver checkpoints/ddetr_box \
    --dataset_config groma_tpu_torch/data/configs/vl_pretrain.py \
    --freeze_perceiver True --freeze_llm True \
    --num_train_epochs 0.001 \
    --per_device_train_batch_size 2 \
    --learning_rate 1e-4 \
    --output_dir ./checkpoints/debug
