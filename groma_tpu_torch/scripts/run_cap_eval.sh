#!/usr/bin/env bash
# The PyTorch/CUDA port's copy of scripts/run_cap_eval.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# One-command region-captioning readiness kit: HF checkpoint directory
# -> CIDEr / BLEU / METEOR / ROUGE_L on a region-description split
# (reference: groma/eval/model_vg.py + model_refcocog.py generation and
# eval_cap.py scoring; BASELINE.md VG/RefCOCOg caption rows).
#
# Usage:
#   groma_tpu_torch/scripts/run_cap_eval.sh <ckpt_dir> <data_root> [limit]
#
# <data_root> layout:
#   annotations/region_cap.json  (COCO-format; each image has ONE
#     annotation: its refer 'bbox' + ground-truth 'caption')
#   images/                      (VG or COCO images by file_name)
# [limit] evaluates only the first N images (smoke mode).
set -u
CKPT=${1:?usage: run_cap_eval.sh <ckpt_dir> <data_root> [limit]}
DATA=${2:?usage: run_cap_eval.sh <ckpt_dir> <data_root> [limit]}
LIMIT=${3:-0}
HERE=$(cd "$(dirname "$0")/../.." && pwd)
OUT=${CAP_OUT:-/tmp/groma_cap_eval}
mkdir -p "$OUT"

ANN="$DATA/annotations/region_cap.json"
[ -f "$ANN" ] || { echo "SKIP: $ANN not found"; exit 1; }

PYTHONPATH="$HERE:${PYTHONPATH:-}" python -m groma_tpu_torch.eval.region_cap \
  --model-dir "$CKPT" --img-prefix "$DATA/images" \
  --ann-file "$ANN" --result-dir "$OUT/shards" --limit "$LIMIT" \
  ${CAP_TOKENIZER:+--tokenizer "$CAP_TOKENIZER"} \
  | tee "$OUT/cap.log"
