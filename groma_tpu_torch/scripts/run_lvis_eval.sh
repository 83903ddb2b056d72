#!/usr/bin/env bash
# The PyTorch/CUDA port's copy of scripts/run_lvis_eval.sh: the same flags, the
# port's module and dataset configs; it runs on the card.
# One-command LVIS-Ground readiness kit: HF checkpoint directory ->
# AP / AP-rare / AP-common / AP-frequent on the LVIS grounding split
# (reference: groma/eval/eval_lvis.py protocol; BASELINE.md row).
#
# Usage:
#   groma_tpu_torch/scripts/run_lvis_eval.sh <ckpt_dir> <data_root> [limit]
#
# <data_root> layout:
#   annotations/lvis_ground.json  (COCO-format; categories carry the
#                                  LVIS 'frequency' field r/c/f)
#   val2017/                      (COCO val2017 images)
# [limit] evaluates only the first N images (smoke mode).
set -u
CKPT=${1:?usage: run_lvis_eval.sh <ckpt_dir> <data_root> [limit]}
DATA=${2:?usage: run_lvis_eval.sh <ckpt_dir> <data_root> [limit]}
LIMIT=${3:-0}
HERE=$(cd "$(dirname "$0")/../.." && pwd)
OUT=${LVIS_OUT:-/tmp/groma_lvis_eval}
mkdir -p "$OUT"

ANN="$DATA/annotations/lvis_ground.json"
[ -f "$ANN" ] || { echo "SKIP: $ANN not found"; exit 1; }

PYTHONPATH="$HERE:${PYTHONPATH:-}" python -m groma_tpu_torch.eval.eval_lvis \
  --model-dir "$CKPT" --img-prefix "$DATA/val2017" \
  --ann-file "$ANN" --limit "$LIMIT" \
  ${LVIS_TOKENIZER:+--tokenizer "$LVIS_TOKENIZER"} \
  | tee "$OUT/lvis.log"
