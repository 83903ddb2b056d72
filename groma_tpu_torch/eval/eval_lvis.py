"""LVIS-Ground benchmark CLI (counterpart of ``groma_tpu/eval/eval_lvis.py``).

    python -m groma_tpu_torch.eval.eval_lvis --model-dir <groma ckpt> \\
        --img-prefix <coco_val2017> --ann-file lvis_ground.json
    python -m groma_tpu_torch.eval.eval_lvis --model-dir tiny \\
        --tokenizer stub --img-prefix <dir> --ann-file <json> --device cpu

Each image's annotations grouped by category give one grounding sample
each (``eval/lvis.evaluate_lvis``, the unquantized model through
``Generator``); the LVIS frequency buckets come from the category records;
the summary prints as JSON.  Under ``torchrun`` (WORLD_SIZE > 1) each
process evaluates every WORLD_SIZE-th image from its RANK.
``--tokenizer stub`` runs the word-hash tokenizer, for a drill without a
real one.  It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', required=True,
                    help="checkpoint directory, or 'tiny' / 'random'")
    ap.add_argument('--img-prefix', required=True)
    ap.add_argument('--ann-file', required=True)
    ap.add_argument('--tokenizer', default=None)
    ap.add_argument('--limit', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch.distributed as dist

    from groma_tpu_torch.checkpoint.loader import (load_unquantized,
                                                   resolve_device)
    from groma_tpu_torch.data.coco_index import CocoIndex
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.image_pipeline import (load_image, normalize,
                                                     resize,
                                                     xyxy_to_norm_cxcywh)
    from groma_tpu_torch.data.tokenizer import StubTokenizer, load_tokenizer
    from groma_tpu_torch.eval.generate import Generator
    from groma_tpu_torch.eval.lvis import evaluate_lvis

    device = resolve_device(args.device)
    if int(os.environ.get('WORLD_SIZE', 1)) > 1 and not dist.is_initialized():
        dist.init_process_group('nccl' if device.startswith('cuda')
                                else 'gloo')
    model, cfg = load_unquantized(args.model_dir, device=device)
    if args.tokenizer == 'stub':
        tokenizer = StubTokenizer(base_vocab=cfg.llm.vocab_size,
                                  model_max_length=cfg.max_seq_len)
    else:
        tokenizer = load_tokenizer(args.tokenizer or args.model_dir,
                                   cfg.max_seq_len)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    gen = Generator(model, max_len=cfg.max_seq_len + 16)

    coco = CocoIndex(args.ann_file)
    cat_names = {cid: c['name'].replace('_', ' ').strip().lower()
                 for cid, c in coco.cats.items()}
    # LVIS frequency buckets from the category records
    cat_freq = {cid: c.get('frequency', '') for cid, c in coco.cats.items()}

    img_ids = coco.get_img_ids()
    if args.limit:
        img_ids = img_ids[:args.limit]
    if dist.is_initialized():
        img_ids = img_ids[dist.get_rank()::dist.get_world_size()]

    def samples():
        for iid in img_ids:
            info = coco.load_img(iid)
            anns = coco.get_anns(iid)
            if not anns:
                continue
            img = load_image(os.path.join(args.img_prefix,
                                          info['file_name']))
            img448, _ = resize(img, (spec.image_size,) * 2)
            norm_img = normalize(img448)
            by_cat = {}
            for a in anns:
                by_cat.setdefault(a['category_id'], []).append(a['bbox'])
            for cid, bxs in by_cat.items():
                boxes = np.asarray(
                    [[x, y, x + w, y + h] for x, y, w, h in bxs],
                    np.float32)
                scale = np.array([spec.image_size / info['width'],
                                  spec.image_size / info['height']] * 2,
                                 np.float32)
                gt = xyxy_to_norm_cxcywh(
                    boxes * scale, (spec.image_size, spec.image_size))
                yield {'image': norm_img, 'image_id': iid,
                       'category_id': cid,
                       'category_name': cat_names.get(cid, 'object'),
                       'gt_boxes': gt}

    out = evaluate_lvis(gen, samples(), tokenizer, spec,
                        cat_frequencies=cat_freq)
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
