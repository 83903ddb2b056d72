"""REC benchmark CLI (counterpart of ``groma_tpu/eval/eval_rec.py``).

    python -m groma_tpu_torch.eval.eval_rec --model-dir <groma ckpt> \\
        --img-prefix <coco_train_2017> --ann-file refcoco_val.json
    python -m groma_tpu_torch.eval.eval_rec --model-dir tiny \\
        --tokenizer stub --img-prefix <dir> --ann-file <json> --device cpu

Annotations are the RefCOCO-style COCO JSON the reference uses: one image
record per referring expression, its 'caption' the expression, the first
annotation's bbox the ground truth.  The unquantized model goes through
``Generator`` (``eval/rec.evaluate_rec``), and the metrics print as one
JSON line.  Under ``torchrun`` (WORLD_SIZE > 1) each process evaluates
every WORLD_SIZE-th image from its RANK and the metrics are summed over
the process group.  ``--tokenizer stub`` runs the word-hash tokenizer, for
a drill without a real one.  It runs on the card; ``--device cpu`` runs
it on the CPU.
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
    ap.add_argument('--limit', type=int, default=0,
                    help='evaluate only the first N samples (0 = all)')
    ap.add_argument('--batch-size', type=int, default=8)
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
    from groma_tpu_torch.eval.rec import evaluate_rec
    from groma_tpu_torch.parallel.mesh import init_distributed

    device = resolve_device(args.device)
    init_distributed(device)
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
    gen = Generator(model, max_len=cfg.max_seq_len + 8)

    coco = CocoIndex(args.ann_file)
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
            sized, _ = resize(img, (spec.image_size,) * 2)
            x, y, w, h = anns[0]['bbox']
            box = np.array([[x, y, x + w, y + h]], np.float32)
            scale = np.array([spec.image_size / info['width'],
                              spec.image_size / info['height']] * 2,
                             np.float32)
            gt = xyxy_to_norm_cxcywh(box * scale,
                                     (spec.image_size, spec.image_size))[0]
            yield {'image': normalize(sized), 'expr': info['caption'],
                   'gt_box': gt}

    out = evaluate_rec(gen, samples(), tokenizer, spec,
                       batch_size=args.batch_size)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
