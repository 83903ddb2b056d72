"""Detector-only visualization demo (counterpart of
``groma_tpu/eval/run_ddetr.py``; reference: groma/eval/run_ddetr.py).

    python -m groma_tpu_torch.eval.run_ddetr --model-dir PERCEIVER_DIR \\
        --image-file img.png
    python -m groma_tpu_torch.eval.run_ddetr --tiny --image-file img.png \\
        --device cpu

Runs the Perceiver on one image and draws the proposals the reference's
demo keeps: NMS at 0.8 over the fused score ``coco^0.3 * sa1b^0.7``,
kept from 0.4 (reference: run_ddetr.py:64-69; GromaModel fuses with 0.4 /
0.6, both kept where they occur).  ``--model-dir`` is a perceiver
checkpoint directory (``train_det``'s export); ``--tiny`` a random tiny
detector.  ``--output-image ''`` draws nothing (drawing takes PIL).  It
runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', default=None,
                    help='perceiver checkpoint (HF CustomDDETR format)')
    ap.add_argument('--tiny', action='store_true',
                    help='random-weight tiny detector (smoke test)')
    ap.add_argument('--image-file', required=True)
    ap.add_argument('--output-image', default='ddetr_output.jpg',
                    help="where to draw the kept boxes ('' draws nothing)")
    ap.add_argument('--nms-thres', type=float, default=0.8)
    ap.add_argument('--score-thres', type=float, default=0.4)
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    args = ap.parse_args(argv)
    if not (args.tiny or args.model_dir):
        ap.error('--model-dir or --tiny is required')

    import torch

    from groma_tpu_torch.checkpoint.loader import (load_perceiver,
                                                   random_perceiver,
                                                   resolve_device)
    from groma_tpu_torch.data.image_pipeline import (load_image, normalize,
                                                     resize)
    from groma_tpu_torch.eval.run_groma import draw_boxes
    from groma_tpu_torch.ops.bbox import cxcywh_to_xyxy
    from groma_tpu_torch.ops.nms import nms

    device = resolve_device(args.device)
    if args.tiny:
        from groma_tpu_torch.config import tiny_groma_config
        cfg = tiny_groma_config().perceiver
        model = random_perceiver(cfg, device=device).eval()
    else:
        model, cfg = load_perceiver(args.model_dir, device)

    raw = load_image(args.image_file)
    img448, _ = resize(raw, (cfg.image_size, cfg.image_size))
    img = torch.as_tensor(normalize(img448)[None], device=device)
    with torch.no_grad():
        out = model(img)
    boxes = out['pred_boxes'][0]
    s_coco = torch.sigmoid(out['logits']['coco'][0, :, 0])
    s_sa1b = torch.sigmoid(out['logits']['sa1b'][0, :, 0])
    # the demo's fusion exponents (reference: run_ddetr.py:69)
    scores = s_coco ** 0.3 * s_sa1b ** 0.7
    keep_idx, keep_mask = nms(cxcywh_to_xyxy(boxes), scores, args.nms_thres,
                              args.score_thres, max_num=100)
    kept = keep_idx[keep_mask].to(torch.int64)
    sel = boxes[kept].cpu().numpy()
    print(f'{len(sel)} boxes above threshold')
    if args.output_image:
        draw_boxes(img448, sel, args.output_image)
        print(f'wrote {args.output_image}')
    return sel


if __name__ == '__main__':
    main()
