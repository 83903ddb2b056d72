"""Single-image grounded chat on the port (counterpart of
``groma_tpu/eval/run_groma.py``): one turn on an image, the answer printed
with its ``<rK>`` tokens resolved to boxes, the boxes drawn on a copy of
the image.

    python -m groma_tpu_torch.eval.run_groma --tiny --image-file img.png \\
        --query 'Locate the dog.' --quant_type int8 --kv-bits 8

Only the int8 LLM is ported (``--quant_type int8``); the KV cache is int8
(``--kv-bits 8``, the served configuration) or bf16 (16).
"""

from __future__ import annotations

import argparse

import numpy as np


def draw_boxes(image: np.ndarray, boxes_cxcywh, path: str):
    """Draw normalized cxcywh boxes on an RGB image and save it."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(image.astype(np.uint8))
    d = ImageDraw.Draw(im)
    w, h = im.size
    for b in boxes_cxcywh:
        d.rectangle([(b[0] - b[2] / 2) * w, (b[1] - b[3] / 2) * h,
                     (b[0] + b[2] / 2) * w, (b[1] + b[3] / 2) * h],
                    outline=(255, 0, 0), width=3)
    im.save(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', default=None,
                    help='reference-format checkpoint directory')
    ap.add_argument('--tiny', action='store_true',
                    help='random-weight tiny model (pipeline smoke test)')
    ap.add_argument('--image-file', required=True)
    ap.add_argument('--query', required=True)
    ap.add_argument('--tokenizer', default=None,
                    help='HF tokenizer path (defaults to the model dir)')
    ap.add_argument('--quant_type', default='int8', choices=['int8'])
    ap.add_argument('--kv-bits', type=int, default=8, choices=[16, 8])
    ap.add_argument('--max-new-tokens', type=int, default=64)
    ap.add_argument('--device', default=None,
                    help='torch device (default: cuda if available)')
    ap.add_argument('--output-image', default='output.jpg')
    args = ap.parse_args(argv)

    import torch
    from groma_tpu.data.conversation import conv_templates
    from groma_tpu.data.datasets.base import VLDataSpec, intro_conversation
    from groma_tpu.data.image_pipeline import load_image, normalize, resize
    from groma_tpu.data.tokenization import expand_template
    from groma_tpu.data.tokenizer import StubTokenizer, load_tokenizer
    from groma_tpu_torch.checkpoint.loader import load_quantized
    from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                     parse_region_tokens)

    model_dir = 'tiny' if args.tiny else args.model_dir
    if not model_dir:
        ap.error('--model-dir or --tiny is required')
    device = args.device or ('cuda' if torch.cuda.is_available() else 'cpu')
    model, qp, cfg = load_quantized(model_dir, device=device)
    if model_dir == 'tiny':
        tokenizer = StubTokenizer(cfg.llm.vocab_size, cfg.max_seq_len)
    else:
        tokenizer = load_tokenizer(args.tokenizer or model_dir,
                                   model_max_length=cfg.max_seq_len)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)

    img_sized, _ = resize(load_image(args.image_file),
                          (spec.image_size, spec.image_size))
    img = normalize(img_sized)

    conv = conv_templates['llava']
    messages = intro_conversation(conv)
    messages.append((conv.roles[0], args.query))
    messages.append((conv.roles[1], None))
    ids = tokenizer.encode(conv.get_prompt(messages))
    t = expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                        spec.max_region_num, spec.max_seq_len)

    gen = QuantGenerator(model, qp, max_len=cfg.max_seq_len + 64,
                         kv_bits=args.kv_bits)
    tokens, vis = gen.generate(
        img[None], t['input_ids'][None], t['region_slot'][None],
        t['valid'][None], max_new_tokens=args.max_new_tokens,
        eos_id=tokenizer.sp.eos)

    print(tokenizer.decode([tok for tok in tokens[0]
                            if tok != tokenizer.sp.eos]))
    ks = parse_region_tokens(tokens, tokenizer.sp.box_idx_start)[0]
    cap = vis['selected_mask'].shape[1]
    boxes = [vis['selected_boxes'][0, k] for k in ks
             if k < cap and vis['selected_mask'][0, k]]
    if boxes:
        draw_boxes(img_sized, boxes, args.output_image)
        print(f'drew {len(boxes)} boxes -> {args.output_image}')
    return tokens, vis


if __name__ == '__main__':
    main()
