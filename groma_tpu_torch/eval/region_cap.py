"""Region-captioning evaluation, Visual Genome / RefCOCOg style
(counterpart of ``groma_tpu/eval/region_cap.py``).

    python -m groma_tpu_torch.eval.region_cap --model-dir <groma ckpt> \\
        --img-prefix <images> --ann-file region_cap.json --result-dir OUT
    python -m groma_tpu_torch.eval.region_cap --model-dir tiny \\
        --tokenizer stub --img-prefix <dir> --ann-file <json> \\
        --result-dir OUT --device cpu

The reference generates a caption for each referred box and writes a JSON
shard per rank (model_vg.py, model_refcocog.py), then merges the shards and
scores them (eval_cap.py).  Here the unquantized model's ``Generator``
captions each image's first annotation box, fed as the refer box; each
process of a ``torchrun`` group takes every world-th image from its rank
(``parallel.mesh.rank_and_world``: rank 0 of 1 without a group) and writes
``captions_rank{rank}.json``; rank 0 merges the shards and scores them
with ``eval/cap.py`` (CIDEr-D, BLEU, METEOR, ROUGE-L) against the
annotations' captions.  ``--model-dir tiny`` / ``random`` and
``--tokenizer stub`` run the drill without a checkpoint, as ``eval_rec``
does.  It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable

import numpy as np

from groma_tpu_torch.constants import DEFAULT_TOKENS
from groma_tpu_torch.data.conversation import conv_templates
from groma_tpu_torch.data.datasets.base import VLDataSpec, intro_conversation
from groma_tpu_torch.data.tokenization import expand_template
from groma_tpu_torch.eval.cap import score_captions

T = DEFAULT_TOKENS

REGION_CAP_EVAL_INSTRUCTION = 'Please give a concise description of region {}.'


def build_region_cap_prompt(tokenizer, spec: VLDataSpec,
                            conv_temp: str = 'llava'):
    """The refer-box prompt, <roi><refer_box></roi><refer_feat>."""
    conv = conv_templates[conv_temp]
    messages = intro_conversation(conv)
    refer = T['bor'] + T['rbox'] + T['eor'] + T['rfeat']
    messages.append((conv.roles[0],
                     REGION_CAP_EVAL_INSTRUCTION.format(refer)))
    messages.append((conv.roles[1], None))
    ids = tokenizer.encode(conv.get_prompt(messages))
    return expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                           spec.max_region_num, spec.max_seq_len)


def generate_region_captions(generator, samples: Iterable[dict],
                             tokenizer, spec: VLDataSpec,
                             shard_dir: str, max_new_tokens: int = 48,
                             rank: int = 0) -> str:
    """``samples``: dicts with 'image' (normalized), 'sample_id' and
    'refer_box' (normalized cxcywh).  Greedy captions from ``generator``
    (``eval.generate.Generator``), written as this rank's JSON shard;
    returns its path."""
    sp = tokenizer.sp
    t = build_region_cap_prompt(tokenizer, spec)
    results = []
    for s in samples:
        rb = np.asarray(s['refer_box'], np.float32).reshape(1, 1, 4)
        tokens, _ = generator.generate(
            s['image'][None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None], refer_boxes=rb,
            refer_valid=np.ones((1, 1), bool),
            max_new_tokens=max_new_tokens, eos_id=sp.eos)
        text = tokenizer.decode([int(tok) for tok in tokens[0]
                                 if tok != sp.eos])
        results.append({'sample_id': s['sample_id'], 'caption': text})
    os.makedirs(shard_dir, exist_ok=True)
    path = os.path.join(shard_dir, f'captions_rank{rank}.json')
    with open(path, 'w') as f:
        json.dump(results, f)
    return path


def merge_and_score(shard_dir: str, references: dict) -> dict:
    """Every rank's shard merged and scored against ``references``
    ({sample id: caption or [captions]})."""
    candidates = {}
    for path in sorted(glob.glob(os.path.join(shard_dir,
                                              'captions_rank*.json'))):
        with open(path) as f:
            for r in json.load(f):
                candidates[str(r['sample_id'])] = r['caption']
    refs = {str(k): (v if isinstance(v, list) else [v])
            for k, v in references.items() if str(k) in candidates}
    candidates = {k: v for k, v in candidates.items() if k in refs}
    return score_captions(candidates, refs)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model-dir', required=True,
                    help="checkpoint directory, or 'tiny' / 'random'")
    ap.add_argument('--img-prefix', required=True)
    ap.add_argument('--ann-file', required=True)
    ap.add_argument('--result-dir', required=True)
    ap.add_argument('--tokenizer', default=None)
    ap.add_argument('--limit', type=int, default=0)
    ap.add_argument('--max-new-tokens', type=int, default=48)
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Caption each image's first annotation box and score the captions
    against the annotations' (or the image's) 'caption' field."""
    args = parse_args(argv)

    import torch.distributed as dist

    from groma_tpu_torch.checkpoint.loader import (load_unquantized,
                                                   resolve_device)
    from groma_tpu_torch.data.coco_index import CocoIndex
    from groma_tpu_torch.data.image_pipeline import (load_image, normalize,
                                                     resize,
                                                     xyxy_to_norm_cxcywh)
    from groma_tpu_torch.data.tokenizer import StubTokenizer, load_tokenizer
    from groma_tpu_torch.eval.generate import Generator
    from groma_tpu_torch.parallel.mesh import init_distributed, rank_and_world

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
    gen = Generator(model, max_len=cfg.max_seq_len + 16)

    coco = CocoIndex(args.ann_file)
    img_ids = coco.get_img_ids()
    if args.limit:
        img_ids = img_ids[:args.limit]
    rank, world = rank_and_world()

    def samples():
        for iid in img_ids[rank::world]:
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
            rb = xyxy_to_norm_cxcywh(box * scale,
                                     (spec.image_size, spec.image_size))
            yield {'image': normalize(sized), 'sample_id': iid,
                   'refer_box': rb[0]}

    generate_region_captions(gen, samples(), tokenizer, spec,
                             args.result_dir,
                             max_new_tokens=args.max_new_tokens, rank=rank)
    if world > 1:
        dist.barrier()          # every shard written before the merge
    if rank != 0:
        return None
    # references: the annotation's region description, else the image's
    refs = {}
    for iid in img_ids:
        anns = coco.get_anns(iid)
        cap = (anns[0].get('caption') if anns else None) \
            or coco.load_img(iid).get('caption')
        if cap:
            refs[iid] = [cap]
    scores = merge_and_score(args.result_dir, refs)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == '__main__':
    main()
