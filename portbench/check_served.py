"""The comparison that decides ``correct`` in a serving cell.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed with the longest one in it, is
run through the plain reference (``portbench.reference.groma``) once
each, over its prompt and the tokens the program served.  The numbers
compared:

* ``logit_gap``: the widest gap, over every served token of the sample,
  by which the served token's reference logit lies below the reference's
  best at that position.  Greedy decoding serves the program's own
  argmax, so a sound program reads only its rounding here;
* ``nms_overlap``: kept region pairs whose IoU passes the NMS threshold,
  and kept boxes that are not finite, positive boxes inside the image
  (the region selection, which the reference follows from the program,
  checked by itself; exact, limit 0).

With ``control`` the reference also runs one precision step below the
configuration (``Precision('step-down')``: fp8 products, an int4 KV
cache) over the same prompts and tokens, and ``control_gap`` is the
widest gap of the token that those logits put first: the reading a later
change to that arithmetic would give.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import weights
from portbench.reference import groma as ref
from portbench.traffic import IMAGE, REGION

IOU_SLACK = 1e-5


def sample(records, seed: int, min_tokens: int, max_requests: int) -> list:
    """The finished requests to compare: the longest, then others in an
    order drawn from ``seed``, until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    done = [r for r in records if r.error is None and r.done]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    order = [longest] + [int(i) for i in
                         np.random.default_rng(seed).permutation(len(done))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(done[i])
        n += len(done[i].tokens)
    return out


def nms_violations(boxes: np.ndarray, mask: np.ndarray, thres: float) -> int:
    """Kept boxes (normalized cxcywh) that are malformed, plus kept pairs
    whose IoU exceeds ``thres``."""
    b = boxes[mask].astype(np.float64)
    bad = int((~np.isfinite(b).all(1) | (b[:, 2] <= 0) | (b[:, 3] <= 0)
               | (b[:, :2] < 0).any(1) | (b[:, :2] > 1).any(1)).sum())
    xy = np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], 1)
    lt = np.maximum(xy[:, None, :2], xy[None, :, :2])
    rb = np.minimum(xy[:, None, 2:], xy[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = (xy[:, 2:] - xy[:, :2]).prod(-1)
    iou = inter / np.maximum(area[:, None] + area[None] - inter, 1e-12)
    pairs = np.triu(iou > thres + IOU_SLACK, 1).sum()
    return bad + int(pairs)


def compare(spec: dict, table: list, records: list, seed: int, device,
            control: bool = False) -> dict:
    """The reference over ``records`` -> {'logit_gap', 'nms_overlap',
    'tokens', 'requests'} (and 'control_gap')."""
    m = spec['model']
    llm = m['llm']
    base = llm['vocab_size']
    vocab = base + m['num_new_token']
    dev = torch.device(device)
    ref.strict_f32()
    sides = {'f32': ref.Precision()}
    if control:
        sides['step-down'] = ref.Precision('step-down')
    overlap = sum(nms_violations(r.session.vis['selected_boxes'],
                                 r.session.vis['selected_mask'],
                                 m['nms_thres']) for r in records)
    with torch.no_grad():
        draws = weights.draw(table, seed, dev)
        _, vis_p = next(draws)
        vision = {}
        for k, r in enumerate(records):
            image = torch.as_tensor(r.req.image, device=dev)
            boxes = torch.as_tensor(r.session.vis['selected_boxes'],
                                    dtype=torch.float32, device=dev)
            mask = r.session.vis['selected_mask']
            kept = int(mask.sum())
            for name, act in sides.items():
                states = ref.vit(image, vis_p, m, act)
                img = ref.image_tokens(states, vis_p, act)
                reg = torch.zeros((len(mask), llm['hidden_size']), device=dev)
                reg[:kept] = ref.region_tokens(states, boxes[:kept], vis_p, m,
                                               act)
                vision[name, k] = (img, reg)
                del states
        _, embed_p = next(draws)
        emb_base = embed_p['llm.model.embed_tokens.weight']
        emb_new = vis_p['new_input_embs.weight']
        streams, prompts, served = {}, [], []
        for k, r in enumerate(records):
            toks = np.asarray(r.tokens, np.int64)
            if ((toks < 0) | (toks >= vocab)).any():
                return {'logit_gap': float('inf'), 'nms_overlap': overlap,
                        'tokens': len(toks), 'requests': len(records)}
            t = torch.as_tensor(toks, device=dev)
            served.append(t)
            new = t >= base
            tail = torch.where(
                new[:, None], ref._f(emb_new[(t - base).clamp(min=0)]),
                ref._f(emb_base[t.clamp(max=base - 1)]))[:-1]
            mask = torch.as_tensor(r.session.vis['selected_mask'], device=dev)
            for name in sides:
                img, reg = vision[name, k]
                head = ref.surgery(
                    torch.as_tensor(r.req.input_ids, device=dev),
                    torch.as_tensor(r.req.region_slot, device=dev).long(),
                    torch.as_tensor(r.req.valid, device=dev), mask, img, reg,
                    emb_base, emb_new, base, base + IMAGE, base + REGION)
                streams.setdefault(name, []).append(torch.cat([head, tail]))
            prompts.append(head.shape[0])
        del vision, embed_p, emb_base
        for group, layer_p in draws:
            if not group.startswith('layer.'):
                head_p = {**layer_p, 'extra_lm_head.weight':
                          vis_p['extra_lm_head.weight']}
                break
            for name, act in sides.items():
                streams[name] = ref.decoder_layer(streams[name], prompts,
                                                  layer_p, llm, act)
            del layer_p
        gaps, ctl_gaps = [], []
        for k, (p, t) in enumerate(zip(prompts, served)):
            rows = slice(p - 1, p - 1 + len(t))
            lg = ref.logits(streams['f32'][k][rows], head_p, llm,
                            sides['f32'])
            best = lg.max(-1).values
            gaps.append((best - lg.gather(1, t[:, None])[:, 0]).max().item())
            if control:
                lc = ref.logits(streams['step-down'][k][rows], head_p, llm,
                                sides['step-down'])
                pick = lc.argmax(-1)
                ctl_gaps.append(
                    (best - lg.gather(1, pick[:, None])[:, 0]).max().item())
    del streams, head_p, vis_p
    gc.collect()
    out = {'logit_gap': max(gaps) if gaps else float('inf'),
           'nms_overlap': overlap,
           'tokens': int(sum(len(t) for t in served)),
           'requests': len(records)}
    if control:
        out['control_gap'] = max(ctl_gaps)
    return out

