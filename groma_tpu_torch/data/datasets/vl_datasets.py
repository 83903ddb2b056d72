"""VL-stage conversation datasets.

Each class reproduces one reference dataset's prompt/answer construction
and supervision masking exactly (instruction strings are prompt-parity
constants), on top of the shared numpy pipeline + fixed-shape finalization:

* RefCOCO        (reference: groma/data/datasets/refcoco_rec.py:22-217)
* Flickr30k      (reference: groma/data/datasets/flickr.py:25-272)
* SingleRoundVG / MultiRoundsVG
                 (reference: groma/data/datasets/visual_genome.py:23-332)
* RefCOCOCap     (reference: groma/data/datasets/refcoco_cap.py:21-214)
* COCODet        (reference: groma/data/datasets/coco.py:22-150)
* Grit           (reference: groma/data/datasets/grit.py:25-112)
* LLaVAInstruct  (reference: groma/data/datasets/llava.py:11-87)
* GromaInstruct  (reference: groma/data/datasets/groma.py:14-99)
* LVISDet        (reference: groma/data/datasets/lvis.py:22-157)
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

import numpy as np

from groma_tpu_torch.constants import DEFAULT_TOKENS
from groma_tpu_torch.data.coco_index import CocoIndex
from groma_tpu_torch.data.datasets.base import (ConversationDatasetMixin,
                                          VLDataSpec)
from groma_tpu_torch.data.image_pipeline import (VLPipeline, load_image,
                                           xyxy_to_norm_cxcywh)

T = DEFAULT_TOKENS

REC_INSTRUCTIONS = [
    "Locate {} in the image.",
    "Can you spot {} in the photograph?",
    "Identify where {} is located in the picture.",
    "Please detect {} in the picture.",
    "Which region matches the description {}?",
    "Please identify the object that corresponds to {}.",
]

CAPTION_INSTRUCTIONS = [
    "Give me a concise description of the image.",
    "Please briefly summarize the content of this image.",
    "What does this picture show? Please summarize briefly.",
    "Can you give me a quick overview of what's depicted in this image?",
    "Could you describe the key elements in this photograph?",
    "Offer a brief explanation of what this image represents.",
    "Sum up the contents of this picture in one or two sentences.",
]

REGION_CAP_INSTRUCTIONS = [
    "What is {}?",
    "Please briefly describe {}.",
    "Provide a short description for {}.",
    "Please give a concise description of region {}.",
]

DET_INSTRUCTIONS = [
    "Locate all {} in this image.",
    "Identify all instances of {} in the photo.",
    "Find all instances of {} in the image.",
    "Point out all the {} visible in this picture.",
    "Detect and list each {} that appears in this photo.",
    "What is the position of each {} in the image?",
]


def _refexp(text: str) -> str:
    return T['boe'] + text + T['eoe']


def _ground_answer(num_boxes: int) -> str:
    return (T['sep'] + T['bor'] + T['gbox'] * num_boxes + T['eor']
            + T['sep'])


def _refer_phrase() -> str:
    return T['bor'] + T['rbox'] + T['eor'] + T['rfeat']


class CocoVLBase(ConversationDatasetMixin):
    """COCO-JSON-backed dataset with the standard 448² pipeline."""

    def __init__(self, ann_file, img_prefix, tokenizer, conv_temp='default',
                 spec: Optional[VLDataSpec] = None, test_mode=False,
                 seed=0):
        self._setup(tokenizer, conv_temp, spec or VLDataSpec(), seed)
        self.coco = CocoIndex(ann_file)
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.pipeline = VLPipeline(image_size=self.spec.image_size)
        self.img_ids = [i for i in self.coco.get_img_ids()
                        if self.coco.get_anns(i)
                        and min(self.coco.load_img(i).get('width', 1e9),
                                self.coco.load_img(i).get('height', 1e9))
                        >= 32]

    def __len__(self):
        return len(self.img_ids)

    def _load(self, idx):
        """image (normalized), boxes xyxy in 448-space, raw anns, info,
        and the per-sample RNG pair."""
        rng, pyrng = self.sample_rngs(idx)
        info = self.coco.load_img(self.img_ids[idx])
        img = load_image(os.path.join(self.img_prefix, info['file_name']))
        anns = [a for a in self.coco.get_anns(self.img_ids[idx])
                if not a.get('ignore', False) and a.get('area', 1) > 0]
        boxes, kept = [], []
        for a in anns:
            x, y, w, h = a['bbox']
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            kept.append(a)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        img, boxes, kept = self.pipeline(img, boxes, kept, rng)
        return img, boxes, kept, info, pyrng


class RefCOCO(CocoVLBase):
    """REC: locate <p>expr</p> -> <roi><ground_box></roi>."""
    source = 'refcoco'

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        expr = info['caption']
        norm = xyxy_to_norm_cxcywh(boxes, img.shape[:2])
        instruct = pyrng.choice(REC_INSTRUCTIONS).format(
            _refexp(expr.strip()))
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], _ground_answer(len(norm)))]
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=norm)


class RefCOCOCap(CocoVLBase):
    """Region captioning on RefCOCOg: refer box -> caption."""
    source = 'refcocog_cap'

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        caption = info['caption']
        norm = xyxy_to_norm_cxcywh(boxes, img.shape[:2])
        instruct = pyrng.choice(REGION_CAP_INSTRUCTIONS).format(
            _refer_phrase())
        answer = (T['sep'] + caption.strip().lower().capitalize()
                  + T['sep'])
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], answer)]
        return self.build_sample(rounds, img, self.source,
                                 refer_boxes=norm[:1])


class Flickr30k(CocoVLBase):
    """Grounded captioning: rewrite the caption with
    <p>phrase</p><roi><ground_box>*n</roi> per entity span."""
    source = 'flickr30k'

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        caption = info['caption']
        # per-annotation tokens_positive spans; one box per span occurrence
        spans, span_boxes = [], []
        for a, b in zip(anns, boxes):
            for tp in a.get('tokens_positive', []):
                spans.append(tuple(tp))
                span_boxes.append(b)
        if not spans:
            spans, span_boxes = [(0, 0)], [boxes[0] if len(boxes)
                                           else np.zeros(4, np.float32)]
        order = sorted(range(len(spans)), key=lambda k: spans[k][0])
        spans = [spans[i] for i in order]
        span_boxes = np.asarray([span_boxes[i] for i in order], np.float32)
        norm = xyxy_to_norm_cxcywh(span_boxes, img.shape[:2])

        cnt = defaultdict(int)
        for s in spans:
            cnt[s] += 1
        new_caption, end = '', 0
        for i, s in enumerate(spans):
            if i > 0 and s == spans[i - 1]:
                continue
            start, e = s
            prev_end = 0 if i == 0 else spans[i - 1][1]
            piece = _refexp(caption[start:e]) \
                + T['bor'] + T['gbox'] * cnt[s] + T['eor']
            new_caption += caption[prev_end:start] + piece
            end = e
        new_caption += caption[end:]

        instruct = T['ground'] + pyrng.choice(CAPTION_INSTRUCTIONS)
        answer = T['sep'] + new_caption.strip() + T['sep']
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], answer)]
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=norm)


class SingleRoundVG(CocoVLBase):
    """Region captioning: refer box -> short description."""
    source = 'vg'

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        if len(boxes) == 0:
            return self.__getitem__((idx + 1) % len(self))
        k = int(pyrng.randrange(len(boxes)))
        caption = anns[k].get('caption', '')
        norm = xyxy_to_norm_cxcywh(boxes[k:k + 1], img.shape[:2])
        instruct = pyrng.choice(REGION_CAP_INSTRUCTIONS).format(
            _refer_phrase())
        answer = (T['sep'] + caption.strip().lower().capitalize()
                  + T['sep'])
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], answer)]
        return self.build_sample(rounds, img, self.source,
                                 refer_boxes=norm)


class MultiRoundsVG(CocoVLBase):
    """Chained region-caption QA rounds over NMS-deduped regions
    (reference: visual_genome.py:246-294, random-score nms 0.6,
    max 10 regions)."""
    source = 'vg'
    max_gt_per_img = 10

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        if len(boxes) == 0:
            return self.__getitem__((idx + 1) % len(self))
        # random-score NMS dedup
        keep = self._rand_nms(boxes, 0.6, pyrng)[:self.max_gt_per_img]
        norm = xyxy_to_norm_cxcywh(boxes[keep], img.shape[:2])
        rounds = []
        for k in keep:
            caption = anns[k].get('caption', '')
            instruct = pyrng.choice(REGION_CAP_INSTRUCTIONS).format(
                _refer_phrase())
            answer = (T['sep'] + caption.strip().lower().capitalize()
                      + T['sep'])
            rounds.append((self.conv_temp.roles[0], instruct))
            rounds.append((self.conv_temp.roles[1], answer))
        return self.build_sample(rounds, img, self.source,
                                 refer_boxes=norm)

    def _rand_nms(self, boxes, thr, pyrng):
        scores = np.asarray([pyrng.random() for _ in range(len(boxes))])
        order = np.argsort(-scores)
        kept = []
        for i in order:
            ok = True
            for j in kept:
                if _iou(boxes[i], boxes[j]) > thr:
                    ok = False
                    break
            if ok:
                kept.append(i)
        return kept


def _iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return inter / ua if ua > 0 else 0.0


class COCODet(CocoVLBase):
    """Class-REC: pick one category, ground all of its instances."""
    source = 'coco'

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cat_names = {cid: c['name'] for cid, c in self.coco.cats.items()}

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        if len(boxes) == 0:
            return self.__getitem__((idx + 1) % len(self))
        label2box = defaultdict(list)
        for a, b in zip(anns, boxes):
            name = self.cat_names.get(a.get('category_id'), 'object')
            label2box[name].append(b)
        label = pyrng.choice(list(label2box.keys()))
        sel = np.asarray(label2box[label], np.float32)
        norm = xyxy_to_norm_cxcywh(sel, img.shape[:2])
        instruct = pyrng.choice(DET_INSTRUCTIONS).format(
            _refexp(label))
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], _ground_answer(len(norm)))]
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=norm)


class LVISDet(CocoVLBase):
    """LVIS grounding (used by eval_lvis): one category per round."""
    source = 'lvis'

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cat_names = {
            cid: c['name'].replace('_', ' ').strip().lower()
            for cid, c in self.coco.cats.items()}

    def __getitem__(self, idx):
        img, boxes, anns, info, pyrng = self._load(idx)
        if len(boxes) == 0:
            return self.__getitem__((idx + 1) % len(self))
        label2box = defaultdict(list)
        for a, b in zip(anns, boxes):
            label2box[self.cat_names.get(a.get('category_id'),
                                         'object')].append(b)
        label = pyrng.choice(list(label2box.keys()))
        sel = np.asarray(label2box[label], np.float32)
        norm = xyxy_to_norm_cxcywh(sel, img.shape[:2])
        instruct = pyrng.choice(DET_INSTRUCTIONS).format(
            _refexp(label))
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], _ground_answer(len(norm)))]
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=norm)


class Grit(ConversationDatasetMixin):
    """GRIT-20M referring-expression grounding from raw JSON; unreadable
    images retry with a random resample (reference: grit.py:104-108)."""
    source = 'grit'

    def __init__(self, ann_file, img_prefix, tokenizer, conv_temp='default',
                 spec: Optional[VLDataSpec] = None, seed=0):
        self._setup(tokenizer, conv_temp, spec or VLDataSpec(), seed)
        with open(ann_file) as f:
            self.meta_data = json.load(f)
        self.img_prefix = img_prefix

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, idx):
        item = self.meta_data[idx]
        _, pyrng = self.sample_rngs(idx)
        try:
            img = load_image(os.path.join(self.img_prefix,
                                          item['filename']))
        except Exception:
            return self.__getitem__(pyrng.randrange(len(self)))
        from groma_tpu_torch.data.image_pipeline import (normalize,
                                                   resize_pil_bicubic)
        img = normalize(resize_pil_bicubic(img, (self.spec.image_size,) * 2))

        template = pyrng.choice(item['ref_exps'])
        caption = item['caption']
        label = caption[int(template[0]):int(template[1])]
        boxes = [template[2:6]]
        for r in item['ref_exps']:
            if r[:2] == template[:2] and r != template:
                boxes.append(r[2:6])
        boxes = np.asarray(boxes, np.float32)       # already normalized xyxy
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        norm = np.stack([cx, cy, boxes[:, 2] - boxes[:, 0],
                         boxes[:, 3] - boxes[:, 1]], -1)

        instruct = pyrng.choice(REC_INSTRUCTIONS).format(
            _refexp(label.strip()))
        rounds = [(self.conv_temp.roles[0], instruct),
                  (self.conv_temp.roles[1], _ground_answer(len(norm)))]
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=norm)


class LLaVAInstruct(ConversationDatasetMixin):
    """Plain VQA/caption conversations, no boxes."""
    source = 'llava'

    def __init__(self, ann_file, img_prefix, tokenizer, conv_temp='default',
                 spec: Optional[VLDataSpec] = None, seed=0):
        self._setup(tokenizer, conv_temp, spec or VLDataSpec(), seed)
        with open(ann_file) as f:
            self.meta_data = json.load(f)
        self.img_prefix = img_prefix

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, idx):
        from groma_tpu_torch.data.image_pipeline import (normalize,
                                                   resize_pil_bicubic)
        item = self.meta_data[idx]
        img = load_image(os.path.join(self.img_prefix, item['image'])) \
            if 'image' in item else np.zeros(
                (self.spec.image_size, self.spec.image_size, 3), np.uint8)
        img = normalize(resize_pil_bicubic(img, (self.spec.image_size,) * 2))
        rounds = []
        convs = item['conversations']
        assert len(convs) % 2 == 0
        for i, c in enumerate(convs):
            chat = c['value'].replace('<image>', '').replace('\n', ' ')
            if i % 2 == 1:
                chat = T['sep'] + chat + T['sep']
            rounds.append((self.conv_temp.roles[i % 2], chat))
        return self.build_sample(rounds, img, self.source)


class GromaInstruct(ConversationDatasetMixin):
    """GPT-4V grounded conversations: per-turn box_inds -> ground boxes,
    [grounding] prefix on user turns."""
    source = 'groma_instruct'

    def __init__(self, ann_file, img_prefix, tokenizer, conv_temp='default',
                 spec: Optional[VLDataSpec] = None, seed=0):
        self._setup(tokenizer, conv_temp, spec or VLDataSpec(), seed)
        with open(ann_file) as f:
            self.meta_data = json.load(f)
        self.img_prefix = img_prefix

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, idx):
        from groma_tpu_torch.data.image_pipeline import (normalize,
                                                   resize_pil_bicubic)
        item = self.meta_data[idx]
        img = load_image(os.path.join(self.img_prefix, item['file_name']))
        img = normalize(resize_pil_bicubic(img, (self.spec.image_size,) * 2))

        bx = np.asarray(item['boxes'], np.float32)     # xywh pixels
        cxcywh = np.stack([bx[:, 0] + bx[:, 2] / 2, bx[:, 1] + bx[:, 3] / 2,
                           bx[:, 2], bx[:, 3]], -1)
        scale = np.array([item['width'], item['height'],
                          item['width'], item['height']], np.float32)
        norm = (cxcywh / scale).clip(0, 1)

        rounds, ground = [], []
        convs = item['conversation']
        assert len(convs) % 2 == 0
        for i, c in enumerate(convs):
            chat = c['value']
            if i % 2 == 0:
                chat = T['ground'] + chat
            else:
                chat = T['sep'] + chat + T['sep']
                ground.extend(norm[j] for j in c['box_inds'])
            rounds.append((self.conv_temp.roles[i % 2], chat))
        ground = np.asarray(ground, np.float32).reshape(-1, 4)
        return self.build_sample(rounds, img, self.source,
                                 ground_boxes=ground)
