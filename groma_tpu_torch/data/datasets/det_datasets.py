"""Detection-pretrain datasets (class-agnostic COCO / SA1B).

(reference: groma/data/datasets/det_data.py:16-155): multiscale keep-ratio
resize -> RandomCrop(448, 896) -> resize 448² -> (SA1B: area filter
[14², 400²]) -> flip -> normalize; emit normalized-cxcywh boxes with class
label 0 (class-agnostic).  Output is fixed-capacity padded targets for the
static det train step.
"""

from __future__ import annotations

import os


import numpy as np

from groma_tpu_torch.data.coco_index import CocoIndex
from groma_tpu_torch.data.image_pipeline import (DetPipeline, load_image,
                                           xyxy_to_norm_cxcywh)


class ClassAgnosticCoco:
    source = 'coco'
    area_filter = None

    def __init__(self, ann_file, img_prefix, max_boxes: int = 100,
                 image_size: int = 448, seed: int = 0, test_mode=False):
        self.coco = CocoIndex(ann_file)
        self.img_prefix = img_prefix
        self.max_boxes = max_boxes
        self.seed = seed
        self.pipeline = DetPipeline(image_size=image_size,
                                    area_filter=self.area_filter)
        self.img_ids = [i for i in self.coco.get_img_ids()
                        if self.coco.get_anns(i)]

    def __len__(self):
        return len(self.img_ids)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        info = self.coco.load_img(self.img_ids[idx])
        img = load_image(os.path.join(self.img_prefix, info['file_name']))
        boxes = []
        for a in self.coco.get_anns(self.img_ids[idx]):
            if a.get('ignore', False) or a.get('iscrowd', False):
                continue
            x, y, w, h = a['bbox']
            if w < 1 or h < 1 or a.get('area', 1) <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.zeros(len(boxes), np.int32)        # class-agnostic
        img, boxes, labels = self.pipeline(img, boxes, labels, rng)
        norm = xyxy_to_norm_cxcywh(boxes, img.shape[:2])

        cap = self.max_boxes
        out_boxes = np.zeros((cap, 4), np.float32)
        out_labels = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        n = min(len(norm), cap)
        out_boxes[:n] = norm[:n]
        valid[:n] = True
        return {
            'images': img.astype(np.float32),
            'targets': {'class_labels': out_labels, 'boxes': out_boxes,
                        'valid': valid},
            'source': self.source,
        }


class ClassAgnosticSA1B(ClassAgnosticCoco):
    """SA1B variant: keeps only mid-size boxes (area in [14², 400²] at 448²,
    reference: det_data.py CustomFilterAnnotations)."""
    source = 'sa1b'
    area_filter = (14.0 ** 2, 400.0 ** 2)
