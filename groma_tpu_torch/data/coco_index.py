"""Minimal COCO-JSON index.

Replaces the vendored pycocotools/mmdet ``COCO`` API surface Groma uses
(reference: mmdet/datasets/api_wrappers/coco_api.py:11,
mmdet/datasets/coco.py:23 load_annotations) — pure python/json, no native
dependency, loads once into dicts.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs: Dict[int, dict] = {im['id']: im for im in d.get('images', [])}
        self.anns: Dict[int, dict] = {a['id']: a for a in d.get('annotations', [])}
        self.cats: Dict[int, dict] = {c['id']: c for c in d.get('categories', [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in d.get('annotations', []):
            self.img_to_anns[a['image_id']].append(a)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def get_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def get_cat_ids(self) -> List[int]:
        return list(self.cats.keys())
