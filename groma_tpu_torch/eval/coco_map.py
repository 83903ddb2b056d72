"""COCO-style mAP/AR evaluation in pure numpy (a copy of
``groma_tpu/eval/coco_map.py``).

Replaces the pycocotools/lvis dependency of the reference's eval stack
(reference: groma/eval/eval_lvis.py:1-45 CustomLVISEval; pycocotools is a
C extension unavailable here).  Implements the full COCOeval protocol:

* greedy per-(image, category) matching at IoU 0.5:0.05:0.95, dets in
  descending-score order, each det taking the best still-available GT,
* **crowd semantics**: crowd GTs use intersection-over-det-area IoU
  (maskUtils.iou iscrowd flag), may be matched by multiple dets, and
  matches to them are *ignored* (neither TP nor FP),
* **area-range buckets** (all/small/medium/large): GTs outside the range
  are ignore-matched; unmatched dets outside the range are dropped from
  scoring,
* maxDets truncation per (image, category),
* 101-point interpolated precision with the monotone envelope,
* LVIS rare/common/frequent frequency buckets on top.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}


def _iou_matrix(dets: np.ndarray, gts: np.ndarray,
                iscrowd: np.ndarray) -> np.ndarray:
    """xyxy IoU (D, G); crowd GTs use intersection / det-area
    (pycocotools maskUtils.iou iscrowd semantics)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    x1 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    y1 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    x2 = np.minimum(dets[:, None, 2], gts[None, :, 2])
    y2 = np.minimum(dets[:, None, 3], gts[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / union, 0.0)


def _match_img(dboxes, dareas, gboxes, gcrowd, gig):
    """COCOeval evaluateImg matching for one (image, category, areaRng).

    dets already score-sorted + maxDets-truncated; gig marks GTs to
    ignore (crowd or out-of-area).  Returns (dtm, dtig): (T, D) matched
    flag and ignore flag per det per IoU threshold.
    """
    T, D, G = len(IOU_THRS), len(dboxes), len(gboxes)
    dtm = np.zeros((T, D), bool)
    dtig = np.zeros((T, D), bool)
    if G == 0:
        return dtm, dtig
    # gts sorted ignore-last (pycocotools: np.argsort of _ignore)
    gorder = np.argsort(gig, kind='stable')
    gboxes, gcrowd, gig = gboxes[gorder], gcrowd[gorder], gig[gorder]
    iou = _iou_matrix(dboxes, gboxes, gcrowd)
    for t, thr in enumerate(IOU_THRS):
        gtm = np.zeros(G, bool)
        for d in range(D):
            best = min(thr, 1.0 - 1e-10)
            m = -1
            for g in range(G):
                # already matched, and not a (re-matchable) crowd
                if gtm[g] and not gcrowd[g]:
                    continue
                # matched to a real GT already; stop at ignored GTs
                if m > -1 and not gig[m] and gig[g]:
                    break
                if iou[d, g] < best:
                    continue
                best = iou[d, g]
                m = g
            if m == -1:
                continue
            gtm[m] = True
            dtm[t, d] = True
            dtig[t, d] = gig[m]
    return dtm, dtig


class DetectionEvaluator:
    """Accumulate detections/GT per image+category, compute AP/AR.

    detections: dicts {image_id, category_id, bbox xyxy, score}
    ground truth: dicts {image_id, category_id, bbox xyxy,
                         (iscrowd), (area)}
    """

    def __init__(self, max_dets: int = 100,
                 cat_frequencies: Optional[Dict[int, str]] = None):
        self.max_dets = max_dets
        self.cat_freq = cat_frequencies or {}
        self.dets = defaultdict(list)
        self.gts = defaultdict(list)

    def add_ground_truth(self, image_id, category_id, bbox,
                         iscrowd: bool = False,
                         area: Optional[float] = None):
        b = np.asarray(bbox, float)
        if area is None:
            area = float((b[2] - b[0]) * (b[3] - b[1]))
        self.gts[(image_id, category_id)].append((b, bool(iscrowd),
                                                  float(area)))

    def add_detection(self, image_id, category_id, bbox, score):
        self.dets[(image_id, category_id)].append(
            (float(score), np.asarray(bbox, float)))

    def _per_category(self, cat_ids, area_rng):
        """Per category: score-sorted (matched, ignored) across images."""
        lo, hi = area_rng
        out = {}
        for cat in cat_ids:
            scores, dtms, dtigs, n_gt = [], [], [], 0
            # sorted image order: pycocotools concatenates evalImgs in
            # (sorted) imgIds order, which fixes the tie order of equal
            # scores under the stable argsort below
            img_ids = sorted({i for (i, c) in list(self.gts)
                              + list(self.dets) if c == cat})
            for img in img_ids:
                gt = self.gts.get((img, cat), [])
                gboxes = np.asarray([g[0] for g in gt],
                                    float).reshape(-1, 4)
                gcrowd = np.asarray([g[1] for g in gt], bool)
                gareas = np.asarray([g[2] for g in gt], float)
                gig = gcrowd | (gareas < lo) | (gareas > hi)
                n_gt += int((~gig).sum())

                det = sorted(self.dets.get((img, cat), []),
                             key=lambda x: -x[0])[:self.max_dets]
                if not det:
                    continue
                dboxes = np.stack([d[1] for d in det])
                dscores = np.array([d[0] for d in det])
                dareas = ((dboxes[:, 2] - dboxes[:, 0])
                          * (dboxes[:, 3] - dboxes[:, 1]))
                dtm, dtig = _match_img(dboxes, dareas, gboxes, gcrowd, gig)
                # unmatched dets outside the area range are ignored
                out_rng = (dareas < lo) | (dareas > hi)
                dtig = dtig | (~dtm & out_rng[None, :])
                scores.append(dscores)
                dtms.append(dtm)
                dtigs.append(dtig)
            if scores:
                sc = np.concatenate(scores)
                order = np.argsort(-sc, kind='stable')
                out[cat] = (np.concatenate(dtms, axis=1)[:, order],
                            np.concatenate(dtigs, axis=1)[:, order], n_gt)
            else:
                z = np.zeros((len(IOU_THRS), 0), bool)
                out[cat] = (z, z, n_gt)
        return out

    @staticmethod
    def _ap_from_matches(dtm: np.ndarray, dtig: np.ndarray,
                         n_gt: int) -> np.ndarray:
        """(T, D) matched/ignored flags sorted by score -> per-thr AP."""
        if n_gt == 0:
            return np.full(len(IOU_THRS), np.nan)
        aps = np.zeros(len(IOU_THRS))
        for t in range(len(IOU_THRS)):
            keep = ~dtig[t]
            tp = np.cumsum(dtm[t][keep])
            fp = np.cumsum(~dtm[t][keep])
            nd = len(tp)
            if nd == 0:
                continue
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-9)
            # monotone precision envelope
            for i in range(nd - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            idx = np.searchsorted(recall, RECALL_THRS, side='left')
            prec_at = np.where(idx < nd, precision[np.minimum(idx, nd - 1)],
                               0.0)
            aps[t] = prec_at.mean()
        return aps

    def _mean_ap(self, cat_ids, area_rng):
        per_cat = self._per_category(cat_ids, area_rng)
        vals = []
        for cat in cat_ids:
            dtm, dtig, n_gt = per_cat[cat]
            aps = self._ap_from_matches(dtm, dtig, n_gt)
            if not np.isnan(aps).any():
                vals.append(aps.mean())
        # pycocotools reports -1 when a bucket has no ground truth
        return float(np.mean(vals)) if vals else -1.0

    def summarize(self) -> dict:
        cat_ids = sorted({c for (_, c) in list(self.gts) + list(self.dets)})
        per_cat = self._per_category(cat_ids, AREA_RNGS['all'])
        ap_all, ap50, ar_all = [], [], []
        bucket_ap = defaultdict(list)
        for cat in cat_ids:
            dtm, dtig, n_gt = per_cat[cat]
            aps = self._ap_from_matches(dtm, dtig, n_gt)
            if np.isnan(aps).any():
                continue
            ap_all.append(aps.mean())
            ap50.append(aps[0])
            if n_gt > 0:
                recall = ((dtm & ~dtig).sum(axis=1) / n_gt).mean()
                ar_all.append(recall)
            freq = self.cat_freq.get(cat)
            if freq:
                bucket_ap[freq].append(aps.mean())
        res = {
            'AP': float(np.mean(ap_all)) if ap_all else 0.0,
            'AP50': float(np.mean(ap50)) if ap50 else 0.0,
            'AR': float(np.mean(ar_all)) if ar_all else 0.0,
            'AP_small': self._mean_ap(cat_ids, AREA_RNGS['small']),
            'AP_medium': self._mean_ap(cat_ids, AREA_RNGS['medium']),
            'AP_large': self._mean_ap(cat_ids, AREA_RNGS['large']),
            'num_categories': len(ap_all),
        }
        for freq in ('r', 'c', 'f'):
            if bucket_ap[freq]:
                res[f'AP_{freq}'] = float(np.mean(bucket_ap[freq]))
        return res
