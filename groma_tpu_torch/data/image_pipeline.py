"""Host-side image + box pipeline, numpy.

Replaces the mmdet pipeline stack Groma uses (reference:
mmdet/datasets/pipelines/transforms.py Resize/RandomCrop/RandomFlip/
Normalize/Pad and the custom filters at loading.py:604,648) with plain
numpy transforms emitting NHWC float32 at a fixed 448x448 — the device
graph never sees a dynamic image shape.  A C++ fast path (native/) can be
swapped in for decode+resize; this module is the reference implementation
and fallback.  PIL is imported by the functions that use it; a PNG
decodes without it (``decode_png``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import struct
import zlib

import numpy as np

# ImageNet statistics in 0-255 scale (reference: refcoco_rec.py:38-41)
IMAGENET_MEAN = np.array([0.485 * 255, 0.456 * 255, 0.406 * 255], np.float32)
IMAGENET_STD = np.array([0.229 * 255, 0.224 * 255, 0.225 * 255], np.float32)


def load_image(path: str) -> np.ndarray:
    """RGB uint8 HWC: through PIL, or where PIL is not installed, a PNG
    through ``decode_png``."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, 'rb') as f:
            return decode_png(f.read())
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # color type -> samples a pixel


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline filters (None, Sub, Up, Average, Paeth) undone."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(
            np.int32)
        if kind == 2:
            line = (line + prev) & 255
        elif kind in (1, 3, 4):
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                line[x] = (line[x] + pred) & 255
        elif kind != 0:
            raise ValueError(f'PNG filter type {kind}')
        out[y] = line
        prev = line
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced PNG of 8-bit samples (gray, gray + alpha, RGB or
    RGBA) -> RGB uint8 (H, W, 3), with the standard library and numpy."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG (PIL is not installed to read others)')
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + n
    if header is None:
        raise ValueError('a PNG without its IHDR chunk')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in PNG_CHANNELS:
        raise ValueError(f'PNG of bit depth {depth}, color type {color}, '
                         f'interlace {interlace} is not read without PIL')
    ch = PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def resize(img: np.ndarray, size: Tuple[int, int],
           boxes: Optional[np.ndarray] = None):
    """Bilinear resize to (h, w), keep_ratio=False; boxes xyxy scaled.

    cv2 INTER_LINEAR semantics (the reference's mmcv/mmdet Resize uses
    cv2), served by the C++ fast path when built (data/native_ops.py).
    Float inputs fall back to PIL."""
    h, w = img.shape[:2]
    oh, ow = size
    if img.dtype == np.uint8:
        from groma_tpu_torch.data.native_ops import resize_bilinear
        out = resize_bilinear(img, (oh, ow))
    else:
        from PIL import Image
        out = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                     Image.BILINEAR))
    if boxes is None:
        return out, None
    scale = np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
    return out, boxes * scale


def resize_pil_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize — the raw-JSON datasets (GRIT / LLaVA /
    Groma-Instruct) resize through PIL Image.resize whose default filter is
    bicubic (reference: groma/data/datasets/llava.py:85, grit.py:105,
    groma.py:96)."""
    from PIL import Image
    oh, ow = size
    return np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))


def resize_keep_ratio(img: np.ndarray, scale: Tuple[int, int],
                      boxes: Optional[np.ndarray] = None):
    """mmdet 'Resize keep_ratio=True' semantics: fit within max(scale),
    short side toward min(scale)."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    oh, ow = int(h * f + 0.5), int(w * f + 0.5)
    return resize(img, (oh, ow), boxes)


def random_crop(img: np.ndarray, crop_size: Tuple[int, int],
                boxes: np.ndarray, labels: np.ndarray,
                rng: np.random.Generator):
    """mmdet RandomCrop: random window, shift+clip boxes, drop empty."""
    h, w = img.shape[:2]
    ch, cw = min(crop_size[0], h), min(crop_size[1], w)
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    img = img[y0:y0 + ch, x0:x0 + cw]
    if boxes.size:
        boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, labels = boxes[keep], labels[keep]
    return img, boxes, labels


def random_flip(img: np.ndarray, boxes: Optional[np.ndarray],
                prob: float, rng: np.random.Generator):
    if prob <= 0 or rng.random() >= prob:
        return img, boxes, False
    img = img[:, ::-1]
    if boxes is not None and boxes.size:
        w = img.shape[1]
        flipped = boxes.copy()
        flipped[:, 0] = w - boxes[:, 2]
        flipped[:, 2] = w - boxes[:, 0]
        boxes = flipped
    return img, boxes, True


def normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def filter_boxes_wh(boxes: np.ndarray, labels, min_wh=(2.0, 2.0)):
    """FilterAnnotationsFlickr min_gt_bbox_wh (reference:
    mmdet/datasets/pipelines/loading.py:648)."""
    if boxes.size == 0:
        return boxes, labels
    keep = ((boxes[:, 2] - boxes[:, 0]) >= min_wh[0]) \
        & ((boxes[:, 3] - boxes[:, 1]) >= min_wh[1])
    labels = [l for l, k in zip(labels, keep) if k] \
        if isinstance(labels, list) else labels[keep]
    return boxes[keep], labels


def filter_boxes_area(boxes: np.ndarray, labels, min_area, max_area):
    """CustomFilterAnnotations area window — SA1B keeps areas in
    [14², 400²] (reference: groma/data/datasets/det_data.py +
    mmdet/datasets/pipelines/loading.py:604)."""
    if boxes.size == 0:
        return boxes, labels
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = (area >= min_area) & (area <= max_area)
    labels = labels[keep] if not isinstance(labels, list) \
        else [l for l, k in zip(labels, keep) if k]
    return boxes[keep], labels


def xyxy_to_norm_cxcywh(boxes: np.ndarray, img_hw) -> np.ndarray:
    """(reference: groma/data/datasets/det_data.py:8-13)."""
    h, w = img_hw
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    bw = (boxes[:, 2] - boxes[:, 0]) / w
    bh = (boxes[:, 3] - boxes[:, 1]) / h
    return np.stack([cx, cy, bw, bh], -1).clip(0.0, 1.0).astype(np.float32)


@dataclass
class VLPipeline:
    """The standard VL-stage pipeline: resize 448², optional flip,
    normalize (reference: refcoco_rec.py:43-67)."""
    image_size: int = 448
    flip_prob: float = 0.0
    min_gt_wh: Tuple[float, float] = (2.0, 2.0)

    def __call__(self, img: np.ndarray, boxes: Optional[np.ndarray],
                 labels, rng: np.random.Generator):
        size = (self.image_size, self.image_size)
        img, boxes = resize(img, size, boxes)
        if boxes is not None:
            boxes, labels = filter_boxes_wh(boxes, labels, self.min_gt_wh)
        img, boxes, _ = random_flip(img, boxes, self.flip_prob, rng)
        return normalize(img), boxes, labels


@dataclass
class DetPipeline:
    """Det-pretrain pipeline: multiscale keep-ratio resize -> RandomCrop
    (448, 896) -> resize 448² -> area filter -> flip -> normalize
    (reference: groma/data/datasets/det_data.py:16-155 train_pipeline)."""
    image_size: int = 448
    scales: Tuple[Tuple[int, int], ...] = (
        (400, 4200), (500, 4200), (600, 4200))
    crop: Tuple[int, int] = (448, 896)
    flip_prob: float = 0.5
    area_filter: Optional[Tuple[float, float]] = None   # SA1B: (14², 400²)

    def __call__(self, img: np.ndarray, boxes: np.ndarray,
                 labels: np.ndarray, rng: np.random.Generator):
        scale = self.scales[rng.integers(len(self.scales))]
        img, boxes = resize_keep_ratio(img, scale, boxes)
        img, boxes, labels = random_crop(img, self.crop, boxes, labels, rng)
        img, boxes = resize(img, (self.image_size, self.image_size), boxes)
        if self.area_filter is not None:
            boxes, labels = filter_boxes_area(boxes, labels,
                                              *self.area_filter)
        img, boxes, _ = random_flip(img, boxes, self.flip_prob, rng)
        return normalize(img), boxes, labels
