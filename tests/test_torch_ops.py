"""Port ops against the JAX ops on the same numpy inputs, in fp32.

Tolerance: atol 1e-5 (fp32 arithmetic in another order) unless stated;
NMS indices and masks must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.ops import bbox as jbbox
from groma_tpu.ops.msda import (
    ms_deform_attn_dense as j_msda,
    sampling_locations_from_reference as j_sampling)
from groma_tpu.ops.nms import nms as j_nms
from groma_tpu.ops.roi_align import roi_align_batched as j_roi
from groma_tpu_torch.ops import bbox as tbbox
from groma_tpu_torch.ops.msda import (
    ms_deform_attn_dense as t_msda,
    sampling_locations_from_reference as t_sampling)
from groma_tpu_torch.ops.nms import nms as t_nms
from groma_tpu_torch.ops.roi_align import roi_align_batched as t_roi

torch.set_num_threads(2)
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes_xyxy(rng, n, spread=1.0):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(0.05, 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_bbox_ops(rng):
    cxcywh = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    np.testing.assert_allclose(tbbox.cxcywh_to_xyxy(_t(cxcywh)).numpy(),
                               np.asarray(jbbox.cxcywh_to_xyxy(cxcywh)),
                               atol=ATOL)
    a, b = _boxes_xyxy(rng, 6), _boxes_xyxy(rng, 9)
    np.testing.assert_allclose(tbbox.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jbbox.box_iou(a, b)), atol=ATOL)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 20), [0.0, 1.0, 1e-7]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(tbbox.inverse_sigmoid(_t(x)).numpy(),
                               np.asarray(jbbox.inverse_sigmoid(x)),
                               atol=ATOL)


def _nms_case(rng, name):
    n = 30
    boxes = _boxes_xyxy(rng, n, spread=0.6)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = None
    max_num = 10
    if name == 'ties':            # equal scores and duplicated boxes
        scores = np.round(scores * 4) / 4
        boxes[5:10] = boxes[0]
        scores[5:10] = scores[0]
    elif name == 'valid':
        valid = rng.uniform(0, 1, n) > 0.3
    elif name == 'capacity_exceeds_pool':
        boxes, scores, max_num = boxes[:5], scores[:5], 8
    elif name == 'none_survive':
        scores = scores * 0.1
    return boxes, scores.astype(np.float32), valid, max_num


@pytest.mark.parametrize('name', ['random', 'ties', 'valid',
                                  'capacity_exceeds_pool', 'none_survive'])
def test_nms_matches_jax(rng, name):
    boxes, scores, valid, max_num = _nms_case(rng, name)
    kw = dict(iou_threshold=0.5, score_threshold=0.15, max_num=max_num)
    j_idx, j_mask = j_nms(boxes, scores, valid=valid, **kw)
    t_idx, t_mask = t_nms(_t(boxes), _t(scores),
                          valid=None if valid is None else _t(valid), **kw)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_nms_batched_matches_per_image(rng):
    cases = [_nms_case(rng, 'random') for _ in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    t_idx, t_mask = t_nms(_t(boxes), _t(scores), 0.5, 0.15, max_num=10)
    for i in range(3):
        j_idx, j_mask = j_nms(boxes[i], scores[i], 0.5, 0.15, max_num=10)
        np.testing.assert_array_equal(t_idx[i].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_mask[i].numpy(), np.asarray(j_mask))


@pytest.mark.parametrize('aligned', [True, False])
def test_roi_align_batched_matches_jax(rng, aligned):
    feats = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    # in-map, partly outside, and the negative-extent rois the cxcywh quirk
    # produces (x2 < x1)
    boxes = rng.uniform(-4, 24, (2, 7, 4)).astype(np.float32)
    kw = dict(output_size=4, spatial_scale=0.5, sampling_ratio=2,
              aligned=aligned)
    want = np.asarray(j_roi(feats, boxes, roi_chunk=3, **kw))
    got = t_roi(_t(feats), _t(boxes), roi_chunk=3, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize('ref_dim', [2, 4])
def test_msda_dense_matches_jax(rng, ref_dim):
    b, q, nh, d, npts = 2, 6, 2, 4, 3
    shapes = ((4, 5), (2, 3))
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    ref = rng.uniform(0, 1, (b, q, len(shapes), ref_dim)).astype(np.float32)
    offsets = rng.standard_normal(
        (b, q, nh, len(shapes), npts, 2)).astype(np.float32)
    logits = rng.standard_normal((b, q, nh, len(shapes), npts))
    attn = np.exp(logits) / np.exp(logits).sum((-1, -2), keepdims=True)
    attn = attn.astype(np.float32)

    j_loc = np.asarray(j_sampling(jnp.asarray(ref), jnp.asarray(offsets),
                                  shapes, npts))
    t_loc = t_sampling(_t(ref), _t(offsets), shapes, npts).numpy()
    np.testing.assert_allclose(t_loc, j_loc, atol=ATOL)

    want = np.asarray(j_msda(value, shapes, j_loc, attn))
    got = t_msda(_t(value), shapes, _t(j_loc), _t(attn)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
