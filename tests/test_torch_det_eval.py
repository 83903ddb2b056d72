"""The port's detector evaluation and the LVIS-Ground kit against the JAX
package's: the COCO-protocol evaluator's copy on the cases of
``tests/test_coco_map.py`` and on random scenes (summaries equal to 1e-12),
``post_process`` and ``evaluate_detector`` on JAX-initialised tiny weights
(the same summary, scores within 1e-5), ``run_ddetr`` against JAX's
``run_ddetr.main`` on one exported directory (the same kept boxes, within
1e-5), ``evaluate_lvis`` and ``eval_lvis`` on the port's ``Generator``
against JAX's (the same greedy tokens, predictions and summary), and the
entry points' refusal to run on the CPU unless asked.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_perceiver
from groma_tpu.config import tiny_groma_config
from groma_tpu.eval import coco_map as j_coco_map
from groma_tpu.eval import det_eval as j_det_eval
from groma_tpu.models.perceiver import Perceiver as JPerceiver
from groma_tpu_torch.eval import coco_map, det_eval
from groma_tpu_torch.models.perceiver import Perceiver

torch.set_num_threads(2)
PCFG = tiny_groma_config().perceiver


def _t(x):
    return torch.from_numpy(np.array(x))


# -------------------------------------------------------------- coco_map

def _crafted():
    """The scenes of tests/test_coco_map.py: (evaluator kwargs, ground
    truth (image, category, box, crowd), detections (image, category,
    box, score))."""
    sq = [0, 0, 10, 10]
    return {
        'perfect': ({}, [(1, 1, sq, False)], [(1, 1, sq, 0.9)]),
        'miss_and_fp': ({}, [(1, 1, sq, False), (2, 1, sq, False)],
                        [(1, 1, sq, 0.9), (2, 1, [50, 50, 60, 60], 0.5)]),
        'iou_sweep': ({}, [(1, 1, sq, False)], [(1, 1, [0, 0, 10, 6.8], 0.9)]),
        'freq_buckets': ({'cat_frequencies': {1: 'r', 2: 'f'}},
                         [(1, 1, sq, False), (1, 2, sq, False)],
                         [(1, 1, sq, 0.9), (1, 2, [90, 90, 99, 99], 0.9)]),
        'greedy_dup': ({}, [(1, 1, sq, False)],
                       [(1, 1, sq, 0.9), (1, 1, sq, 0.8)]),
        'crowd': ({}, [(1, 1, sq, False), (1, 1, [20, 20, 40, 40], True)],
                  [(1, 1, sq, 0.9), (1, 1, [20, 20, 30, 30], 0.8),
                   (1, 1, [22, 22, 32, 32], 0.7)]),
        'area_ranges': ({}, [(1, 1, sq, False),
                             (1, 1, [50, 50, 250, 250], False)],
                        [(1, 1, sq, 0.9), (1, 1, [50, 50, 250, 250], 0.8)]),
        'out_of_range_fp': ({}, [(1, 1, sq, False)],
                            [(1, 1, sq, 0.9),
                             (1, 1, [100, 100, 300, 300], 0.95)]),
        'max_dets_1': ({'max_dets': 1}, [(1, 1, sq, False)],
                       [(1, 1, [50, 50, 60, 60], 0.9), (1, 1, sq, 0.8)]),
        'crowd_det_area': ({}, [(1, 1, [0, 0, 100, 100], True),
                                (1, 1, [200, 200, 210, 210], False)],
                           [(1, 1, [10, 10, 20, 20], 0.9),
                            (1, 1, [200, 200, 210, 210], 0.8)]),
    }


def _random_scene(seed):
    """test_coco_map.py's differential scenes: every area bucket, crowds,
    empty cells, perturbed matches, tied scores every third seed."""
    rng = np.random.default_rng(seed)

    def rand_box():
        x1, y1 = rng.uniform(0, 300), rng.uniform(0, 300)
        return [x1, y1, x1 + rng.uniform(1, 200), y1 + rng.uniform(1, 200)]
    gts, dets = [], []
    for img in range(4):
        for cat in range(1, 4):
            for _ in range(rng.integers(0, 8)):
                gts.append((img, cat, rand_box(), bool(rng.random() < 0.15)))
            for _ in range(rng.integers(0, 12)):
                if gts and rng.random() < 0.5:
                    b = np.asarray(gts[rng.integers(0, len(gts))][2]) \
                        + rng.normal(0, 4, 4)
                    b[2], b[3] = max(b[2], b[0] + 1), max(b[3], b[1] + 1)
                else:
                    b = rand_box()
                score = float(rng.random())
                dets.append((img, cat, list(b),
                             round(score, 1) if seed % 3 == 0 else score))
    return ({'max_dets': 5 if seed % 2 else 100}, gts, dets)


SCENES = {**_crafted(), **{f'random{s}': s for s in range(12)}}


@pytest.mark.parametrize('name', sorted(SCENES))
def test_coco_map_copy_gives_jax_summaries(name):
    scene = SCENES[name]
    kwargs, gts, dets = _random_scene(scene) if isinstance(scene, int) \
        else scene
    summaries = []
    for mod in (j_coco_map, coco_map):
        ev = mod.DetectionEvaluator(**kwargs)
        for img, cat, box, crowd in gts:
            ev.add_ground_truth(img, cat, box, iscrowd=crowd)
        for img, cat, box, score in dets:
            ev.add_detection(img, cat, box, score)
        summaries.append(ev.summarize())
    want, got = summaries
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


# ------------------------------------------------------- detector eval

@pytest.fixture(scope='module')
def detector():
    """JAX's tiny Perceiver, its params, and the port's on them."""
    jmodel = JPerceiver(PCFG)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), np.zeros((1, 56, 56, 3), np.float32))[
            'params'])
    sd = export_perceiver(params, PCFG.vit.num_layers,
                          PCFG.ddetr.encoder_layers, PCFG.ddetr.decoder_layers,
                          PCFG.ddetr.num_feature_levels,
                          patch_size=PCFG.vit.patch_size)
    model = Perceiver(PCFG)
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return jmodel, params, model.eval(), sd


def test_post_process_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (2, 7, 2)),
                            rng.uniform(0.1, 0.3, (2, 7, 2))], -1).astype(
        np.float32)
    sizes = np.array([[100, 200], [56, 64]])
    want = j_det_eval.post_process(jnp.asarray(logits), jnp.asarray(boxes),
                                   jnp.asarray(sizes), threshold=0.5,
                                   top_k=10)
    got = det_eval.post_process(_t(logits), _t(boxes), _t(sizes),
                                threshold=0.5, top_k=10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4)
    batch = det_eval.collate_det_eval([
        {'images': np.zeros((4, 4, 3)), 'ori_shape': (10, 20, 3)}] * 2)
    assert batch['images'].shape == (2, 4, 4, 3)
    assert batch['ori_shapes'].tolist() == [[10, 20], [10, 20]]


def test_evaluate_detector_matches_jax(detector):
    jmodel, params, model, _ = detector
    rng = np.random.default_rng(2)
    samples = []
    for i in range(3):
        gt = [(0, np.array([x, y, x + 20.0, y + 16.0]))
              for x, y in rng.uniform(0, 30, (2, 2))]
        samples.append({'images': rng.standard_normal((56, 56, 3)).astype(
            np.float32), 'image_id': i, 'ori_shape': (56, 56), 'gt': gt})
    want = j_det_eval.evaluate_detector(
        lambda p, im: jmodel.apply({'params': p}, im), params, samples,
        top_k=8)
    got = det_eval.evaluate_detector(model, samples, top_k=8)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    assert want['num_categories'] == 1


def test_run_ddetr_keeps_jax_boxes(detector, tmp_path, monkeypatch):
    """One exported directory through both demos (the perceiver_cfg
    config.json and pytorch_model.bin train_det writes), the objectness
    biases spread so that the 0.4 threshold keeps some boxes and drops
    others."""
    from PIL import Image

    import groma_tpu.eval.run_groma as j_run_groma
    from groma_tpu.eval import run_ddetr as j_run_ddetr
    from groma_tpu_torch.eval import run_ddetr
    from groma_tpu_torch.checkpoint.loader import perceiver_config_json
    from groma_tpu_torch.train.train_vl import export_weights
    _, _, model, sd = detector
    spread = Perceiver(PCFG)
    state = {k: _t(v) for k, v in sd.items()}
    rng = np.random.default_rng(3)
    for head in ('coco', 'sa1b'):
        w = f'ddetr_transformer.class_embed_{head}.1.weight'
        state[w] = _t(rng.standard_normal(tuple(state[w].shape)).astype(
            np.float32) * 2.0)
    spread.load_state_dict(state, strict=True)
    export_weights(str(tmp_path / 'det'), spread,
                   perceiver_config_json(PCFG))
    Image.fromarray(np.random.default_rng(4).integers(
        0, 255, (50, 70, 3), dtype=np.uint8)).save(tmp_path / 'img.png')
    drawn = []
    monkeypatch.setattr(j_run_groma, 'draw_boxes',
                        lambda img, boxes, path: drawn.append(
                            np.asarray(boxes)))
    monkeypatch.setattr(sys, 'argv', [
        'run_ddetr', '--model-dir', str(tmp_path / 'det'), '--image-file',
        str(tmp_path / 'img.png'), '--output-image', str(tmp_path / 'j.png')])
    j_run_ddetr.main()
    got = run_ddetr.main(['--model-dir', str(tmp_path / 'det'),
                          '--image-file', str(tmp_path / 'img.png'),
                          '--output-image', '', '--device', 'cpu'])
    want = drawn[0]
    assert 0 < len(want) < PCFG.ddetr.num_queries
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ LVIS

LCFG = tiny_groma_config(box_score_thres=0.0)


@pytest.fixture(scope='module')
def lvis_model(tmp_path_factory):
    """A tiny Groma from JAX's init, its region tokens' logits scaled up
    so that greedy decoding names regions, exported as a reference-format
    directory; JAX's model and params read back from it."""
    from groma_tpu.checkpoint.hf_export import export_hf_dir
    from groma_tpu.checkpoint.loader import _dummy_batch, load_groma
    from groma_tpu.data.tokenization import SpecialIds
    from groma_tpu.models.groma import GromaModel
    jm = GromaModel(LCFG)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jm.init(jax.random.PRNGKey(0), **_dummy_batch(LCFG)))()[
            'params'])
    sp = SpecialIds.from_base_vocab(LCFG.llm.vocab_size)
    first = sp.box_idx_start - LCFG.llm.vocab_size
    kernel = params['extra_lm_head']['kernel'].copy()
    kernel[:, first:first + LCFG.max_region_num] *= 40.0
    params['extra_lm_head']['kernel'] = kernel
    root = tmp_path_factory.mktemp('lvis')
    export_hf_dir(params, LCFG, str(root / 'model'))
    jmodel, jparams, _ = load_groma(str(root / 'model'))
    return root, jmodel, jparams


@pytest.fixture(scope='module')
def lvis_set(lvis_model):
    """A synthetic LVIS-ground set: 3 images, 2 categories with their
    frequency buckets, 1-2 boxes each."""
    from PIL import Image
    root = lvis_model[0]
    (root / 'val').mkdir()
    rng = np.random.default_rng(5)
    images, anns = [], []
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(root / 'val' / f'{i}.png')
        images.append({'id': i, 'file_name': f'{i}.png', 'width': 64,
                       'height': 48})
        for cat in (1, 2)[:1 + i % 2]:
            for _ in range(1 + (i + cat) % 2):
                x, y = rng.uniform(0, 30, 2)
                anns.append({'id': len(anns), 'image_id': i,
                             'bbox': [float(x), float(y), 24.0, 18.0],
                             'area': 432.0, 'category_id': cat,
                             'iscrowd': 0})
    with open(root / 'lvis.json', 'w') as f:
        json.dump({'images': images, 'annotations': anns, 'categories': [
            {'id': 1, 'name': 'red_ball', 'frequency': 'r'},
            {'id': 2, 'name': 'cat', 'frequency': 'f'}]}, f)
    return root


def _recording(monkeypatch, module, log):
    """Record every detection the module's evaluator scores."""
    base = module.DetectionEvaluator

    class Recording(base):
        def add_detection(self, image_id, category_id, bbox, score):
            log.append((image_id, category_id, np.asarray(bbox, float),
                        float(score)))
            super().add_detection(image_id, category_id, bbox, score)
    monkeypatch.setattr(module, 'DetectionEvaluator', Recording)


def test_evaluate_lvis_matches_jax(lvis_model, lvis_set, monkeypatch):
    import groma_tpu.eval.lvis as j_lvis
    from groma_tpu.eval.generate import Generator as JGenerator
    from groma_tpu_torch.checkpoint.loader import load_unquantized
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu_torch.eval import lvis
    from groma_tpu_torch.eval.generate import Generator
    root, jmodel, jparams = lvis_model
    spec = VLDataSpec(num_image_tokens=LCFG.num_image_tokens,
                      max_region_num=LCFG.max_region_num,
                      max_seq_len=LCFG.max_seq_len,
                      image_size=LCFG.perceiver.image_size)
    tok = StableStubTokenizer(base_vocab=LCFG.llm.vocab_size)
    rng = np.random.default_rng(6)
    samples = [{'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
                'image_id': i, 'category_id': 1 + i % 2,
                'category_name': ('red ball', 'cat')[i % 2],
                'gt_boxes': rng.uniform(0.2, 0.5, (2, 4)).astype(np.float32)}
               for i in range(4)]
    freq = {1: 'r', 2: 'f'}
    model, _ = load_unquantized(str(root / 'model'), device='cpu')
    runs = {}
    for name, module, gen in (
            ('jax', j_lvis, JGenerator(jmodel, jparams,
                                       max_len=LCFG.max_seq_len + 16)),
            ('port', lvis, Generator(model, max_len=LCFG.max_seq_len + 16))):
        preds, tokens = [], []
        _recording(monkeypatch, module, preds)
        real = gen.generate

        def generate(*a, _real=real, _tokens=tokens, **kw):
            out = _real(*a, **kw)
            _tokens.append(np.asarray(out[0]))
            return out
        gen.generate = generate
        runs[name] = (module.evaluate_lvis(gen, samples, tok, spec,
                                           cat_frequencies=freq),
                      preds, tokens)
    (want, jpreds, jtokens), (got, preds, tokens) = runs['jax'], runs['port']
    assert len(tokens) == len(jtokens) == len(samples)
    for g, w in zip(tokens, jtokens):
        np.testing.assert_array_equal(g, w)
    assert len(preds) == len(jpreds) > 0
    for (gi, gc, gb, gs), (wi, wc, wb, ws) in zip(preds, jpreds):
        assert (gi, gc, gs) == (wi, wc, ws)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)
    assert got.keys() == want.keys() and 'AP_r' in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def test_eval_lvis_cli_matches_jax(lvis_model, lvis_set, monkeypatch,
                                   capsys):
    """Both CLIs on the exported directory and the set's JSON, the stub
    tokenizer in both (one process: one word hash)."""
    from groma_tpu.eval import eval_lvis as j_eval_lvis
    from groma_tpu_torch.eval import eval_lvis
    root = lvis_set
    argv = ['--model-dir', str(root / 'model'), '--img-prefix',
            str(root / 'val'), '--ann-file', str(root / 'lvis.json'),
            '--tokenizer', 'stub']
    monkeypatch.setattr(sys, 'argv', ['eval_lvis'] + argv)
    j_eval_lvis.main()
    out = capsys.readouterr().out
    want = json.loads(out[out.index('{'):])
    got = eval_lvis.main(argv + ['--device', 'cpu'])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)


# ------------------------------------------------------- device default

def test_detection_entry_points_refuse_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    from groma_tpu_torch.eval import eval_lvis, run_ddetr
    from groma_tpu_torch.train import train_det
    with pytest.raises(RuntimeError, match='--device cpu'):
        train_det.main(['--dataset_config', str(tmp_path / 'x.py'),
                        '--output_dir', str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()
    with pytest.raises(RuntimeError, match='--device cpu'):
        run_ddetr.main(['--tiny', '--image-file', str(tmp_path / 'x.png')])
    with pytest.raises(RuntimeError, match='--device cpu'):
        eval_lvis.main(['--model-dir', 'tiny', '--img-prefix', str(tmp_path),
                        '--ann-file', str(tmp_path / 'x.json')])
