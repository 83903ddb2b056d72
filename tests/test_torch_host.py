"""The port's own copies of the JAX package's host-side modules behave like
the originals on the same seeded inputs, its direct checkpoint load equals
the old round trip through the JAX package's import and export, and its
entry points refuse to fall back to the CPU without ``--device cpu``."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

import groma_tpu.config as j_config
import groma_tpu.data.build as j_build
import groma_tpu.data.conversation as j_conversation
import groma_tpu.data.image_pipeline as j_image
import groma_tpu.data.tokenization as j_tokenization
import groma_tpu.data.tokenizer as j_tokenizer
from groma_tpu.checkpoint import hf_export as j_export
from groma_tpu.checkpoint import hf_import as j_import
from groma_tpu.checkpoint import loader as j_loader
from groma_tpu.models.groma import GromaModel as JGroma
import groma_tpu_torch.config as t_config
import groma_tpu_torch.data.build as t_build
import groma_tpu_torch.data.conversation as t_conversation
import groma_tpu_torch.data.image_pipeline as t_image
import groma_tpu_torch.data.tokenization as t_tokenization
import groma_tpu_torch.data.tokenizer as t_tokenizer
from groma_tpu_torch.checkpoint import hf_export as t_export
from groma_tpu_torch.checkpoint import loader as t_loader

POS_KEY = 'perceiver.vis_encoder.embeddings.position_embeddings'


def _assert_same(got, want):
    """Equal nested dicts / sequences of arrays and scalars."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize('name', ['GromaConfig', 'LlamaConfig', 'ViTConfig',
                                  'DDETRConfig', 'PerceiverConfig',
                                  'tiny_groma_config'])
def test_config_copies_are_equal(name):
    got, want = getattr(t_config, name)(), getattr(j_config, name)()
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    back = t_config.config_from_json(json.dumps(want.to_dict()))
    assert dataclasses.asdict(back) == dataclasses.asdict(want)


def _raw_sequence(rng, sp, n=40):
    ids = rng.integers(3, 256, n)
    ids[[5, 9]] = (sp.image, sp.region)
    ids[[20, 30]] = sp.gbox
    labels = np.where(np.arange(n) < 12, -100, ids)
    return ids, labels


def test_expand_template_and_special_ids_match(rng):
    tsp = t_tokenization.SpecialIds.from_base_vocab(256)
    jsp = j_tokenization.SpecialIds.from_base_vocab(256)
    assert dataclasses.asdict(tsp) == dataclasses.asdict(jsp)
    np.testing.assert_array_equal(tsp.box_idx_ids(), jsp.box_idx_ids())
    for _ in range(3):
        ids, labels = _raw_sequence(rng, jsp)
        _assert_same(t_tokenization.expand_template(ids, labels, tsp, 4, 8,
                                                    128),
                     j_tokenization.expand_template(ids, labels, jsp, 4, 8,
                                                    128))


@pytest.mark.parametrize('template', sorted(j_conversation.conv_templates))
def test_conversation_prompts_match(template):
    assert sorted(t_conversation.conv_templates) == \
        sorted(j_conversation.conv_templates)
    tconv = t_conversation.conv_templates[template]
    jconv = j_conversation.conv_templates[template]
    turns = ['Locate the dog.', 'It is <p>the dog</p><roi>.',
             'And the cat?', None]

    def messages(conv):           # the plain style takes bare strings
        if conv.sep_style == 'plain':
            return [m for m in turns if m]
        return [(conv.roles[i % 2], m) for i, m in enumerate(turns)]
    assert tconv.get_prompt(messages(tconv)) == \
        jconv.get_prompt(messages(jconv))


def test_stub_tokenizer_matches():
    tt = t_tokenizer.StubTokenizer(256, 128)
    jt = j_tokenizer.StubTokenizer(256, 128)
    for text in ('Locate the dog in the image.', '<image> <region> x y z',
                 'a b c ' * 50):
        ids = tt.encode(text)
        np.testing.assert_array_equal(ids, jt.encode(text))
        assert tt.decode(ids) == jt.decode(ids)


def test_collate_vl_matches(rng):
    sp = j_tokenization.SpecialIds.from_base_vocab(256)
    samples = []
    for _ in range(3):
        ids, labels = _raw_sequence(rng, sp)
        t = j_tokenization.expand_template(ids, labels, sp, 4, 8, 128)
        samples.append(dict(
            t, images=rng.standard_normal((56, 56, 3)).astype(np.float32),
            ground_boxes=rng.random((3, 4)).astype(np.float32),
            ground_valid=np.ones(3, bool),
            refer_boxes=rng.random((1, 4)).astype(np.float32),
            refer_valid=np.zeros(1, bool), source='refcoco'))
    _assert_same(t_build.collate_vl(samples), j_build.collate_vl(samples))


def test_image_resize_and_normalize_match(rng):
    img = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    boxes = np.asarray([[3, 4, 40, 50], [10, 0, 82, 60]], np.float32)
    for got, want in ((t_image.resize(img, (56, 56), boxes),
                       j_image.resize(img, (56, 56), boxes)),
                      (t_image.resize_keep_ratio(img, (40, 90), boxes),
                       j_image.resize_keep_ratio(img, (40, 90), boxes))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(t_image.normalize(img),
                                  j_image.normalize(img))
    np.testing.assert_array_equal(t_image.resize_pil_bicubic(img, (30, 40)),
                                  j_image.resize_pil_bicubic(img, (30, 40)))
    labels = np.arange(2)
    got = t_image.VLPipeline(image_size=56, flip_prob=1.0)(
        img, boxes, labels, np.random.default_rng(1))
    want = j_image.VLPipeline(image_size=56, flip_prob=1.0)(
        img, boxes, labels, np.random.default_rng(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope='module')
def jax_params():
    cfg = j_config.tiny_groma_config()
    model = JGroma(cfg)
    params = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), **j_loader._dummy_batch(cfg)))()['params']
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_export_and_config_translation_match(jax_params):
    cfg, params = jax_params
    _assert_same(t_export.export_groma(params, cfg),
                 j_export.export_groma(params, cfg))
    d = j_export.export_config(cfg)
    assert t_export.export_config(cfg) == d
    assert dataclasses.asdict(t_loader.hf_groma_config(d)) == \
        dataclasses.asdict(j_loader.hf_groma_config(d))


@pytest.mark.parametrize('grid', [None, 6], ids=['deploy_grid', 'grid6'])
def test_direct_load_equals_the_jax_round_trip(jax_params, tmp_path, grid):
    """load_groma reads the reference state dict into the port's modules
    as it is, resizing the ViT position table to the deploy grid (4 x 4 at
    the tiny config's 56 px) itself; the old path went through the JAX
    package's import (flax tree) and export.  Every tensor equal; with a
    checkpoint whose table is at a 6 x 6 grid too."""
    cfg, params = jax_params
    j_export.export_hf_dir(params, cfg, str(tmp_path))
    if grid is not None:
        sd = j_import.load_state_dict(str(tmp_path))
        c = sd[POS_KEY].shape[-1]
        sd[POS_KEY] = np.random.default_rng(5).standard_normal(
            (1, 1 + grid * grid, c)).astype(np.float32)
        j_export.save_safetensors(sd, str(tmp_path / 'model.safetensors'))
    got, got_cfg = t_loader.load_groma(str(tmp_path), device='cpu')
    jcfg = j_loader.hf_groma_config(j_import.load_config_json(str(tmp_path)))
    want_sd = j_export.export_groma(j_loader.import_groma(
        j_import.load_state_dict(str(tmp_path)), jcfg), jcfg)
    want = t_loader.from_state_dict(want_sd, got_cfg, device='cpu')
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert got_sd[POS_KEY].shape[1] == 1 + 4 * 4


# ------------------------------------------------------- device defaults

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')


def test_run_groma_refuses_the_cpu_by_default(no_card, tmp_path):
    from groma_tpu_torch.eval import run_groma
    with pytest.raises(RuntimeError, match='--device cpu'):
        run_groma.main(['--tiny', '--image-file', str(tmp_path / 'x.png'),
                        '--query', 'Locate the dog.'])


def test_cli_and_eval_rec_refuse_the_cpu_by_default(no_card, tmp_path):
    from groma_tpu_torch.eval import eval_rec
    from groma_tpu_torch.serve import cli
    with pytest.raises(RuntimeError, match='--device cpu'):
        cli.main(['--model-dir', 'tiny', '--image-file',
                  str(tmp_path / 'x.png')])
    with pytest.raises(RuntimeError, match='--device cpu'):
        eval_rec.main(['--model-dir', 'tiny', '--tokenizer', 'stub',
                       '--img-prefix', str(tmp_path), '--ann-file',
                       str(tmp_path / 'refs.json')])
    with pytest.raises(RuntimeError, match='--device cpu'):
        t_loader.load_unquantized('tiny')


def test_train_vl_refuses_the_cpu_by_default(no_card, tmp_path):
    from groma_tpu_torch.train import train_vl
    assert train_vl.parse_args(['--dataset_config', 'x', '--output_dir',
                                'o']).device == 'cuda'
    with pytest.raises(RuntimeError, match='--device cpu'):
        train_vl.main(['--model_name_or_path', str(tmp_path),
                       '--dataset_config', 'x', '--output_dir',
                       str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()


def test_worker_refuses_the_cpu_by_default(no_card, monkeypatch):
    from groma_tpu_torch.serve import worker
    with pytest.raises(RuntimeError, match='--device cpu'):
        worker.ModelWorker('tiny')
    monkeypatch.setattr(sys, 'argv', ['worker', '--tiny'])
    with pytest.raises(RuntimeError, match='--device cpu'):
        worker.main()
    with pytest.raises(RuntimeError, match='--device cpu'):
        t_loader.load_quantized('tiny')
    assert t_loader.resolve_device('cpu') == 'cpu'


# ------------------------------------------- detection-stage host copies

@pytest.mark.parametrize('name', ['det_pretrain', 'vl_pretrain',
                                  'vl_finetune'])
def test_dataset_config_copies_match(name):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = j_build.load_config(os.path.join(repo, 'groma_tpu', 'data',
                                            'configs', f'{name}.py'))
    got = t_build.load_config(os.path.join(repo, 'groma_tpu_torch', 'data',
                                           'configs', f'{name}.py'))
    assert got == want and got['datasets']


def test_logging_copy_matches(tmp_path, capsys):
    import logging

    import groma_tpu.utils.logging as j_logging
    import groma_tpu_torch.utils.logging as t_logging
    records = {}
    for name, mod in (('jax', j_logging), ('port', t_logging)):
        logger = mod.build_logger(f'{name}_log', f'{name}.log',
                                  str(tmp_path / name))
        seen = []

        class Keep(logging.Handler):
            def emit(self, record, _seen=seen):
                _seen.append((record.levelno, record.getMessage()))
        logger.addHandler(Keep())
        stream = mod.StreamToLogger(logger, logging.WARNING)
        stream.write('first line\nsecond ')
        stream.write('half\n\ntail')
        stream.flush()
        assert not stream.isatty()
        assert mod.is_main_process()
        mod.print0('rank zero speaks', name)
        records[name] = seen
        assert (tmp_path / name / f'{name}.log').exists()
    assert records['port'] == records['jax'] == [
        (logging.WARNING, 'first line'), (logging.WARNING, 'second half'),
        (logging.WARNING, 'tail')]
    assert capsys.readouterr().out.splitlines()[-2:] == [
        'rank zero speaks jax', 'rank zero speaks port']
