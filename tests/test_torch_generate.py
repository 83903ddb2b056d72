"""The whole slice: JAX ``QuantGenerator(kv_bits=8)`` against the port's on
the same weights, image and prompt; then the port's CLI and worker.

Greedy tokens and ``selected_mask`` must be identical, ``selected_boxes``
within 1e-5 (fp32 through the vision tower).  ``box_score_thres=0.0``
lets NMS keep several boxes; at the default 0.15 random weights leave
only the fallback box.  The region-captioning case feeds a user box
(refer-box matching and the refer-feature scatter) and decodes over the
bf16 KV cache (``kv_bits=16``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.data.tokenizer import StubTokenizer
from groma_tpu.eval.generate_quant import QuantGenerator as JGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.eval.region_cap import build_region_cap_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quantize_groma_llm)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def params():
    cfg = tiny_groma_config()
    model = JGroma(cfg)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(cfg)))()['params']
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize('box_score_thres,task,kv_bits', [
    (0.15, 'rec', 8), (0.0, 'rec', 8), (0.0, 'region_cap', 16)])
def test_quant_generator_matches_jax(params, box_score_thres, task,
                                     kv_bits):
    cfg = tiny_groma_config(box_score_thres=box_score_thres)
    tok = StubTokenizer(base_vocab=cfg.llm.vocab_size)
    spec = VLDataSpec(
        num_image_tokens=cfg.num_image_tokens,
        max_region_num=cfg.max_region_num, max_seq_len=cfg.max_seq_len,
        image_size=cfg.perceiver.image_size)
    kw = dict(max_new_tokens=8, eos_id=tok.sp.eos)
    if task == 'rec':
        t = build_rec_prompt('the dog', tok, spec)
    else:
        t = build_region_cap_prompt(tok, spec)
        kw.update(refer_boxes=np.asarray([[[0.4, 0.5, 0.3, 0.4]]],
                                         np.float32),
                  refer_valid=np.ones((1, 1), bool))
    image = np.random.default_rng(0).standard_normal(
        (1, 56, 56, 3)).astype(np.float32)
    args = (image, t['input_ids'][None], t['region_slot'][None],
            t['valid'][None])
    max_len = cfg.max_seq_len + 64

    jmodel = JGroma(cfg)
    jgen = JGenerator(jmodel, params, j_quantize(params, cfg),
                      max_len=max_len, kv_bits=kv_bits)
    j_tokens, j_vis = jgen.generate(
        *[jnp.asarray(a) for a in args],
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})

    tmodel = from_jax_params(params, cfg)
    tgen = QuantGenerator(tmodel, quantize_groma_llm(tmodel, cfg),
                          max_len=max_len, kv_bits=kv_bits)
    t_tokens, t_vis = tgen.generate(*args, **kw)

    np.testing.assert_array_equal(t_tokens, j_tokens)
    np.testing.assert_array_equal(t_vis['selected_mask'],
                                  j_vis['selected_mask'])
    np.testing.assert_allclose(t_vis['selected_boxes'],
                               j_vis['selected_boxes'], atol=1e-5)
    kept = int(t_vis['selected_mask'].sum())
    assert kept == 1 if box_score_thres else kept > 1
    assert tgen.last_stats['decode_forwards'] <= kw['max_new_tokens'] - 1


def test_generate_refuses_a_decode_longer_than_the_cache(params):
    cfg = tiny_groma_config()
    tmodel = from_jax_params(params, cfg)
    gen = QuantGenerator(tmodel, quantize_groma_llm(tmodel, cfg),
                         max_len=cfg.max_seq_len + 64, kv_bits=8)
    b = _dummy_batch(cfg)
    with pytest.raises(ValueError, match='does not fit the KV cache'):
        gen.generate(np.asarray(b['images']), np.asarray(b['input_ids']),
                     np.asarray(b['region_slot']),
                     np.asarray(b['base_valid']), max_new_tokens=66)


def test_run_groma_cli_tiny(tmp_path, capsys):
    from PIL import Image
    from groma_tpu_torch.eval import run_groma
    img = (np.random.default_rng(0).uniform(0, 255, (60, 80, 3))
           .astype(np.uint8))
    path = tmp_path / 'img.png'
    Image.fromarray(img).save(path)
    tokens, vis = run_groma.main([
        '--tiny', '--image-file', str(path), '--query', 'Locate the dog.',
        '--quant_type', 'int8', '--kv-bits', '8', '--max-new-tokens', '6',
        '--device', 'cpu', '--output-image', str(tmp_path / 'out.jpg')])
    assert tokens.shape[0] == 1 and 1 <= tokens.shape[1] <= 6
    assert vis['selected_mask'].any()
    assert capsys.readouterr().out.strip()


def test_worker_generate_stream():
    from groma_tpu_torch.serve.worker import ModelWorker
    worker = ModelWorker('tiny', device='cpu')
    rng = np.random.default_rng(0)
    for prompt in ('Locate the dog in the image.', 'What is this?'):
        frames = list(worker.generate_stream({
            'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
            'prompt': prompt, 'max_new_tokens': 12, 'stream_chunk': 4}))
        assert all(f['error_code'] == 0 for f in frames)
        assert len(frames) >= 2 and 'boxes' in frames[-1]
    # a request the cache cannot hold fails cleanly; the worker goes on
    frames = list(worker.generate_stream({
        'image': np.zeros((56, 56, 3), np.float32), 'prompt': 'x',
        'max_new_tokens': 256}))
    assert frames[-1]['error_code'] == 1
    assert 'KV cache' in frames[-1]['text']
    assert worker.status()['queue_length'] == 0
