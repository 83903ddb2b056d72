"""The port's modules against the JAX modules on the same weights.

JAX params come from ``GromaModel.init`` at ``tiny_groma_config()`` and
reach the port through ``from_jax_params`` (the JAX package's
``export_groma`` state dict, loaded strictly).  Everything is fp32;
tolerance 1e-4 (fp32 arithmetic in another order through a few layers).
The JAX int8 decode attention runs its Pallas kernel body in interpret
mode, the same order of operations as the port's kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama_quant import (make_quant_kv_cache as j_cache,
                                          quant_llama_forward as j_forward)
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                quant_llama_forward)

torch.set_num_threads(2)
TOL = 1e-4
CFG = tiny_groma_config()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope='module')
def models():
    jmodel = JGroma(CFG)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, from_jax_params(params, CFG)


def test_weight_bridge_loads_every_parameter(models):
    _, params, tmodel = models
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax


def _prompt():
    from groma_tpu.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.tokenizer import StableStubTokenizer
    from groma_tpu.eval.rec import build_rec_prompt
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    t = build_rec_prompt('the dog', tok, VLDataSpec(
        num_image_tokens=CFG.num_image_tokens,
        max_region_num=CFG.max_region_num, max_seq_len=CFG.max_seq_len,
        image_size=CFG.perceiver.image_size))
    return t['input_ids'][None], t['region_slot'][None], t['valid'][None]


def _vision_parts(m, image, ids, slot, valid, boxes):
    """Every vision-side output the tests compare, in one JAX program."""
    hidden = m.perceiver.encode_image(image)
    mlvl = [h[:, 1:] for h in hidden[-3:]]
    region = m.region_encoder(mlvl, boxes)
    return hidden, region, m.prepare_stream(image, ids, slot, valid)


@pytest.fixture(scope='module')
def vision(models):
    """(JAX outputs, port outputs) of the vision side."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(1)
    image = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    # random boxes for the region encoder, the cxcywh-as-xyxy quirk included
    boxes = rng.uniform(0.05, 0.95, (1, CFG.max_region_num, 4)).astype(
        np.float32)
    inputs = (image, *_prompt(), boxes)
    want = jax.jit(lambda p, *a: jmodel.apply(
        {'params': p}, *a, method=_vision_parts))(params, *inputs)
    want = jax.tree_util.tree_map(np.asarray, want)
    with torch.no_grad():
        got = _vision_parts(tmodel, *[_t(a) for a in inputs])
    return want, got


def test_dinov2_hidden_states(vision):
    (want, _, _), (got, _, _) = vision
    assert len(got) == len(want) == CFG.perceiver.vit.num_layers + 1
    for g, w in zip(got, want):
        _close(g, w)


def test_perceiver_ddetr_outputs(vision):
    want = vision[0][2][3]['ddetr_out']
    got = vision[1][2][3]['ddetr_out']
    for head in ('coco', 'sa1b'):
        _close(got['logits'][head], want['logits'][head])
    for key in ('pred_boxes', 'enc_outputs_class', 'enc_outputs_coord',
                'init_reference_points'):
        _close(got[key], want[key])


def test_region_tokens(vision):
    _close(vision[1][1], vision[0][1])


def test_vision_and_stream(vision):
    emb, jids, jvalid, vis = vision[0][2]
    temb, tids, tvalid, tvis = vision[1][2]
    np.testing.assert_array_equal(tvis['selected_mask'].numpy(),
                                  vis['selected_mask'])
    _close(tvis['selected_boxes'], vis['selected_boxes'], 1e-5)
    for key in ('image_tokens', 'region_tokens'):
        _close(tvis[key], vis[key])
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    _close(temb, emb)


def test_dual_head_logits(models):
    jmodel, params, tmodel = models
    hidden = np.random.default_rng(4).standard_normal(
        (2, 3, CFG.llm.hidden_size)).astype(np.float32)
    want = jmodel.apply({'params': params}, hidden, method=JGroma.logits)
    with torch.no_grad():
        got = tmodel.logits(_t(hidden))
    assert got.shape[-1] == CFG.vocab_size
    _close(got, want)


def test_quant_llama_prefill_and_decode_int8_cache(models, monkeypatch):
    """Prefill into a fresh int8 KV cache, then 3 decode steps."""
    jmodel, params, tmodel = models
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    llm = CFG.llm
    jqp = j_quantize(params, CFG)
    tqp = quantize_groma_llm(tmodel, CFG)
    rng = np.random.default_rng(3)
    b, s, max_len = 2, 12, 20
    emb = rng.standard_normal((b, s, llm.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[1, 9:] = False                        # a padded row
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0)

    j_fwd = jax.jit(lambda *a: j_forward(a[0], llm, *a[1:]))
    jh, jc = j_fwd(jqp, jnp.asarray(emb), jnp.asarray(valid),
                   jnp.asarray(pos), j_cache(llm, b, max_len))
    th, tc = quant_llama_forward(tqp, llm, _t(emb), _t(valid), _t(pos),
                                 make_quant_kv_cache(llm, b, max_len))
    _close(th, jh)
    for i in range(llm.num_layers):
        np.testing.assert_array_equal(tc['k'][i].numpy(),
                                      np.asarray(jc['k'][i]))
    next_pos = pos[:, -1:] + 1
    for step in range(3):
        x = rng.standard_normal((b, 1, llm.hidden_size)).astype(np.float32)
        one = np.ones((b, 1), bool)
        jh, jc = j_fwd(jqp, jnp.asarray(x), jnp.asarray(one),
                       jnp.asarray(next_pos + step), jc)
        th, tc = quant_llama_forward(tqp, llm, _t(x), _t(one),
                                     _t(next_pos + step), tc)
        _close(th, jh)
    assert tc['index'] == s + 3
    np.testing.assert_array_equal(tc['mask'].numpy(), np.asarray(jc['mask']))


def test_cache_overflow_raises(models):
    _, _, tmodel = models
    llm = CFG.llm
    qp = quantize_groma_llm(tmodel, CFG)
    cache = make_quant_kv_cache(llm, 1, 4)
    cache['index'] = 4
    with pytest.raises(ValueError, match='overflow'):
        quant_llama_forward(qp, llm, torch.zeros(1, 1, llm.hidden_size),
                            torch.ones(1, 1, dtype=torch.bool),
                            torch.full((1, 1), 4), cache)


def test_four_level_input_projection_pyramid(rng):
    """The multi-level pyramid (strided conv, 2x and 4x transposed convs,
    whose taps the weight bridge mirrors) against JAX; Groma itself ships
    one level."""
    from groma_tpu.checkpoint.hf_export import export_perceiver
    from groma_tpu.config import DDETRConfig, PerceiverConfig, ViTConfig
    from groma_tpu.models.perceiver import Perceiver as JPerceiver
    from groma_tpu_torch.models.perceiver import Perceiver
    vit = ViTConfig(hidden_size=32, num_layers=2, num_heads=4,
                    patch_size=14, image_size=56, dtype='float32')
    ddetr = DDETRConfig(d_model=32, num_queries=16, encoder_layers=1,
                        decoder_layers=1, num_heads=4, ffn_dim=64,
                        num_feature_levels=4, dtype='float32')
    cfg = PerceiverConfig(vit=vit, ddetr=ddetr, image_size=56)
    image = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    jmodel = JPerceiver(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), image)['params']
    want = jax.jit(jmodel.apply)({'params': params}, image)
    sd = export_perceiver(jax.tree_util.tree_map(np.asarray, params), 2, 1,
                          1, 4, patch_size=14)
    tmodel = Perceiver(cfg)
    tmodel.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmodel(_t(image))
    _close(got['pred_boxes'], want['pred_boxes'])
    _close(got['enc_outputs_class'], want['enc_outputs_class'])
    assert got['enc_outputs_class'].shape[1] == 16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2


def test_checkpoint_directory_loads_through_import_groma(models, tmp_path):
    """A reference-format checkpoint directory (written here by the JAX
    package's exporter) loads through the JAX-free import path."""
    from groma_tpu.checkpoint.hf_export import export_hf_dir
    from groma_tpu_torch.checkpoint.loader import load_groma
    _, params, tmodel = models
    export_hf_dir(params, CFG, str(tmp_path))
    loaded, cfg = load_groma(str(tmp_path))
    assert cfg.llm.num_layers == CFG.llm.num_layers
    want = tmodel.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-6)
