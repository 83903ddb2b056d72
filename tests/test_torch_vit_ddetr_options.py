"""Two configurations the port refused until now, against the JAX package:
DINOv2's SwiGLU FFN (the giant model) and DDETR's dropout under
``deterministic=False``.

* SwiGLU: a tiny ``ViTConfig(use_swiglu_ffn=True)`` carried from a JAX init
  through the port's ``export_dinov2`` (``mlp.weights_in`` /
  ``mlp.weights_out``, HF's names): every hidden state within 1e-5 of
  max|x| of JAX's (f32 sums in another order); the hidden width rounded
  as JAX rounds it, (inner * 2 // 3 + 7) // 8 * 8 (4096 at giant's 1536);
  a checkpoint directory whose config says ``use_swiglu_ffn`` loads
  through ``load_groma``.
* Dropout: with ``deterministic=False`` and rates 0 the Perceiver's outputs
  are the deterministic ones bitwise, and JAX's (rates 0, a dropout key)
  within 1e-5 of max|x|; the drops sit where JAX's ``nn.Dropout`` sit
  (encoder: attention, activation, FFN; decoder: self-attention,
  cross-attention, activation, FFN); at rate 0.3 the kept share of 200,000
  values lies within 0.5 % of 0.7 (about 5 standard deviations) and the kept
  values are scaled by 1 / 0.7; the same generator state gives the same
  output; ``deterministic=True`` ignores the generator; no generator
  under ``deterministic=False`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.config import ViTConfig as JViTConfig
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.dinov2 import Dinov2Model as JDinov2
from groma_tpu.models.perceiver import Perceiver as JPerceiver
from groma_tpu.checkpoint.hf_export import export_perceiver
from groma_tpu_torch.checkpoint import hf_export
from groma_tpu_torch.config import ViTConfig
from groma_tpu_torch.models import ddetr as t_ddetr
from groma_tpu_torch.models.dinov2 import Dinov2Model, _SwiGLUFFN
from groma_tpu_torch.models.perceiver import Perceiver

torch.set_num_threads(2)
VIT = dict(hidden_size=48, num_layers=3, num_heads=4, patch_size=14,
           image_size=56, use_swiglu_ffn=True, dtype='float32')


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope='module')
def swiglu():
    jmodel = JDinov2(JViTConfig(**VIT))
    x = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    return jmodel, params, x


def test_swiglu_vit_matches_jax(swiglu):
    jmodel, params, x = swiglu
    sd = hf_export.export_dinov2(params, VIT['num_layers'], 14)
    assert 'encoder.layer.0.mlp.weights_in.weight' in sd
    assert not any('.fc1.' in k for k in sd)
    model = Dinov2Model(ViTConfig(**VIT))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    want_last, want_hidden = jmodel.apply({'params': params},
                                          jnp.asarray(x))
    with torch.no_grad():
        last, hidden = model(torch.from_numpy(x))
    _close(last, want_last)
    assert len(hidden) == len(want_hidden) == VIT['num_layers'] + 1
    for got, want in zip(hidden, want_hidden):
        _close(got, want)


def test_swiglu_hidden_width_is_rounded_as_jax_rounds_it(swiglu):
    _, params, _ = swiglu
    inner = int(VIT['hidden_size'] * 4.0)
    ffn = _SwiGLUFFN(VIT['hidden_size'], inner)
    assert tuple(ffn.weights_in.weight.shape[::-1]) == \
        params['layer_0']['weights_in']['kernel'].shape
    giant = _SwiGLUFFN(1536, 6144, device='meta')
    assert (giant.weights_in.out_features,
            giant.weights_out.in_features) == (2 * 4096, 4096)


def test_a_swiglu_checkpoint_loads_through_load_groma(tmp_path):
    from groma_tpu_torch.checkpoint.loader import (load_groma,
                                                   random_groma_full)
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    cfg = t_tiny()
    cfg = cfg.replace(perceiver=cfg.perceiver.replace(
        vit=cfg.perceiver.vit.replace(use_swiglu_ffn=True)))
    model = random_groma_full(cfg, seed=1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert any('mlp.weights_in' in k for k in sd)
    d = tmp_path / 'ckpt'
    d.mkdir()
    import json
    with open(d / 'config.json', 'w') as f:
        json.dump(hf_export.export_config(cfg), f)
    hf_export.save_safetensors(sd, str(d / 'model.safetensors'))
    back, back_cfg = load_groma(str(d), 'cpu', full_precision=True)
    assert back_cfg.perceiver.vit.use_swiglu_ffn
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# -------------------------------------------------------------- dropout

PCFG = tiny_groma_config().perceiver


def _perceivers(cfg):
    jmodel = JPerceiver(cfg)
    x = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), x)['params'])
    sd = export_perceiver(params, cfg.vit.num_layers,
                          cfg.ddetr.encoder_layers, cfg.ddetr.decoder_layers,
                          cfg.ddetr.num_feature_levels,
                          patch_size=cfg.vit.patch_size)
    model = Perceiver(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return jmodel, params, model, x


KEYS = ('pred_boxes', 'enc_outputs_coord', 'intermediate_hidden_states')


def test_rates_zero_under_deterministic_false_are_the_deterministic_forward():
    cfg = PCFG.replace(ddetr=PCFG.ddetr.replace(dropout=0.0,
                                                activation_dropout=0.0))
    jmodel, params, model, x = _perceivers(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        det = model(torch.from_numpy(x))
        drop = model(torch.from_numpy(x), deterministic=False, generator=gen)
    want = jmodel.apply({'params': params}, x, deterministic=False,
                        rngs={'dropout': jax.random.PRNGKey(5)})
    for k in KEYS:
        assert torch.equal(drop[k], det[k]), k
        _close(drop[k], want[k])


def test_drops_sit_where_jaxs_do(monkeypatch):
    cfg = PCFG.replace(ddetr=PCFG.ddetr.replace(dropout=0.1,
                                                activation_dropout=0.2))
    _, _, model, x = _perceivers(cfg)
    calls = []
    real = t_ddetr.dropout

    def spy(t, rate, deterministic=True, generator=None):
        calls.append((rate, deterministic))
        return real(t, rate, deterministic, generator)
    monkeypatch.setattr(t_ddetr, 'dropout', spy)
    with torch.no_grad():
        model(torch.from_numpy(x), deterministic=False,
              generator=torch.Generator().manual_seed(0))
    d = cfg.ddetr
    want = [(0.1, False), (0.2, False), (0.1, False)] * d.encoder_layers \
        + [(0.1, False), (0.1, False), (0.2, False), (0.1, False)] \
        * d.decoder_layers
    assert calls == want


def test_dropout_keeps_its_share_and_scales_what_it_keeps():
    x = torch.rand(200_000) + 0.5
    gen = torch.Generator().manual_seed(0)
    y = t_ddetr.dropout(x, 0.3, deterministic=False, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    assert t_ddetr.dropout(x, 0.3) is x
    assert t_ddetr.dropout(x, 0.0, deterministic=False) is x
    with pytest.raises(ValueError, match='generator'):
        t_ddetr.dropout(x, 0.3, deterministic=False)


def test_dropout_forward_is_seeded_and_deterministic_ignores_it():
    _, _, model, x = _perceivers(PCFG)           # JAX's rates: 0.1 and 0
    xt = torch.from_numpy(x)
    with torch.no_grad():
        det = model(xt)
        a = model(xt, deterministic=False,
                  generator=torch.Generator().manual_seed(4))
        b = model(xt, deterministic=False,
                  generator=torch.Generator().manual_seed(4))
        c = model(xt, deterministic=False,
                  generator=torch.Generator().manual_seed(5))
        again = model(xt, generator=torch.Generator().manual_seed(4))
    for k in KEYS:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all(), k
        assert torch.equal(again[k], det[k]), k
    assert not torch.equal(a['intermediate_hidden_states'],
                           det['intermediate_hidden_states'])
    assert not torch.equal(a['intermediate_hidden_states'],
                           c['intermediate_hidden_states'])
