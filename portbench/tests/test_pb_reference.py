"""The plain reference against the port, at tiny sizes on the CPU, in
float32 (where the two should agree to rounding): the int4 weights,
DINOv2, RoIAlign, the region encoder and the quantized LLM's logits."""

from __future__ import annotations

import pytest
import torch

from portbench import weights
from portbench.drivers import engine as drv
from portbench.reference import groma as ref
from portbench.tests.conftest import TINY_SPEC

F32 = {**TINY_SPEC['model'], 'llm_dtype': 'float32'}
SPEC = {**TINY_SPEC, 'model': F32}
ACT = ref.Precision()


@pytest.fixture(scope='module')
def tiny():
    cfg = drv.groma_config(SPEC)
    table = drv.param_table(cfg)
    model = drv.build_model(cfg, table, 7, 'cpu')
    params = {}
    for _, drawn in weights.draw(table, 7, 'cpu'):
        params.update(drawn)
    return cfg, model, params


def test_int4_matches_the_ports_quantization():
    from groma_tpu_torch.ops.quant4 import (dequantize_weight_int4,
                                            quantize_weight_int4)
    w = torch.randn(384, 512, generator=torch.Generator().manual_seed(0))
    w = w.to(torch.bfloat16)
    port = dequantize_weight_int4(quantize_weight_int4(
        w.T.float(), block=256))
    assert torch.equal(ref.int4_dequant(w), port)


def test_vit_and_image_tokens(tiny):
    cfg, model, p = tiny
    img = torch.randn(1, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        vis = model.vision(img)
        port = model.perceiver.encode_image(img)
    states = ref.vit(img[0], p, F32, ACT)
    for a, b in zip(states, port):
        torch.testing.assert_close(a, b[0].float(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ref.image_tokens(states, p, ACT),
                               vis['image_tokens'][0], rtol=1e-4, atol=1e-4)


def test_roi_align_matches_the_ports():
    from groma_tpu_torch.ops.roi_align import roi_align_batched
    g = torch.Generator().manual_seed(2)
    feat = torch.randn(1, 9, 11, 5, generator=g)
    rois = torch.rand(1, 6, 4, generator=g) * 60 - 10
    port = roi_align_batched(feat, rois, output_size=4, spatial_scale=0.25)
    mine = ref.roi_align(feat[0].permute(2, 0, 1), rois[0], 4, 0.25)
    torch.testing.assert_close(mine, port[0].permute(0, 3, 1, 2), rtol=1e-5,
                               atol=1e-5)


def test_region_tokens(tiny):
    cfg, model, p = tiny
    g = torch.Generator().manual_seed(3)
    img = torch.randn(1, 56, 56, 3, generator=g)
    boxes = torch.rand(1, 5, 4, generator=g) * 0.5 + 0.2
    with torch.no_grad():
        hs = model.perceiver.encode_image(img)
        port = model.region_encoder([h[:, 1:] for h in hs[-3:]], boxes)
    states = ref.vit(img[0], p, F32, ACT)
    mine = ref.region_tokens(states, boxes[0], p, F32, ACT)
    torch.testing.assert_close(mine, port[0].float(), rtol=2e-4, atol=2e-4)


def test_llm_logits(tiny):
    """A prompt through the port's quantized forward (f32, exact keys)
    and through the reference: the same logits at every position."""
    from groma_tpu_torch.eval.generate_quant import (quant_logits,
                                                     quantize_groma_llm)
    from groma_tpu_torch.models.llama_quant import quant_llama_forward
    cfg, model, p = tiny
    qp = quantize_groma_llm(model, cfg, bits=4)
    s = 40
    emb = torch.randn(1, s, 256, generator=torch.Generator().manual_seed(4))
    valid = torch.ones(1, s, dtype=torch.bool)
    pos = torch.arange(s)[None]
    with torch.no_grad():
        hidden, _ = quant_llama_forward(qp, cfg.llm, emb, valid, pos)
        port = quant_logits(qp, hidden)[0]
    xs = [emb[0]]
    llm = F32['llm']
    for i in range(llm['num_hidden_layers']):
        pre = f'llm.model.layers.{i}.'
        xs = ref.decoder_layer(xs, [s], {k: v for k, v in p.items()
                                         if k.startswith(pre)}, llm, ACT)
    mine = ref.logits(xs[0], p, llm, ACT)
    base = llm['vocab_size']
    torch.testing.assert_close(mine[:, :base], port[:, :base], rtol=1e-4,
                               atol=1e-4)
    # the port rounds the hidden state to bf16 for the added tokens' head
    torch.testing.assert_close(mine[:, base:], port[:, base:], rtol=0,
                               atol=2e-2)
