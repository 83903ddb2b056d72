"""Weights for the port (counterpart of ``groma_tpu/checkpoint/loader.py``).

A reference-format checkpoint directory (``config.json`` with
``llm_cfg``/``perceiver_cfg``, safetensors or ``.bin``) loads straight into
the port's modules, which carry the reference's parameter names
(``load_state_dict(strict=True)``).  The one transform on the way in is the
one the JAX package's import applies: the DINOv2 position table is resized
bicubically to the deploy grid.  ``from_jax_params`` takes a JAX
``GromaModel`` param tree (numpy arrays) through the port's copy of
``hf_export.export_groma`` (every Dense/conv/convT transpose and the flatten
permutation undone).

``random_groma`` builds any ``GromaConfig`` with random weights from a
seed directly on the target device, and quantizes the LLM one layer at a
time so its full-precision copy never exists at once; ``random_groma_full``
keeps every weight in f32, for training.  ``full_precision=True`` loads a
model for training: f32 master weights everywhere (the JAX package's
params), the ViT and region encoder still computing in their config dtype.
``random_perceiver`` and ``load_perceiver`` make the detector alone (the
stage-1 trainer's model and ``eval/run_ddetr``'s), the latter from a
perceiver checkpoint directory (its config.json the reference's
``perceiver_cfg``).  ``load_unquantized`` (and
``random_groma_unquantized``) loads the model of
the unquantized inference path (``--quant_type none``): the LLM trunk's
linears stored once in ``cfg.llm.dtype``, the embeddings, norms and heads
in f32, as the JAX package's params are.

Entry points run on the card: ``device=None`` means ``cuda``, and without a
CUDA device ``resolve_device`` raises (pass ``device='cpu'`` to run on the
CPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from groma_tpu_torch.config import (DDETRConfig, GromaConfig, LlamaConfig,
                                    PerceiverConfig, ViTConfig,
                                    tiny_groma_config)
from groma_tpu_torch.models.groma import GromaModel
from groma_tpu_torch.models.llama import LlamaDecoderLayer, torch_dtype
from groma_tpu_torch.models.llama_quant import (quantize_head,
                                                quantize_llama_layer)
from groma_tpu_torch.models.perceiver import Perceiver

QUANT_BITS = {'bf16': 16, 'int8': 8, 'int4': 4}   # --quant_type -> bits
QUANT_TYPES = ('none', 'bf16', 'int8', 'int4')    # 'none': unquantized LLM
_SMALL_INIT = ('cls_token', 'position_embeddings',
               'query_position_embeddings.weight', 'embed_tokens.weight',
               'new_input_embs.weight')


def resolve_device(device=None) -> str:
    """``device`` as given, or ``'cuda'`` when None; raises when a CUDA
    device is asked for and there is none (no silent CPU fallback)."""
    device = str(device or 'cuda')
    if device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device for --device {device}: pass '
                           f'--device cpu to run on the CPU')
    return device


def hf_groma_config(d: dict) -> GromaConfig:
    """Translate a reference groma config.json dict into GromaConfig."""
    llm_d = d.get('llm_cfg', {})
    perc_d = d.get('perceiver_cfg', {})
    vit_d = perc_d.get('vis_encoder_cfg', {})
    ddetr_d = perc_d.get('ddetr_cfg', {})
    vit = ViTConfig(
        dtype=vit_d.get('compute_dtype', ViTConfig.dtype),
        hidden_size=vit_d.get('hidden_size', 1024),
        num_layers=vit_d.get('num_hidden_layers', 24),
        num_heads=vit_d.get('num_attention_heads', 16),
        mlp_ratio=vit_d.get('mlp_ratio', 4),
        patch_size=vit_d.get('patch_size', 14),
        image_size=vit_d.get('image_size', 518),
        layerscale_value=vit_d.get('layerscale_value', 1.0),
        use_swiglu_ffn=vit_d.get('use_swiglu_ffn', False),
    )
    ddetr = DDETRConfig(
        dtype=ddetr_d.get('compute_dtype', DDETRConfig.dtype),
        d_model=ddetr_d.get('d_model', 256),
        num_queries=ddetr_d.get('num_queries', 300),
        encoder_layers=ddetr_d.get('encoder_layers', 6),
        decoder_layers=ddetr_d.get('decoder_layers', 6),
        num_heads=ddetr_d.get('encoder_attention_heads', 8),
        ffn_dim=ddetr_d.get('encoder_ffn_dim', 1024),
        num_feature_levels=ddetr_d.get('num_feature_levels', 1),
        enc_n_points=ddetr_d.get('encoder_n_points', 4),
        dec_n_points=ddetr_d.get('decoder_n_points', 4),
        num_labels=ddetr_d.get('num_labels',
                               len(ddetr_d.get('id2label', {0: 0})) or 1),
        two_stage=ddetr_d.get('two_stage', True),
        with_box_refine=ddetr_d.get('with_box_refine', True),
        focal_alpha=ddetr_d.get('focal_alpha', 0.25),
    )
    perceiver = PerceiverConfig(
        vit=vit, ddetr=ddetr,
        vis_output_layer=perc_d.get('vis_output_layer', -1),
        # reference checkpoints carry no deploy size (448 is groma.py's
        # fixed input); exported-from-here dirs record theirs
        image_size=perc_d.get('deploy_image_size', 448))
    llm = LlamaConfig(
        dtype=llm_d.get('compute_dtype', LlamaConfig.dtype),
        vocab_size=llm_d.get('vocab_size', 32000),
        hidden_size=llm_d.get('hidden_size', 4096),
        intermediate_size=llm_d.get('intermediate_size', 11008),
        num_layers=llm_d.get('num_hidden_layers', 32),
        num_heads=llm_d.get('num_attention_heads', 32),
        num_kv_heads=llm_d.get('num_key_value_heads',
                               llm_d.get('num_attention_heads', 32)),
        max_position_embeddings=llm_d.get('max_position_embeddings', 4096),
        rope_theta=llm_d.get('rope_theta', 10000.0),
        rms_norm_eps=llm_d.get('rms_norm_eps', 1e-5),
    )
    return GromaConfig(
        llm=llm, perceiver=perceiver,
        num_new_token=d.get('num_new_token', 114),
        nms_thres=d.get('nms_thres', 0.6),
        box_score_thres=d.get('box_score_thres', 0.15),
        max_region_num=d.get('max_region_num', 100),
        # framework-only shape knobs (absent from reference checkpoints,
        # recorded by checkpoint/hf_export.export_config)
        num_image_tokens=d.get('num_image_tokens', 256),
        max_seq_len=d.get('max_seq_len', 2048),
        region_roi_out=d.get('region_roi_out', 14),
        region_num_fuse=d.get('region_num_fuse', 5),
        region_gn_groups=d.get('region_gn_groups', 64),
    )


def from_state_dict(sd: dict, cfg: GromaConfig, device=None,
                    full_precision: bool = False,
                    llm_linear_dtype=None) -> GromaModel:
    """Reference-format Groma state dict (name -> numpy array) -> the
    port's GromaModel, each tensor in its module's dtype
    (``llm_linear_dtype``: see ``GromaModel``)."""
    model = GromaModel(cfg, device='meta', full_precision=full_precision,
                       llm_linear_dtype=llm_linear_dtype)
    want = model.state_dict()
    tensors = {k: torch.from_numpy(np.array(v)).to(
                   device=device, dtype=want[k].dtype)
               for k, v in sd.items() if k in want}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.eval()


def from_jax_params(params: dict, cfg: GromaConfig, device=None,
                    full_precision: bool = False):
    """JAX GromaModel params (a tree of numpy arrays) -> GromaModel."""
    from groma_tpu_torch.checkpoint.hf_export import export_groma
    return from_state_dict(export_groma(params, cfg), cfg, device,
                           full_precision)


def load_groma(path: str, device=None, full_precision: bool = False,
               llm_in_compute_dtype: bool = False):
    """A reference-format checkpoint directory (config.json with
    llm_cfg/perceiver_cfg + safetensors or .bin) -> (GromaModel, cfg), the
    state dict loaded as it is but for the ViT position table, resized to
    the deploy grid.  ``llm_in_compute_dtype`` stores the LLM trunk's
    linears in ``cfg.llm.dtype`` (the unquantized inference path)."""
    from groma_tpu_torch.checkpoint.hf_import import (load_config_json,
                                                      load_state_dict,
                                                      resize_vit_pos_embed)
    cfg_d = load_config_json(path)
    if 'config_type' in cfg_d:
        raise ValueError(f'{path} is an orbax checkpoint of the JAX package; '
                         'export it with groma_tpu.checkpoint.hf_export '
                         'first')
    cfg = hf_groma_config(cfg_d)
    pc = cfg.perceiver
    sd = resize_vit_pos_embed(
        load_state_dict(path),
        'perceiver.vis_encoder.embeddings.position_embeddings',
        pc.image_size // pc.vit.patch_size)
    linear_dtype = torch_dtype(cfg.llm.dtype) if llm_in_compute_dtype \
        else None
    return from_state_dict(sd, cfg, device, full_precision,
                           linear_dtype), cfg


@torch.no_grad()
def _fill(module: torch.nn.Module, gen: torch.Generator, prefix: str = ''):
    """Random init in place: biases 0, 1-D scales 1, embeddings N(0, 0.02),
    other weights N(0, 1/fan_in)."""
    for name, p in module.named_parameters(prefix=prefix):
        if name.endswith('bias'):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            std = 0.02 if name.endswith(_SMALL_INIT) \
                else p[0].numel() ** -0.5
            p.normal_(0.0, std, generator=gen)


def _fill_all_but_the_llm(model: GromaModel, gen: torch.Generator, device):
    """Random init on ``device`` of every part of a meta-device model but
    the LLM, then of the LLM's embedding table: the first draws of the
    random models."""
    for name, child in model.named_children():
        if name != 'llm':
            child.to_empty(device=device)
            _fill(child, gen, prefix=name)
    table = model.llm.model.embed_tokens
    table.to_empty(device=device)
    _fill(table, gen, prefix='embed_tokens')


@torch.no_grad()
def random_groma(cfg: GromaConfig, seed: int = 0, device='cpu',
                 bits: int = 8):
    """Random weights from ``seed`` for any config, made on ``device``.
    Returns (GromaModel, qp): the LLM lives only in qp, quantized with
    ``bits`` (8, 4 or 16; the model's ``llm`` keeps just its embedding
    table, for prefill)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GromaModel(cfg, device='meta')
    _fill_all_but_the_llm(model, gen, device)
    llm = model.llm
    qp = {'layers': []}
    for layer in llm.model.layers:
        layer.to_empty(device=device)
        _fill(layer, gen)
        qp['layers'].append(quantize_llama_layer(layer.state_dict(), bits))
        layer.to_empty(device='meta')
    llm.model.norm.to_empty(device=device)
    _fill(llm.model.norm, gen)
    qp['norm'] = llm.model.norm.weight
    llm.lm_head.to_empty(device=device)
    _fill(llm.lm_head, gen)
    qp['lm_head'] = quantize_head(llm.lm_head.weight, bits)
    llm.lm_head.to_empty(device='meta')
    qp['embed_tokens'] = llm.model.embed_tokens.weight.to(torch.bfloat16)
    qp['new_input_embs'] = model.new_input_embs.weight.to(torch.bfloat16)
    qp['extra_lm_head'] = model.extra_lm_head.weight.T.to(torch.bfloat16)
    return model.eval(), qp


@torch.no_grad()
def random_groma_full(cfg: GromaConfig, seed: int = 0, device='cpu'):
    """Random weights from ``seed`` for any config, every one kept in f32
    on ``device`` (a trainer's master weights)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GromaModel(cfg, device='meta', full_precision=True)
    model.to_empty(device=device)
    _fill(model, gen)
    return model


@torch.no_grad()
def random_groma_unquantized(cfg: GromaConfig, seed: int = 0, device='cpu'):
    """Random weights from ``seed`` for any config, made on ``device``,
    the LLM trunk's linears stored in ``cfg.llm.dtype``.  The weights are
    drawn in f32, in ``random_groma``'s order, so that one seed gives both
    the same full-precision weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GromaModel(cfg, device='meta',
                       llm_linear_dtype=torch_dtype(cfg.llm.dtype))
    _fill_all_but_the_llm(model, gen, device)
    llm = model.llm
    for layer in llm.model.layers:
        drawn = LlamaDecoderLayer(cfg.llm, device)
        _fill(drawn, gen)
        layer.to_empty(device=device)
        layer.load_state_dict(drawn.state_dict())
        del drawn
    llm.model.norm.to_empty(device=device)
    _fill(llm.model.norm, gen)
    llm.lm_head.to_empty(device=device)
    _fill(llm.lm_head, gen)
    return model.eval()


def load_unquantized(model_dir: str, device=None, seed: int = 0):
    """'tiny', 'random' or a checkpoint directory (as ``load_quantized``)
    -> (GromaModel, cfg) for the unquantized path, the LLM trunk's
    linears in ``cfg.llm.dtype``, on ``device`` (None: the card)."""
    device = resolve_device(device)
    if model_dir in ('tiny', 'random'):
        cfg = tiny_groma_config() if model_dir == 'tiny' else GromaConfig()
        return random_groma_unquantized(cfg, seed=seed, device=device), cfg
    return load_groma(model_dir, device, llm_in_compute_dtype=True)


def load_quantized(model_dir: str, device=None, seed: int = 0,
                   bits: int = 8, group=None):
    """'tiny' (random tiny config), 'random' (random full-width
    GromaConfig) or a checkpoint directory -> (GromaModel, qp, cfg), the
    LLM quantized with ``bits`` (8, 4 or 16), on ``device`` (None: the
    card; see ``resolve_device``).  With a tp ``group`` every rank builds
    the whole model and tree, then cuts both for its rank
    (``mesh.cut_tp``, ``mesh.cut_quant_tree``) and frees the whole tree."""
    from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
    from groma_tpu_torch.parallel import mesh
    device = resolve_device(device)
    if model_dir in ('tiny', 'random'):
        cfg = tiny_groma_config() if model_dir == 'tiny' else GromaConfig()
        model, qp = random_groma(cfg, seed=seed, device=device, bits=bits)
    else:
        model, cfg = load_groma(model_dir, device)
        qp = quantize_groma_llm(model, cfg, bits)
    if group is None:
        return model, qp, cfg
    mesh.cut_tp(model, group)
    return model, mesh.cut_quant_tree(qp, cfg.llm, group), cfg


@torch.no_grad()
def _init_ddetr(ddetr, gen: torch.Generator):
    """The DDETR head's own initial values, as the JAX package's
    ``DDETRTransformer`` draws them: sampling offsets on a ring of unit
    directions scaled by point (zero weights), class biases at the 0.01
    focal prior, each box head's last layer zero, the level and query
    embeddings N(0, 1)."""
    for mod in ddetr.modules():
        offsets = getattr(mod, 'sampling_offsets', None)
        if offsets is None:
            continue
        nh, n_points = mod.num_heads, mod.n_points
        nl = offsets.out_features // (nh * n_points * 2)
        theta = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
        grid = torch.stack([theta.cos(), theta.sin()], -1)
        grid = grid / grid.abs().amax(-1, keepdim=True)
        grid = grid[:, None, None, :].expand(nh, nl, n_points, 2)
        scale = torch.arange(1, n_points + 1,
                             dtype=torch.float32)[None, None, :, None]
        offsets.weight.zero_()
        offsets.bias.copy_((grid * scale).reshape(-1))
    prior = -math.log((1 - 0.01) / 0.01)
    for heads in (ddetr.class_embed_coco, ddetr.class_embed_sa1b,
                  [ddetr.class_embed_enc]):
        for head in heads:
            head.bias.fill_(prior)
    for mlp in ddetr.bbox_embed:
        mlp.layers[-1].weight.zero_()
        mlp.layers[-1].bias.zero_()
    ddetr.level_embed.normal_(0.0, 1.0, generator=gen)
    ddetr.query_position_embeddings.weight.normal_(0.0, 1.0, generator=gen)


def random_perceiver(cfg: PerceiverConfig, seed: int = 0, device='cpu'):
    """A detector with random weights from ``seed``, f32 on ``device``, the
    ViT computing in ``cfg.vit.dtype`` (the stage-1 trainer's model)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Perceiver(cfg, device='meta', vit_dtype=torch.float32,
                      vit_compute_dtype=torch_dtype(cfg.vit.dtype))
    model.to_empty(device=device)
    _fill(model, gen)
    _init_ddetr(model.ddetr_transformer, gen)
    return model


def perceiver_config_json(cfg: PerceiverConfig) -> dict:
    """The reference's ``perceiver_cfg`` dict of a detector checkpoint
    directory's config.json."""
    from groma_tpu_torch.checkpoint.hf_export import export_config
    return export_config(GromaConfig(perceiver=cfg))['perceiver_cfg']


def load_perceiver(path: str, device=None):
    """A perceiver checkpoint directory (config.json holding the
    reference's ``perceiver_cfg``, weights under the reference's names)
    -> (Perceiver in f32 on ``device``, PerceiverConfig)."""
    from groma_tpu_torch.checkpoint.hf_import import (load_config_json,
                                                      load_state_dict,
                                                      resize_vit_pos_embed)
    cfg = hf_groma_config({'perceiver_cfg': load_config_json(path)}
                          ).perceiver
    sd = resize_vit_pos_embed(load_state_dict(path),
                              'vis_encoder.embeddings.position_embeddings',
                              cfg.image_size // cfg.vit.patch_size)
    model = Perceiver(cfg, device='meta', vit_dtype=torch.float32,
                      vit_compute_dtype=torch_dtype(cfg.vit.dtype))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32),
                                              device=device)
                           for k, v in sd.items()}, strict=True, assign=True)
    return model.eval(), cfg
