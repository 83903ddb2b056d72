"""Flax GromaModel params -> reference-format (HF/torch) state dict.

The exact inverse of checkpoint/hf_import.py, so checkpoints trained in
this framework can be handed back to torch consumers (the reference's
eval/serving stack, or any HF LlamaForCausalLM/Dinov2 loader).  Every
mapping mirrors its import counterpart (same reference file:line
citations apply); the pair is round-trip tested at tiny scale in
tests/test_checkpoint_roundtrip.py — export(params) fed back through
import_groma reproduces the tree exactly.

Notes:
* the DINOv2 position embedding is exported at the DEPLOY grid (the
  import side bicubically resizes on the way in; the inverse resize is
  lossy, so the exported checkpoint pins the deploy resolution and a
  torch consumer at another resolution should re-interpolate).
* packed/quantized trees (bits=4/8/16 runtime formats) are runtime-only
  — export from the full-precision flax params they were built from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _n(x) -> np.ndarray:
    return np.asarray(x)


# ------------------------------------------------------------ primitives

def _inv_dense(out: Dict[str, np.ndarray], name: str, p: dict):
    out[name + '.weight'] = _n(p['kernel']).T
    if 'bias' in p:
        out[name + '.bias'] = _n(p['bias'])


def _inv_ln(out: Dict[str, np.ndarray], name: str, p: dict):
    out[name + '.weight'] = _n(p['scale'])
    if 'bias' in p:
        out[name + '.bias'] = _n(p['bias'])


def _inv_conv(out: Dict[str, np.ndarray], name: str, p: dict):
    # flax NHWC (kh, kw, in, out) -> torch (out, in, kh, kw)
    out[name + '.weight'] = _n(p['kernel']).transpose(3, 2, 0, 1)
    if 'bias' in p:
        out[name + '.bias'] = _n(p['bias'])


def _inv_convt(out: Dict[str, np.ndarray], name: str, p: dict):
    # inverse of hf_import._convt: flax (kh, kw, in, out) -> torch
    # ConvTranspose2d (in, out, kh, kw) with the spatial mirror undone
    w = _n(p['kernel']).transpose(2, 3, 0, 1)      # (in, out, kh, kw)
    out[name + '.weight'] = np.ascontiguousarray(w[:, :, ::-1, ::-1])
    if 'bias' in p:
        out[name + '.bias'] = _n(p['bias'])


def _inv_msda(out, prefix: str, p: dict):
    _inv_dense(out, prefix + 'value_proj', p['value_proj'])
    _inv_dense(out, prefix + 'sampling_offsets', p['sampling_offsets'])
    _inv_dense(out, prefix + 'attention_weights', p['attention_weights'])
    _inv_dense(out, prefix + 'output_proj', p['output_proj'])


def _inv_mlp3(out, prefix: str, p: dict):
    for i in range(3):
        _inv_dense(out, f'{prefix}layers.{i}', p[f'layers_{i}'])


# ------------------------------------------------------------------ llama

def export_llama(params: dict, num_layers: int,
                 prefix: str = '') -> Dict[str, np.ndarray]:
    """Inverse of hf_import.import_llama: flax LlamaForCausalLM-style
    params -> HF state dict keys."""
    out: Dict[str, np.ndarray] = {}
    model = params.get('model', params)
    out[prefix + 'model.norm.weight'] = _n(model['norm']['scale'])
    for i in range(num_layers):
        lp = model[f'layers_{i}']
        p = f'{prefix}model.layers.{i}.'
        out[p + 'input_layernorm.weight'] = _n(
            lp['input_layernorm']['scale'])
        out[p + 'post_attention_layernorm.weight'] = _n(
            lp['post_attention_layernorm']['scale'])
        for proj in ('q_proj', 'k_proj', 'v_proj', 'o_proj'):
            out[p + f'self_attn.{proj}.weight'] = _n(
                lp['self_attn'][proj]['kernel']).T
        for proj in ('gate_proj', 'up_proj', 'down_proj'):
            out[p + f'mlp.{proj}.weight'] = _n(lp[proj]['kernel']).T
    if 'embed_tokens' in params:
        out[prefix + 'model.embed_tokens.weight'] = _n(
            params['embed_tokens'])
    if 'lm_head' in params:
        out[prefix + 'lm_head.weight'] = _n(params['lm_head']['kernel']).T
    return out


# ----------------------------------------------------------------- dinov2

def export_dinov2(params: dict, num_layers: int, patch_size: int,
                  prefix: str = '') -> Dict[str, np.ndarray]:
    """Inverse of hf_import.import_dinov2 (pos embed exported at the
    deploy grid — see module docstring)."""
    out: Dict[str, np.ndarray] = {}

    def put(name, v):
        out[prefix + name] = _n(v)

    put('embeddings.cls_token', params['cls_token'])
    put('embeddings.position_embeddings', params['pos_embed'])
    pk = _n(params['patch_embed']['kernel'])           # (p*p*3, C)
    c_out = pk.shape[1]
    put('embeddings.patch_embeddings.projection.weight',
        pk.reshape(patch_size, patch_size, 3, c_out).transpose(3, 2, 0, 1))
    put('embeddings.patch_embeddings.projection.bias',
        params['patch_embed']['bias'])
    put('layernorm.weight', params['norm']['scale'])
    put('layernorm.bias', params['norm']['bias'])
    for i in range(num_layers):
        lp = params[f'layer_{i}']
        p = f'encoder.layer.{i}.'
        put(p + 'norm1.weight', lp['norm1']['scale'])
        put(p + 'norm1.bias', lp['norm1']['bias'])
        qkv_w = _n(lp['qkv']['kernel'])                # (C, 3C)
        qkv_b = _n(lp['qkv']['bias'])
        c = qkv_w.shape[0]
        for j, nm in enumerate(('query', 'key', 'value')):
            put(p + f'attention.attention.{nm}.weight',
                qkv_w[:, j * c:(j + 1) * c].T)
            put(p + f'attention.attention.{nm}.bias',
                qkv_b[j * c:(j + 1) * c])
        put(p + 'attention.output.dense.weight',
            _n(lp['attn_out']['kernel']).T)
        put(p + 'attention.output.dense.bias', lp['attn_out']['bias'])
        put(p + 'layer_scale1.lambda1', lp['layerscale1'])
        put(p + 'norm2.weight', lp['norm2']['scale'])
        put(p + 'norm2.bias', lp['norm2']['bias'])
        # the SwiGLU FFN of DINOv2-giant (HF Dinov2SwiGLUFFN) or the MLP
        for nm in (('weights_in', 'weights_out') if 'weights_in' in lp
                   else ('fc1', 'fc2')):
            put(p + f'mlp.{nm}.weight', _n(lp[nm]['kernel']).T)
            put(p + f'mlp.{nm}.bias', lp[nm]['bias'])
        put(p + 'layer_scale2.lambda1', lp['layerscale2'])
    return out


# ------------------------------------------------------------------ ddetr

def export_ddetr_transformer(params: dict, encoder_layers: int,
                             decoder_layers: int,
                             prefix: str = '') -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[prefix + 'level_embed'] = _n(params['level_embed'])
    out[prefix + 'query_position_embeddings.weight'] = _n(
        params['query_position_embeddings'])
    _inv_dense(out, prefix + 'enc_output', params['enc_output'])
    _inv_ln(out, prefix + 'enc_output_norm', params['enc_output_norm'])
    _inv_dense(out, prefix + 'pos_trans', params['pos_trans'])
    _inv_ln(out, prefix + 'pos_trans_norm', params['pos_trans_norm'])
    _inv_dense(out, prefix + 'class_embed_enc', params['class_embed_enc'])
    for i in range(encoder_layers):
        lp = params[f'encoder_layers_{i}']
        p = f'{prefix}encoder.layers.{i}.'
        _inv_msda(out, p + 'self_attn.', lp['self_attn'])
        _inv_ln(out, p + 'self_attn_layer_norm', lp['self_attn_layer_norm'])
        _inv_dense(out, p + 'fc1', lp['fc1'])
        _inv_dense(out, p + 'fc2', lp['fc2'])
        _inv_ln(out, p + 'final_layer_norm', lp['final_layer_norm'])
    for i in range(decoder_layers):
        lp = params[f'decoder_layers_{i}']
        p = f'{prefix}decoder.layers.{i}.'
        _inv_dense(out, p + 'self_attn.q_proj', lp['self_attn_q'])
        _inv_dense(out, p + 'self_attn.k_proj', lp['self_attn_k'])
        _inv_dense(out, p + 'self_attn.v_proj', lp['self_attn_v'])
        _inv_dense(out, p + 'self_attn.out_proj', lp['self_attn_out'])
        _inv_ln(out, p + 'self_attn_layer_norm', lp['self_attn_layer_norm'])
        _inv_msda(out, p + 'encoder_attn.', lp['encoder_attn'])
        _inv_ln(out, p + 'encoder_attn_layer_norm',
                lp['encoder_attn_layer_norm'])
        _inv_dense(out, p + 'fc1', lp['fc1'])
        _inv_dense(out, p + 'fc2', lp['fc2'])
        _inv_ln(out, p + 'final_layer_norm', lp['final_layer_norm'])
    for i in range(decoder_layers):
        _inv_dense(out, f'{prefix}class_embed_coco.{i}',
                   params[f'class_embed_coco_{i}'])
        _inv_dense(out, f'{prefix}class_embed_sa1b.{i}',
                   params[f'class_embed_sa1b_{i}'])
    for i in range(decoder_layers + 1):
        _inv_mlp3(out, f'{prefix}bbox_embed.{i}.', params[f'bbox_embed_{i}'])
    return out


def export_input_proj(params: dict, num_feature_levels: int,
                      prefix: str = 'input_proj.') -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if num_feature_levels == 1:
        _inv_conv(out, prefix + '0.0', params['input_proj_0']['conv0'])
        _inv_ln(out, prefix + '0.1', params['input_proj_0']['ln0'])
        return out
    order = list(range(num_feature_levels))[::-1]
    for i, recipe in enumerate(order):
        lp = params[f'input_proj_{i}']
        p = f'{prefix}{i}.'
        if recipe in (0, 1):
            _inv_conv(out, p + '0', lp['conv0'])
            _inv_ln(out, p + '1', lp['ln0'])
        elif recipe == 2:
            _inv_convt(out, p + '0', lp['convt0'])
            _inv_conv(out, p + '1', lp['conv1'])
            _inv_ln(out, p + '2', lp['ln0'])
            _inv_conv(out, p + '3', lp['conv2'])
        elif recipe == 3:
            _inv_convt(out, p + '0', lp['convt0'])
            _inv_ln(out, p + '1', lp['ln0'])
            _inv_convt(out, p + '3', lp['convt1'])
            _inv_conv(out, p + '4', lp['conv1'])
            _inv_ln(out, p + '5', lp['ln1'])
            _inv_conv(out, p + '6', lp['conv2'])
    return out


def export_perceiver(params: dict, vit_layers: int, encoder_layers: int,
                     decoder_layers: int, num_feature_levels: int,
                     patch_size: int = 14,
                     prefix: str = '') -> Dict[str, np.ndarray]:
    out = export_dinov2(params['vis_encoder'], vit_layers, patch_size,
                        prefix=prefix + 'vis_encoder.')
    ip = export_input_proj(params, num_feature_levels)
    out.update({prefix + k: v for k, v in ip.items()})
    out.update(export_ddetr_transformer(
        params['ddetr_transformer'], encoder_layers, decoder_layers,
        prefix=prefix + 'ddetr_transformer.'))
    return out


# ---------------------------------------------------------- region encoder

def export_region_encoder(params: dict, num_levels: int = 3,
                          num_fuse: int = 5, embed_dims: int = 1024,
                          roi_out: int = 14,
                          prefix: str = '') -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    fuse = params['mlvl_fuse']
    for lvl in range(num_levels):
        _inv_conv(out, f'{prefix}mlvl_fuse.input_conv.{lvl}',
                  fuse[f'input_conv_{lvl}'])
    for i in range(num_fuse):
        out[f'{prefix}mlvl_fuse.fuse_convs.{i}.conv.weight'] = _n(
            fuse[f'fuse_conv_{i}']['conv']['kernel']).transpose(3, 2, 0, 1)
        _inv_ln(out, f'{prefix}mlvl_fuse.fuse_convs.{i}.gn',
                fuse[f'fuse_conv_{i}']['gn'])
    for lvl in range(num_levels):
        _inv_conv(out, f'{prefix}roi_align.pconvs.{lvl}',
                  {'kernel': params[f'pconv_kernel_{lvl}'],
                   'bias': params[f'pconv_bias_{lvl}']})
    _inv_dense(out, prefix + 'roi_align.pos_embedd.0', params['pos_fc1'])
    _inv_ln(out, prefix + 'roi_align.pos_embedd.2', params['pos_ln1'])
    _inv_dense(out, prefix + 'roi_align.pos_embedd.3', params['pos_fc2'])
    _inv_ln(out, prefix + 'roi_align.pos_embedd.5', params['pos_ln2'])
    _inv_dense(out, prefix + 'roi_align.updims', params['updims'])
    # inverse of the NCHW->NHWC flatten permutation (hf_import:383-388)
    w = _n(params['flatten_linear']['kernel']).T       # (out, H*W*C)
    out_dim = w.shape[0]
    w = w.reshape(out_dim, roi_out, roi_out, embed_dims)
    w = w.transpose(0, 3, 1, 2).reshape(out_dim, -1)   # -> (out, C*H*W)
    out[prefix + 'roi_align.flatten_linear.weight'] = w
    out[prefix + 'roi_align.flatten_linear.bias'] = _n(
        params['flatten_linear']['bias'])
    return out


# ------------------------------------------------------------------ groma

def export_groma(params: dict, cfg) -> Dict[str, np.ndarray]:
    """Full flax GromaModel params -> reference Groma state dict
    (inverse of loader.import_groma; reference module tree
    groma/model/groma.py:96-124)."""
    out = export_perceiver(
        params['perceiver'], cfg.perceiver.vit.num_layers,
        cfg.perceiver.ddetr.encoder_layers,
        cfg.perceiver.ddetr.decoder_layers,
        cfg.perceiver.ddetr.num_feature_levels,
        patch_size=cfg.perceiver.vit.patch_size, prefix='perceiver.')
    out.update(export_region_encoder(
        params['region_encoder'], num_levels=3,
        num_fuse=cfg.region_num_fuse,
        embed_dims=cfg.perceiver.vit.hidden_size,
        roi_out=cfg.region_roi_out, prefix='region_encoder.'))
    _inv_dense(out, 'img_txt_bridge.0', params['bridge_fc1'])
    _inv_dense(out, 'img_txt_bridge.2', params['bridge_fc2'])
    out['new_input_embs.weight'] = _n(params['new_input_embs'])
    out['extra_lm_head.weight'] = _n(params['extra_lm_head']['kernel']).T
    out.update(export_llama(
        {'model': params['llm'], 'embed_tokens': params['embed_tokens'],
         'lm_head': params['lm_head']},
        cfg.llm.num_layers, prefix='llm.'))
    return out


def save_safetensors(sd: Dict[str, np.ndarray], path: str):
    """Write a state dict as .safetensors (HF's standard container)."""
    from safetensors.numpy import save_file
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)


def export_config(cfg) -> dict:
    """GromaConfig -> the reference's nested config.json dict — the exact
    inverse of loader.hf_groma_config, so an exported directory reloads
    through the same HF-checkpoint path as the released checkpoints
    (reference: groma/model/groma.py:31-83 nested-config serialization)."""
    vit, ddetr, llm = cfg.perceiver.vit, cfg.perceiver.ddetr, cfg.llm
    return {
        'model_type': 'groma',
        'llm_cfg': {
            'compute_dtype': llm.dtype,
            'vocab_size': llm.vocab_size,
            'hidden_size': llm.hidden_size,
            'intermediate_size': llm.intermediate_size,
            'num_hidden_layers': llm.num_layers,
            'num_attention_heads': llm.num_heads,
            'num_key_value_heads': llm.num_kv_heads,
            'max_position_embeddings': llm.max_position_embeddings,
            'rope_theta': llm.rope_theta,
            'rms_norm_eps': llm.rms_norm_eps,
        },
        'perceiver_cfg': {
            'vis_encoder_cfg': {
                'compute_dtype': vit.dtype,
                'hidden_size': vit.hidden_size,
                'num_hidden_layers': vit.num_layers,
                'num_attention_heads': vit.num_heads,
                'mlp_ratio': vit.mlp_ratio,
                'patch_size': vit.patch_size,
                'image_size': vit.image_size,
                'layerscale_value': vit.layerscale_value,
                'use_swiglu_ffn': vit.use_swiglu_ffn,
            },
            'ddetr_cfg': {
                'compute_dtype': ddetr.dtype,
                'd_model': ddetr.d_model,
                'num_queries': ddetr.num_queries,
                'encoder_layers': ddetr.encoder_layers,
                'decoder_layers': ddetr.decoder_layers,
                'encoder_attention_heads': ddetr.num_heads,
                'encoder_ffn_dim': ddetr.ffn_dim,
                'num_feature_levels': ddetr.num_feature_levels,
                'encoder_n_points': ddetr.enc_n_points,
                'decoder_n_points': ddetr.dec_n_points,
                'num_labels': ddetr.num_labels,
                'two_stage': ddetr.two_stage,
                'with_box_refine': ddetr.with_box_refine,
                'focal_alpha': ddetr.focal_alpha,
            },
            'vis_output_layer': cfg.perceiver.vis_output_layer,
            'deploy_image_size': cfg.perceiver.image_size,
        },
        'num_new_token': cfg.num_new_token,
        'nms_thres': cfg.nms_thres,
        'box_score_thres': cfg.box_score_thres,
        'max_region_num': cfg.max_region_num,
        'num_image_tokens': cfg.num_image_tokens,
        'max_seq_len': cfg.max_seq_len,
        'region_roi_out': cfg.region_roi_out,
        'region_num_fuse': cfg.region_num_fuse,
        'region_gn_groups': cfg.region_gn_groups,
    }


def export_hf_dir(params: dict, cfg, out_dir: str):
    """Write a complete HF-layout checkpoint directory
    (config.json + model.safetensors) that loader.load_groma re-reads."""
    import json
    import os
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'config.json'), 'w') as f:
        json.dump(export_config(cfg), f, indent=1)
    save_safetensors(export_groma(params, cfg),
                     os.path.join(out_dir, 'model.safetensors'))
