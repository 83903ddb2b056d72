"""Two-stage Deformable-DETR region proposer, inference (counterpart of
``groma_tpu/models/ddetr.py``), under the reference's parameter names.

Reproduced as in the JAX package: per-cell anchors with wh 0.05 * 2^level
and the (0.01, 0.99) validity window; top-k by the first class logit of
``class_embed_enc``; decoder cross-attention at the INITIAL top-k
reference points (the reference never updates them per layer) while the
per-layer box heads chain their refinements; dual coco / sa1b objectness
heads; query targets from a learned embedding.  All masks are valid.
"""

from __future__ import annotations

import torch
from torch import nn

from groma_tpu.config import DDETRConfig
from groma_tpu_torch.models.layers import (MLP, multi_head_attention,
                                           proposal_position_embedding,
                                           sine_position_embedding_2d)
from groma_tpu_torch.ops.bbox import inverse_sigmoid
from groma_tpu_torch.ops.msda import (ms_deform_attn_dense,
                                      sampling_locations_from_reference)

PROPOSAL_INF = 1e4


class MSDAttention(nn.Module):
    def __init__(self, c: DDETRConfig, n_points: int, device=None):
        super().__init__()
        d, nh, nl = c.d_model, c.num_heads, c.num_feature_levels
        self.num_heads, self.n_points = nh, n_points
        kw = dict(device=device)
        self.value_proj = nn.Linear(d, d, **kw)
        self.sampling_offsets = nn.Linear(d, nh * nl * n_points * 2, **kw)
        self.attention_weights = nn.Linear(d, nh * nl * n_points, **kw)
        self.output_proj = nn.Linear(d, d, **kw)

    def forward(self, query, reference_points, value, spatial_shapes):
        b, s, d = value.shape
        q = query.shape[1]
        nh, nl, np_ = self.num_heads, len(spatial_shapes), self.n_points
        v = self.value_proj(value).reshape(b, s, nh, d // nh)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, np_, 2)
        attn = torch.softmax(
            self.attention_weights(query).reshape(b, q, nh, nl * np_), -1)
        attn = attn.reshape(b, q, nh, nl, np_)
        loc = sampling_locations_from_reference(reference_points, offsets,
                                                spatial_shapes, np_)
        out = ms_deform_attn_dense(v, spatial_shapes, loc, attn)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, c: DDETRConfig, device=None):
        super().__init__()
        kw = dict(device=device)
        self.self_attn = MSDAttention(c, c.enc_n_points, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(c.d_model,
                                                 eps=c.layer_norm_eps, **kw)
        self.fc1 = nn.Linear(c.d_model, c.ffn_dim, **kw)
        self.fc2 = nn.Linear(c.ffn_dim, c.d_model, **kw)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps,
                                             **kw)

    def forward(self, hidden, pos, reference_points, spatial_shapes):
        attn = self.self_attn(hidden + pos, reference_points, hidden,
                              spatial_shapes)
        hidden = self.self_attn_layer_norm(hidden + attn)
        h = self.fc2(torch.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + h)


class _DecoderSelfAttention(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        kw = dict(device=device)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)


class DecoderLayer(nn.Module):
    def __init__(self, c: DDETRConfig, device=None):
        super().__init__()
        kw = dict(device=device)
        d = c.d_model
        self.num_heads = c.num_heads
        self.self_attn = _DecoderSelfAttention(d, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=c.layer_norm_eps,
                                                 **kw)
        self.encoder_attn = MSDAttention(c, c.dec_n_points, **kw)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=c.layer_norm_eps,
                                                    **kw)
        self.fc1 = nn.Linear(d, c.ffn_dim, **kw)
        self.fc2 = nn.Linear(c.ffn_dim, d, **kw)
        self.final_layer_norm = nn.LayerNorm(d, eps=c.layer_norm_eps, **kw)

    def forward(self, hidden, query_pos, encoder_hidden, reference_points,
                spatial_shapes):
        sa = self.self_attn
        qk = hidden + query_pos
        out = multi_head_attention(sa.q_proj(qk), sa.k_proj(qk),
                                   sa.v_proj(hidden), self.num_heads)
        hidden = self.self_attn_layer_norm(hidden + sa.out_proj(out))
        ca = self.encoder_attn(hidden + query_pos, reference_points,
                               encoder_hidden, spatial_shapes)
        hidden = self.encoder_attn_layer_norm(hidden + ca)
        h = self.fc2(torch.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + h)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def encoder_reference_points(spatial_shapes, device=None) -> torch.Tensor:
    """(S, L, 2) normalized cell centers (valid ratios 1)."""
    refs = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ry, rx, indexing='ij')
        refs.append(torch.stack([xx, yy], -1).reshape(h * w, 2))
    ref = torch.cat(refs, 0)
    return ref[:, None, :].expand(-1, len(spatial_shapes), -1)


class DDETRTransformer(nn.Module):
    """Encoder, two-stage proposals, decoder and heads.  ``forward`` takes
    the projected sources (list of (B, H, W, d_model)) and returns logits
    {'coco', 'sa1b'} (B, Q, num_labels), pred_boxes (B, Q, 4) cxcywh, the
    encoder's class logits and boxes, and the initial reference points."""

    def __init__(self, c: DDETRConfig, device=None):
        super().__init__()
        if not (c.two_stage and c.with_box_refine):
            raise ValueError('Groma ships the two-stage box-refine DDETR')
        kw = dict(device=device)
        d = c.d_model
        self.cfg = c
        self.level_embed = nn.Parameter(
            torch.zeros(c.num_feature_levels, d, **kw))
        self.query_position_embeddings = nn.Embedding(c.num_queries, d, **kw)
        self.enc_output = nn.Linear(d, d, **kw)
        self.enc_output_norm = nn.LayerNorm(d, eps=c.layer_norm_eps, **kw)
        self.pos_trans = nn.Linear(2 * d, 2 * d, **kw)
        self.pos_trans_norm = nn.LayerNorm(2 * d, eps=c.layer_norm_eps, **kw)
        self.class_embed_enc = nn.Linear(d, c.num_labels, **kw)
        self.encoder = _Layers(EncoderLayer(c, **kw)
                               for _ in range(c.encoder_layers))
        self.decoder = _Layers(DecoderLayer(c, **kw)
                               for _ in range(c.decoder_layers))
        self.class_embed_coco = nn.ModuleList(
            nn.Linear(d, c.num_labels, **kw) for _ in range(c.decoder_layers))
        self.class_embed_sa1b = nn.ModuleList(
            nn.Linear(d, c.num_labels, **kw) for _ in range(c.decoder_layers))
        self.bbox_embed = nn.ModuleList(
            MLP(d, 256, 4, 3, **kw) for _ in range(c.decoder_layers + 1))

    def forward(self, sources):
        c = self.cfg
        b = sources[0].shape[0]
        dev = sources[0].device
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in sources)
        if len(spatial_shapes) != c.num_feature_levels:
            raise ValueError('one source per feature level')

        flat, pos_flat = [], []
        for lvl, src in enumerate(sources):
            h, w = spatial_shapes[lvl]
            flat.append(src.reshape(b, h * w, c.d_model))
            pos = sine_position_embedding_2d(h, w, c.d_model, device=dev)
            pos_flat.append(pos.reshape(1, h * w, c.d_model)
                            + self.level_embed[lvl][None, None])
        src_flat = torch.cat(flat, dim=1)
        pos_flat = torch.cat(pos_flat, dim=1).expand_as(src_flat)

        enc_ref = encoder_reference_points(spatial_shapes, dev)[None]
        enc_ref = enc_ref.expand(b, -1, -1, -1)
        hidden = src_flat
        for layer in self.encoder.layers:
            hidden = layer(hidden, pos_flat, enc_ref, spatial_shapes)
        encoder_hidden = hidden

        # two-stage proposals: a box per cell, logit space, validity window
        proposals = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            yy, xx = torch.meshgrid(gy, gx, indexing='ij')
            wh = torch.full((h, w, 2), 0.05 * (2.0 ** lvl), device=dev)
            prop = torch.cat([torch.stack([xx, yy], -1), wh], -1)
            proposals.append(prop.reshape(h * w, 4))
        output_proposals = torch.cat(proposals, 0)[None]
        valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(
            -1, keepdim=True)
        output_proposals = torch.log(output_proposals
                                     / (1.0 - output_proposals))
        output_proposals = torch.where(valid, output_proposals, PROPOSAL_INF)

        object_query = torch.where(valid, encoder_hidden, 0.0)
        object_query = self.enc_output_norm(self.enc_output(object_query))
        enc_outputs_class = self.class_embed_enc(object_query)
        enc_outputs_coord_logits = self.bbox_embed[-1](object_query) \
            + output_proposals

        topk_idx = torch.topk(enc_outputs_class[..., 0], c.num_queries,
                              dim=1).indices
        topk_coords_logits = torch.gather(
            enc_outputs_coord_logits, 1, topk_idx[..., None].expand(-1, -1, 4))
        reference_points = torch.sigmoid(topk_coords_logits)

        pos_trans = self.pos_trans_norm(self.pos_trans(
            proposal_position_embedding(topk_coords_logits,
                                        num_pos_feats=c.d_model // 2)))
        query_pos = pos_trans[..., :c.d_model]
        target = self.query_position_embeddings.weight[None].expand(
            b, -1, -1)

        nl = len(spatial_shapes)
        ref_input = reference_points[:, :, None, :].expand(-1, -1, nl, -1)
        inv_ref = inverse_sigmoid(reference_points)
        hidden = target
        refs = [reference_points]      # refs[i]: the box the head i refines
        for i, layer in enumerate(self.decoder.layers):
            hidden = layer(hidden, query_pos, encoder_hidden, ref_input,
                           spatial_shapes)
            if i < len(self.decoder.layers) - 1:
                refs.append(torch.sigmoid(self.bbox_embed[i](hidden)
                                          + inv_ref))
        last = len(self.decoder.layers) - 1
        pred_boxes = torch.sigmoid(self.bbox_embed[last](hidden)
                                   + inverse_sigmoid(refs[last]))
        return {
            'logits': {'coco': self.class_embed_coco[last](hidden),
                       'sa1b': self.class_embed_sa1b[last](hidden)},
            'pred_boxes': pred_boxes,
            'enc_outputs_class': enc_outputs_class,
            'enc_outputs_coord': torch.sigmoid(enc_outputs_coord_logits),
            'init_reference_points': reference_points,
        }
