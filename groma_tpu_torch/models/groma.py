"""Groma, the grounded multimodal LLM (counterpart of
``groma_tpu/models/groma.py``): vision, token-stream surgery and the
split-vocabulary embedding and heads, under the reference's parameter
names (``perceiver.*``, ``region_encoder.*``, ``img_txt_bridge.*``,
``llm.*``, ``new_input_embs``, ``extra_lm_head``).

Kept from the JAX package: coco^0.4 * sa1b^0.6 score fusion; user refer
boxes injected at score 1.0; fixed-capacity NMS with the argmax-score
fallback box; IoU matching of refer boxes onto the pool; and both
documented deviations from the reference:
  * decode keeps the true key-validity mask instead of an all-ones one;
  * the random region-index permutation is a training option, never
    applied at inference.
Ground boxes and the permutation serve training, which is not ported.

Dtypes follow the JAX model: the ViT and the region encoder's convs and
linears run in ``cfg.perceiver.vit.dtype``, DDETR and the image-text
bridge in f32 (flax promotes the bf16 features against f32 params).
"""

from __future__ import annotations

import torch
from torch import nn

from groma_tpu.config import GromaConfig
from groma_tpu.data.tokenization import SpecialIds
from groma_tpu_torch.models.llama import LlamaForCausalLM, torch_dtype
from groma_tpu_torch.models.perceiver import Perceiver
from groma_tpu_torch.models.region_encoder import RegionEncoder
from groma_tpu_torch.ops.bbox import box_iou, cxcywh_to_xyxy
from groma_tpu_torch.ops.nms import nms


def _ordinal(mask: torch.Tensor) -> torch.Tensor:
    """Per-row running count of True positions (0-based)."""
    return torch.cumsum(mask.to(torch.int64), dim=-1) - 1


class GromaModel(nn.Module):
    def __init__(self, cfg: GromaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        vit_d, llm_d = cfg.perceiver.vit.hidden_size, cfg.llm.hidden_size
        vdt = torch_dtype(cfg.perceiver.vit.dtype)
        self.perceiver = Perceiver(cfg.perceiver, device=device,
                                   vit_dtype=vdt)
        self.region_encoder = RegionEncoder(
            embed_dims=vit_d, out_dims=llm_d,
            image_size=cfg.perceiver.image_size, roi_out=cfg.region_roi_out,
            num_fuse=cfg.region_num_fuse, gn_groups=cfg.region_gn_groups,
            device=device, dtype=vdt)
        self.img_txt_bridge = nn.Sequential(
            nn.Linear(4 * vit_d, llm_d, device=device), nn.GELU(),
            nn.Linear(llm_d, llm_d, device=device))
        self.llm = LlamaForCausalLM(cfg.llm, device=device)
        self.new_input_embs = nn.Embedding(cfg.num_new_token, llm_d,
                                           device=device)
        self.extra_lm_head = nn.Linear(llm_d, cfg.num_new_token, bias=False,
                                       device=device)

    @property
    def sp(self) -> SpecialIds:
        return SpecialIds.from_base_vocab(self.cfg.llm.vocab_size)

    def embed(self, input_ids):
        """Split-vocabulary embedding lookup."""
        base = self.cfg.llm.vocab_size
        is_new = input_ids >= base
        e_base = self.llm.model.embed_tokens(torch.where(is_new, 0, input_ids))
        e_new = self.new_input_embs(torch.where(is_new, input_ids - base, 0))
        return torch.where(is_new[..., None], e_new.to(e_base.dtype), e_base)

    def logits(self, hidden):
        """Dual-head vocabulary projection (lm_head + extra_lm_head)."""
        return torch.cat([self.llm.lm_head(hidden),
                          self.extra_lm_head(hidden)], dim=-1)

    # ------------------------------------------------------------- vision

    def vision(self, images, refer_boxes=None, refer_valid=None):
        """(B, H, W, 3) image -> image tokens, the selected region pool and
        its region tokens.  Boxes are normalized cxcywh; refer boxes are
        fixed-capacity (B, R, 4) with a validity mask."""
        c = self.cfg
        b = images.shape[0]
        hidden_states = self.perceiver.encode_image(images)

        # image tokens: last hidden, CLS dropped, 2x2 space-to-depth
        feats = hidden_states[c.perceiver.vis_output_layer][:, 1:]
        _, l, d = feats.shape
        g = int(round(l ** 0.5))
        f2 = feats.reshape(b, g, g, d)
        img_tokens = torch.cat([f2[:, 0::2, 0::2], f2[:, 1::2, 0::2],
                                f2[:, 0::2, 1::2], f2[:, 1::2, 1::2]], -1)
        img_tokens = self.img_txt_bridge(
            img_tokens.reshape(b, l // 4, 4 * d).to(torch.float32))

        ddetr_out = self.perceiver.propose(hidden_states)
        pred_boxes = ddetr_out['pred_boxes']
        s_coco = torch.sigmoid(ddetr_out['logits']['coco'][..., 0])
        s_sa1b = torch.sigmoid(ddetr_out['logits']['sa1b'][..., 0])
        scores = s_coco ** c.score_fuse_coco * s_sa1b ** c.score_fuse_sa1b

        dev = pred_boxes.device
        q = pred_boxes.shape[1]
        if refer_boxes is None:
            refer_boxes = pred_boxes.new_zeros((b, 0, 4))
            refer_valid = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        all_boxes = torch.cat([pred_boxes, refer_boxes.to(pred_boxes.dtype)],
                              dim=1)
        all_scores = torch.cat([scores, refer_valid.to(scores.dtype)], dim=1)
        all_valid = torch.cat([torch.ones((b, q), dtype=torch.bool,
                                          device=dev), refer_valid], dim=1)

        keep_idx, keep_mask = nms(cxcywh_to_xyxy(all_boxes), all_scores,
                                  c.nms_thres, c.box_score_thres,
                                  max_num=c.max_region_num, valid=all_valid)
        # fallback: the argmax-score box when nothing survives
        none_kept = ~keep_mask.any(-1)
        arg = torch.argmax(torch.where(all_valid, all_scores, -1.0), dim=-1)
        keep_idx[:, 0] = torch.where(none_kept, arg.to(keep_idx.dtype),
                                     keep_idx[:, 0])
        keep_mask[:, 0] = keep_mask[:, 0] | none_kept

        selected_boxes = torch.gather(
            all_boxes, 1, keep_idx.long()[..., None].expand(-1, -1, 4))
        mlvl = [h[:, 1:] for h in hidden_states[-3:]]
        region_tokens = self.region_encoder(mlvl, selected_boxes)
        return {
            'image_tokens': img_tokens,
            'selected_boxes': selected_boxes,
            'selected_mask': keep_mask,
            'region_tokens': region_tokens,
            'ddetr_out': ddetr_out,
        }

    # ------------------------------------------------- token-stream wiring

    def build_stream(self, input_ids, region_slot, base_valid, vis,
                     refer_boxes=None):
        """Placeholder substitution + masked embedding scatter, fixed
        shapes.  Returns (inputs_embeds, input_ids, valid)."""
        sp = self.sp
        sel_boxes = vis['selected_boxes']
        sel_mask = vis['selected_mask']

        def match(user_boxes):
            iou = box_iou(cxcywh_to_xyxy(user_boxes),
                          cxcywh_to_xyxy(sel_boxes))
            iou = torch.where(sel_mask[:, None, :], iou, -1.0)
            return torch.argmax(iou, dim=-1)                   # (B, Ru)

        def substitute(ids, mask_token_id, matched):
            mask = ids == mask_token_id
            ordn = _ordinal(mask).clamp(0, matched.shape[1] - 1)
            midx = torch.gather(matched, 1, ordn)
            return torch.where(mask, sp.box_idx_start + midx, ids)

        matched_refer = None
        if refer_boxes is not None and refer_boxes.shape[1] > 0:
            matched_refer = match(refer_boxes)
            input_ids = substitute(input_ids, sp.rbox, matched_refer)

        # unused region slots drop out of attention
        slot_ok = torch.gather(
            sel_mask, 1, region_slot.clamp(0, sel_mask.shape[1] - 1).long())
        valid = base_valid & ((region_slot < 0) | slot_ok)

        emb = self.embed(input_ids)

        def scatter(emb, token_mask, table):
            ordn = _ordinal(token_mask).clamp(0, table.shape[1] - 1)
            gathered = torch.gather(
                table, 1, ordn[..., None].expand(-1, -1, table.shape[-1]))
            return torch.where(token_mask[..., None],
                               gathered.to(emb.dtype), emb)

        emb = scatter(emb, input_ids == sp.image, vis['image_tokens'])
        emb = scatter(emb, input_ids == sp.region, vis['region_tokens'])
        if matched_refer is not None:
            refer_feats = torch.gather(
                vis['region_tokens'], 1,
                matched_refer[..., None].expand(
                    -1, -1, vis['region_tokens'].shape[-1]))
            emb = scatter(emb, input_ids == sp.rfeat, refer_feats)
        return emb, input_ids, valid

    def prepare_stream(self, images, input_ids, region_slot, base_valid,
                       refer_boxes=None, refer_valid=None):
        """Vision + surgery: (inputs_embeds, input_ids, valid, vis), for
        the quantized decoder to consume."""
        vis = self.vision(images, refer_boxes, refer_valid)
        emb, ids, valid = self.build_stream(input_ids, region_slot,
                                            base_valid, vis, refer_boxes)
        return emb, ids, valid, vis
