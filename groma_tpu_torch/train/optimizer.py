"""AdamW with the reference's parameter-group rules (counterpart of
``groma_tpu/train/optimizer.py``).

The JAX package builds an optax chain over a param tree; here the same
rules apply to the port's parameter names, which are the reference's
state-dict names:
* no weight decay on biases, norm scales, DINOv2's layer scales, CLS token
  and position embedding, and DDETR's level embedding (the JAX no-decay
  names ``bias``, ``scale``, ``layerscale1/2``, ``cls_token``,
  ``pos_embed``, ``level_embed``; the region encoder's pconv biases,
  named otherwise there, are decayed as in the JAX package);
* per-group learning-rate multipliers from ``(predicate(name), mult)``
  rules;
* frozen parameters (JAX ``perceiver/``, ``vis_encoder/``, ``llm/``,
  ``embed_tokens``, ``lm_head/``; here ``perceiver.``, ``vis_encoder.``,
  ``llm.``) get ``requires_grad=False`` and stay out of the optimizer, so
  they get no update, no gradient and no Adam state;
* optax's ``warmup_cosine_decay_schedule`` (lr 0 at step 0), the schedule
  read at the count of updates already applied;
* every trainable parameter updated at every step, a zero gradient where
  the loss does not reach it (optax transforms every leaf);
* optional global-norm clipping over the trainable gradients, and
  gradient accumulation as optax.MultiSteps does it (the mean of
  ``accum_steps`` micro-batch gradients, one update);
* parameters sharded by FSDP (``parallel/mesh.shard_model``, DTensors)
  and cut by tensor parallelism (``model.tp_plan``): the arithmetic runs
  on each rank's shards, and the clipping norm sums each gradient's
  squares over the mesh axes its FSDP shards lie on and, for a tp-cut
  parameter, over the tp group; a parameter whole on every tp rank
  (norms, the vision tower, the region encoder, the bridge) is counted
  once, so the norm is the whole gradient's.  Such a parameter's gradient
  is first averaged over the tp group: the ranks compute it each for
  itself, and on the card kernels that add with atomics give it in
  another order on each, so without the mean the replicas would drift
  apart step by step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from groma_tpu_torch.models.llama import RMSNorm

_NO_DECAY_NAMES = ('lambda1', 'cls_token', 'position_embeddings',
                   'level_embed')
_NORMS = (nn.LayerNorm, nn.GroupNorm, RMSNorm)
# the JAX region encoder names these biases pconv_bias_{lvl}, which its
# rule does not match, so they are decayed there; kept for parity
_DECAYED_BIASES = ('region_encoder.roi_align.pconvs.',)


def no_decay_names(model: nn.Module) -> set:
    """Parameter names the JAX package's ``_no_decay`` leaves undecayed."""
    out = set()
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            full = f'{mname}.{pname}' if mname else pname
            if full.startswith(_DECAYED_BIASES):
                continue
            if pname == 'bias' or pname in _NO_DECAY_NAMES or (
                    isinstance(mod, _NORMS) and pname == 'weight'):
                out.add(full)
    return out


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, warmup_ratio: float = 0.0):
    """HF-Trainer cosine schedule with linear warmup from 0, as optax's
    ``warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total_steps, 2), 0)``: step -> lr."""
    warmup = max(warmup_steps or int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, 2) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        count = min(step - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))
    return schedule


def det_lr_mult_rules(multiplier: float = 0.1):
    return [
        (lambda p: 'vis_encoder' in p, multiplier),
        (lambda p: 'sampling_offsets' in p, multiplier),
    ]


def freeze_predicate(freeze_perceiver=False, freeze_llm=False,
                     freeze_vis_encoder=False):
    """name -> frozen?  ``llm.`` holds the JAX ``llm/``, ``embed_tokens``
    and ``lm_head/`` (the port's LlamaForCausalLM carries all three)."""
    def pred(name: str) -> bool:
        if freeze_perceiver and name.startswith('perceiver.'):
            return True
        if freeze_vis_encoder and (name.startswith('vis_encoder.')
                                   or '.vis_encoder.' in name):
            return True
        return freeze_llm and name.startswith('llm.')
    return pred


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view: writes reach the DTensor),
    or the tensor itself."""
    return t.to_local() if hasattr(t, 'placements') else t


def _sum_of_squares(grads, tp_cut, tp_group) -> torch.Tensor:
    """The squared global norm of ``grads``: each gradient's squares over
    this rank's shard, summed over the groups it is sharded over (the
    mesh axes of its FSDP placement; the tp group where ``tp_cut`` marks
    it), one partial sum for each set of groups."""
    import torch.distributed as dist
    parts = {}
    for i, g in enumerate(grads):
        groups = []
        if hasattr(g, 'placements'):
            groups = [g.device_mesh.get_group(d)
                      for d, pl in enumerate(g.placements) if pl.is_shard()]
        if tp_cut[i]:
            groups.append(tp_group)
        parts.setdefault(tuple(id(gr) for gr in groups), (groups, []))[1] \
            .append((_local(g).float() ** 2).sum())

    def reduced(groups, sqs):
        part = sum(sqs)
        for gr in groups:
            dist.all_reduce(part, group=gr)
        return part
    return sum(reduced(*p) for p in parts.values())


class AdamW:
    """torch.optim.AdamW over the trainable parameters of ``model``, with
    the schedule, multipliers, clipping and accumulation above.  Call
    :meth:`step` after each micro-batch's backward."""

    def __init__(self, model: nn.Module, learning_rate, weight_decay=0.0,
                 b1=0.9, b2=0.999, eps=1e-8,
                 max_grad_norm: Optional[float] = None,
                 lr_mult_rules: Sequence[tuple] = (),
                 frozen_pred: Optional[Callable[[str], bool]] = None,
                 accum_steps: int = 1):
        self.schedule = learning_rate if callable(learning_rate) \
            else (lambda step: learning_rate)
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self.micro = 0
        self.count = 0                      # updates applied
        no_decay = no_decay_names(model)
        groups = {}
        for name, p in model.named_parameters():
            if frozen_pred is not None and frozen_pred(name):
                p.requires_grad_(False)
                continue
            p.requires_grad_(True)
            mult = next((m for pred, m in lr_mult_rules if pred(name)), 1.0)
            decay = weight_decay if name not in no_decay else 0.0
            groups.setdefault((mult, decay), []).append((name, p))
        # the names in the optimizer state's order (checkpoints gather the
        # tp-cut ones)
        self.names = [n for ps in groups.values() for n, _ in ps]
        self.params = [p for ps in groups.values() for _, p in ps]
        plan = getattr(model, 'tp_plan', {})
        self.tp_group = getattr(model, 'tp_group', None)
        self.tp_cut = [n in plan for n in self.names]
        self.opt = torch.optim.AdamW(
            [{'params': [p for _, p in ps], 'mult': mult,
              'weight_decay': decay}
             for (mult, decay), ps in groups.items()],
            lr=0.0, betas=(b1, b2), eps=eps)

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self) -> bool:
        """Count one micro-batch; on the last of ``accum_steps``, average
        the accumulated gradients, clip, update and clear them.  Returns
        whether an update was applied."""
        self.micro += 1
        if self.micro % self.accum_steps:
            return False
        # optax updates every leaf: a trainable parameter the loss did not
        # reach (the idle objectness head of a single-source batch) takes
        # a zero gradient, so its moments and decay move as in JAX
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        local = [_local(g) for g in grads]
        if self.accum_steps > 1:
            torch._foreach_div_(local, float(self.accum_steps))
        if self.tp_group is not None:
            import torch.distributed as dist
            tp = dist.get_world_size(self.tp_group)
            for g, cut in zip(local, self.tp_cut):
                if not cut:
                    dist.all_reduce(g, group=self.tp_group)
                    g.div_(tp)
        if self.max_grad_norm:
            norm = torch.sqrt(_sum_of_squares(grads, self.tp_cut,
                                              self.tp_group))
            # optax.clip_by_global_norm: rescale only at or above the limit
            factor = torch.where(norm < self.max_grad_norm, 1.0,
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(local, factor)
        lr = self.lr
        for group in self.opt.param_groups:
            group['lr'] = lr * group['mult']
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {'opt': self.opt.state_dict(), 'micro': self.micro,
                'count': self.count}

    def load_state_dict(self, sd: dict):
        self.opt.load_state_dict(sd['opt'])
        self.micro, self.count = sd['micro'], sd['count']


def make_adamw(model: nn.Module, learning_rate, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               max_grad_norm: Optional[float] = None,
               lr_mult_rules: Sequence[tuple] = (),
               frozen_pred: Optional[Callable[[str], bool]] = None,
               accum_steps: int = 1) -> AdamW:
    """AdamW with decay masking, per-group lr multipliers and freezing
    (``learning_rate`` a float or a step -> lr schedule)."""
    return AdamW(model, learning_rate, weight_decay, b1, b2, eps,
                 max_grad_norm, lr_mult_rules, frozen_pred, accum_steps)
