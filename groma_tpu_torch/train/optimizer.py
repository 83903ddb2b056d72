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
  read at the count of updates already applied, which lives on the
  device with the rest of the update (a CUDA graph captures the update;
  checkpoints keep torch.optim.AdamW's format);
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
    max(total_steps, 2), 0)``: step -> lr, and ``schedule.on_device(count)``
    the same value (f64) from a device tensor, for an update that reads
    nothing back to the host."""
    warmup = max(warmup_steps or int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, 2) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        count = min(step - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    def on_device(step: torch.Tensor) -> torch.Tensor:
        # the host formula's operations in its order, in f64
        step = step.double()
        count = (step - warmup).clamp(max=decay)
        decayed = base_lr * 0.5 * (1.0 + torch.cos(math.pi * count / decay))
        return torch.where(step < warmup, base_lr * step / warmup, decayed)
    schedule.on_device = on_device
    return schedule


def constant_schedule(lr: float):
    """A fixed learning rate, as a schedule (``on_device`` as above)."""
    def schedule(step: int) -> float:
        return lr
    schedule.on_device = lambda step: torch.full(
        (), lr, dtype=torch.float64, device=step.device)
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


class _DeviceAdamW(torch.optim.AdamW):
    """torch.optim.AdamW's parameter groups, state and checkpoint format,
    stepped with the arithmetic on the device: the step count ``count`` is
    one 0-d f32 tensor (every parameter's state ``step``), the rate is
    ``schedule.on_device(count)`` times each group's ``mult``, and nothing
    is read back to the host, so a CUDA graph can capture the step."""

    def __init__(self, groups, schedule, count: torch.Tensor, betas, eps):
        super().__init__(groups, lr=0.0, betas=betas, eps=eps)
        self.schedule = schedule
        self.count = count

    def init_state(self):
        """Zero moments for every parameter that has none (made eagerly,
        before any capture, so they outlive every graph)."""
        for group in self.param_groups:
            for p in group['params']:
                st = self.state[p]
                if 'exp_avg' not in st:
                    st['exp_avg'] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st['exp_avg_sq'] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                st['step'] = self.count

    @torch.no_grad()
    def step(self, closure=None):
        self.init_state()
        lr = self.schedule.on_device(self.count)     # at the updates applied
        self.count.add_(1)
        step = self.count.double()
        for group in self.param_groups:
            b1, b2 = group['betas']
            params = [_local(p) for p in group['params']]
            grads = [_local(p.grad) for p in group['params']]
            m = [_local(self.state[p]['exp_avg']) for p in group['params']]
            v = [_local(self.state[p]['exp_avg_sq'])
                 for p in group['params']]
            group_lr = lr * group['mult']
            if group['weight_decay']:
                torch._foreach_mul_(params, (
                    1 - group_lr * group['weight_decay']).float())
            torch._foreach_lerp_(m, grads, 1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, 1 - b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, (1 - b2 ** step).sqrt().float())
            torch._foreach_add_(denom, group['eps'])
            upd = torch._foreach_div(m, denom)
            torch._foreach_mul_(upd, (group_lr / (1 - b1 ** step)).float())
            torch._foreach_sub_(params, upd)


class AdamW:
    """AdamW over the trainable parameters of ``model``, with the schedule,
    multipliers, clipping and accumulation above.

    Each micro-batch's backward adds into gradients that are allocated
    once (``prepare``) and zeroed in place, so their addresses never
    change.  As optax.MultiSteps splits accumulation: :meth:`tick` counts a
    micro-batch on the host and says whether it ends an accumulation, and
    :meth:`update` divides, clips, applies and zeroes on the device,
    reading nothing back (a CUDA graph captures it).  :meth:`step` is the
    two together, for a caller that runs its own backward."""

    def __init__(self, model: nn.Module, learning_rate, weight_decay=0.0,
                 b1=0.9, b2=0.999, eps=1e-8,
                 max_grad_norm: Optional[float] = None,
                 lr_mult_rules: Sequence[tuple] = (),
                 frozen_pred: Optional[Callable[[str], bool]] = None,
                 accum_steps: int = 1):
        self.schedule = learning_rate if callable(learning_rate) \
            else constant_schedule(learning_rate)
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self.micro = 0
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
        # FSDP assigns each backward's reduce-scattered gradient shards
        # itself: its parameters' gradients are left to it, made at the
        # update where missing and freed after it (such a step runs
        # eagerly, under a process group)
        self.fsdp = any(hasattr(p, 'placements') for p in self.params)
        device = self.params[0].device if self.params else None
        self.opt = _DeviceAdamW(
            [{'params': [p for _, p in ps], 'mult': mult,
              'weight_decay': decay}
             for (mult, decay), ps in groups.items()],
            self.schedule, torch.zeros((), dtype=torch.float32,
                                       device=device),
            betas=(b1, b2), eps=eps)

    @property
    def count(self) -> int:
        """Updates applied (a host read of the device count)."""
        return int(self.opt.count.item())

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def prepare(self):
        """Allocate the gradients (zero) and the moments where missing."""
        if not self.fsdp:
            self._zero_missing_grads()
        self.opt.init_state()

    def _zero_missing_grads(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def tick(self) -> bool:
        """Count one micro-batch -> whether it is the last of
        ``accum_steps`` (its step then updates)."""
        self.micro += 1
        return self.micro % self.accum_steps == 0

    @torch.no_grad()
    def update(self):
        """Average the accumulated gradients, clip, update and zero them."""
        # optax updates every leaf: a trainable parameter the loss did not
        # reach (the idle objectness head of a single-source batch) keeps
        # a zero gradient, so its moments and decay move as in JAX
        self._zero_missing_grads()
        self.opt.init_state()
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
        self.opt.step()
        if self.fsdp:
            self.opt.zero_grad(set_to_none=True)
        else:
            torch._foreach_zero_(local)

    def step(self) -> bool:
        """Count one micro-batch; on the last of ``accum_steps``, update.
        Returns whether an update was applied."""
        if not self.tick():
            return False
        self.update()
        return True

    def state_dict(self) -> dict:
        """torch.optim.AdamW's form: each parameter's ``step`` a host
        tensor of its own, which that optimizer's step can take."""
        osd, count = self.opt.state_dict(), self.count
        osd['state'] = {i: {**st, 'step': torch.tensor(float(count))}
                        for i, st in osd['state'].items()}
        return {'opt': osd, 'micro': self.micro, 'count': count}

    def load_state_dict(self, sd: dict):
        """A state of this optimizer or of torch.optim.AdamW's (each
        parameter's ``step`` a tensor of its own): the count goes back to
        the device, shared by every parameter's state again."""
        self.opt.load_state_dict(sd['opt'])
        self.micro = sd['micro']
        self.opt.count.fill_(sd['count'])
        for st in self.opt.state.values():
            st['step'] = self.opt.count


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
