"""The VL training step in its captured form and the optimizer that a CUDA
graph can capture, on the CPU, against the JAX package.

On the card ``train/steps.make_vl_train_step`` runs as CUDA graphs
(``utils/graphs.TrainGraph``), one per accumulation role; on the CPU the
same parts run eagerly, so these tests hold that form against JAX's
jitted step:

* three micro-batches at ``gradient_accumulation_steps`` 2 against
  ``optax.MultiSteps``: each micro-batch's loss within 1e-5 relative, the
  parameters after them within 1e-4 absolute (test_torch_train.py's
  tolerances), the gradient the third micro-batch accumulated within
  1e-4 of MultiSteps' accumulator (relative Frobenius norm over every
  trained leaf) and the ``updated`` flags;
* the device-side learning rate: ``cosine_schedule(...).on_device`` equals the
  host schedule at every count, warmup included (4 f64 units), and the
  update applies it, times each group's multiplier, at the count of
  updates already applied;
* a resume from a checkpoint equals continuing: bitwise for this
  optimizer's own, and within 1e-6 both ways against a checkpoint of the
  earlier ``torch.optim.AdamW`` step (``_EagerAdamW``, the port's step
  before it was captured), whose arithmetic differs in its rounding;
* the host-read guard (``host_guard.py``) on every captured part, both
  roles, and on the earlier step, which it catches.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_groma
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_vl_train_step as j_make_step
from groma_tpu_torch.checkpoint.loader import (from_jax_params,
                                               random_groma_full)
from groma_tpu_torch.config import tiny_groma_config as port_tiny_config
from groma_tpu_torch.train import optimizer as topt
from groma_tpu_torch.train.steps import (BATCH_KEYS, batch_to,
                                          make_vl_train_step)
from groma_tpu_torch.train.synthetic import grounded_batch
from groma_tpu_torch.train.train_vl import maybe_resume, save_checkpoint
from host_guard import guard_parts, no_host_reads

torch.set_num_threads(2)
CFG = tiny_groma_config()
PORT_CFG = port_tiny_config()
LR = 1e-3
ACCUM = 2
LOSS_TOL = 1e-5       # relative
PARAM_TOL = 1e-4      # absolute
GRAD_TOL = 1e-4       # relative Frobenius, the accumulated gradient
RESUME_TOL = 1e-6     # absolute, against the torch.optim.AdamW step


def _batches(n, seed=0):
    return [grounded_batch(PORT_CFG, 2, seed + i, answer_lens=(40, 20))
            for i in range(n)]


@pytest.fixture(scope='module')
def accumulated():
    """Three micro-batches through each package's step at accumulation 2
    (stage 2, vl_pretrain.sh: the perceiver and the LLM frozen) -> (JAX
    losses, JAX params, JAX MultiSteps
    accumulator, port losses, port updated flags, port model)."""
    jmodel = JGroma(CFG)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            **_dummy_batch(CFG)))()['params'])
    tx = optax.MultiSteps(jopt.make_adamw(
        LR, frozen_pred=jopt.freeze_predicate(freeze_perceiver=True,
                                              freeze_llm=True)), ACCUM)
    step = jax.jit(j_make_step(jmodel, tx, permute_regions=False))
    state = TrainState.create(params, tx)
    batches = _batches(3)
    jlosses = []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(b[k])
                                      for k in BATCH_KEYS},
                              jax.random.PRNGKey(1))
        jlosses.append(float(metrics['loss']))
    tmodel = from_jax_params(params, CFG, full_precision=True)
    opt = topt.make_adamw(tmodel, LR, frozen_pred=topt.freeze_predicate(
        freeze_perceiver=True, freeze_llm=True), accum_steps=ACCUM)
    tstep = make_vl_train_step(tmodel, opt, permute_regions=False)
    outs = [tstep(batch_to(b, 'cpu')) for b in batches]
    np_tree = jax.tree_util.tree_map(np.asarray, state.params)
    acc = jax.tree_util.tree_map(np.asarray, state.opt_state.acc_grads)
    return (jlosses, np_tree, acc, [float(o['loss']) for o in outs],
            [o['updated'] for o in outs], tmodel, tstep)


def test_accumulated_losses_match_multisteps(accumulated):
    jlosses, _, _, tlosses, updated, _, step = accumulated
    assert step.mode == 'eager (CPU)'
    assert updated == [False, True, False]
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL)


def test_accumulated_params_match_multisteps(accumulated):
    _, jparams, _, _, _, tmodel, _ = accumulated
    want = export_groma(jparams, CFG)
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_TOL, rtol=0,
                                   err_msg=k)


def test_third_micro_batch_accumulates_as_multisteps(accumulated):
    """After the update the gradients are zeroed in place and the third
    micro-batch adds into them: MultiSteps' accumulator holds that
    gradient alone."""
    _, _, acc, _, _, tmodel, _ = accumulated
    want = export_groma(acc, CFG)
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()
           if p.requires_grad}
    assert any(k.startswith('region_encoder.') for k in got)
    diff = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum())
                         for k in got))
    norm = math.sqrt(sum(float((want[k] ** 2).sum()) for k in got))
    assert norm > 0 and diff / norm <= GRAD_TOL, diff / norm


# ------------------------------------------------------ the learning rate

@pytest.mark.parametrize('total,warmup_steps,warmup_ratio',
                         [(50, 0, 0.1), (7, 0, 0.0), (1, 0, 0.03),
                          (12, 5, 0.0)])
def test_device_schedule_equals_the_host_schedule(total, warmup_steps,
                                                  warmup_ratio):
    sched = topt.cosine_schedule(2e-4, total, warmup_steps=warmup_steps,
                                 warmup_ratio=warmup_ratio)
    for count in range(total + 3):
        got = sched.on_device(torch.tensor(float(count))).item()
        assert got == pytest.approx(sched(count), rel=1e-15, abs=0), count
    assert sched.on_device(torch.tensor(0.0)).item() == 0.0


def test_update_applies_the_schedule_at_the_updates_applied():
    """With zero gradients AdamW moves a parameter by its decay alone,
    p * (1 - lr * mult * wd): the lr each update applied, read back from
    the parameters, is the schedule's at the count of updates before it
    (0 at the first), times the group's multiplier."""
    model = torch.nn.Module()
    model.lin = torch.nn.Linear(4, 4, bias=False)
    model.sampling_offsets = torch.nn.Linear(4, 4, bias=False)
    for p in model.parameters():
        torch.nn.init.ones_(p)
    sched = topt.cosine_schedule(0.5, 6, warmup_steps=2)
    opt = topt.make_adamw(model, sched, weight_decay=1.0,
                          lr_mult_rules=topt.det_lr_mult_rules(0.1))
    for count in range(8):
        before = [p.detach().double().clone() for p in opt.params]
        opt.prepare()
        with no_host_reads():
            opt.update()
        for p, b, (mult, name) in zip(opt.params, before, (
                (1.0, 'lin'), (0.1, 'sampling_offsets'))):
            applied = (1 - p.detach().double() / b) / mult
            # f32 parameters: two roundings of p, over the multiplier
            np.testing.assert_allclose(applied.numpy(), sched(count),
                                       rtol=0, atol=3e-6, err_msg=name)
    assert opt.count == 8 and opt.lr == sched(8)


# ------------------------------------------------------------- resume

class _EagerAdamW(topt.AdamW):
    """The port's AdamW step before it was captured: torch.optim.AdamW
    (host step counts), the rate written into the groups as a host float,
    and the gradients freed after each update."""

    def __init__(self, model, *a, **kw):
        super().__init__(model, *a, **kw)
        self.count_ = 0
        self.torch_opt = torch.optim.AdamW(
            [{'params': g['params'], 'mult': g['mult'],
              'weight_decay': g['weight_decay']}
             for g in self.opt.param_groups], lr=0.0,
            betas=self.opt.defaults['betas'], eps=self.opt.defaults['eps'])

    def prepare(self):
        pass

    @torch.no_grad()
    def update(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum_steps > 1:
            torch._foreach_div_([p.grad for p in self.params],
                                float(self.accum_steps))
        lr = self.schedule(self.count_)
        for group in self.torch_opt.param_groups:
            group['lr'] = lr * group['mult']
        self.torch_opt.step()
        self.torch_opt.zero_grad(set_to_none=True)
        self.count_ += 1

    def state_dict(self):
        return {'opt': self.torch_opt.state_dict(), 'micro': self.micro,
                'count': self.count_}

    def load_state_dict(self, sd):
        self.torch_opt.load_state_dict(sd['opt'])
        self.micro, self.count_ = sd['micro'], sd['count']


def _resumable(opt_cls=topt.AdamW):
    model = random_groma_full(PORT_CFG, seed=2)
    opt = opt_cls(model, topt.cosine_schedule(LR, 3, warmup_steps=1),
                  weight_decay=0.01,
                  frozen_pred=topt.freeze_predicate(freeze_perceiver=True),
                  accum_steps=ACCUM)
    gen = torch.Generator()
    gen.manual_seed(5)
    return model, opt, gen, make_vl_train_step(model, opt)


def _run(step, gen, batches):
    return [float(step(batch_to(b, 'cpu'), gen)['loss']) for b in batches]


def _trained(model, opt):
    names = set(opt.names)
    return {k: p.detach().clone() for k, p in model.named_parameters()
            if k in names}


@pytest.fixture(scope='module')
def continued():
    """Six micro-batches (three updates) straight through, this
    optimizer -> (losses, trained params, batches)."""
    batches = _batches(6, seed=20)
    model, opt, gen, step = _resumable()
    return _run(step, gen, batches), _trained(model, opt), batches


def test_resume_equals_continuing(continued, tmp_path):
    """Two updates, a checkpoint (model, optimizer, generator), a fresh
    model, optimizer and generator resumed from it, one more update:
    bitwise the run that never stopped."""
    losses, params, batches = continued
    model, opt, gen, step = _resumable()
    first = _run(step, gen, batches[:4])
    save_checkpoint(str(tmp_path), 2, model, opt, PORT_CFG, keep=1,
                    generator=gen)
    model, opt, gen, step = _resumable()
    assert maybe_resume(str(tmp_path), model, opt, gen) == 2
    assert (opt.count, opt.micro) == (2, 4)
    rest = _run(step, gen, batches[4:])
    assert first + rest == losses
    got = _trained(model, opt)
    assert all(torch.equal(got[k], v) for k, v in params.items())


@pytest.mark.parametrize('writer,reader', [('eager', 'captured'),
                                           ('captured', 'eager')])
def test_resume_across_the_eager_step_format(continued, tmp_path, writer,
                                             reader):
    """A checkpoint of the earlier torch.optim.AdamW step resumes under
    this optimizer, and the other way round: each resumed run within
    RESUME_TOL of the writer's own run continued."""
    _, _, batches = continued
    cls = {'eager': _EagerAdamW, 'captured': topt.AdamW}
    model, opt, gen, step = _resumable(cls[writer])
    _run(step, gen, batches[:4])
    save_checkpoint(str(tmp_path), 2, model, opt, PORT_CFG, keep=1,
                    generator=gen)
    _run(step, gen, batches[4:])
    want = _trained(model, opt)
    model, opt, gen, step = _resumable(cls[reader])
    assert maybe_resume(str(tmp_path), model, opt, gen) == 2
    _run(step, gen, batches[4:])
    got = _trained(model, opt)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=RESUME_TOL, err_msg=k)
    assert opt.micro == 6


# -------------------------------------------------------------- the guard

def test_no_captured_part_reads_back(monkeypatch):
    """Both roles of the VL step (a micro-step, a micro-step and the
    update), the region permutation drawn, under the guard."""
    ran = guard_parts(monkeypatch)
    model, opt, gen, step = _resumable()
    outs = [step(batch_to(b, 'cpu'), gen) for b in _batches(2, seed=30)]
    assert [o['updated'] for o in outs] == [False, True]
    assert ran == ['part 0', 'part 0'] and opt.count == 1


def test_the_guard_catches_the_eager_step():
    model, opt, gen, step = _resumable(_EagerAdamW)
    step(batch_to(_batches(1, seed=40)[0], 'cpu'), gen)   # a micro-step
    opt.micro += 1
    with pytest.raises(AssertionError, match='host'):
        with no_host_reads():
            opt.update()
