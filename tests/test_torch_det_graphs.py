"""The detection step in its captured form and the detector's evaluation
forward, on the CPU, against the JAX package.

On the card ``train/steps.make_det_train_step`` runs as two CUDA graphs
around the matcher (``utils/graphs.TrainGraph``): part A, the forward and
the matcher's costs; the matcher (Hungarian on the host, the auction's
rounds as a graph of their own); part C, the losses, the backward through
part A's activations and the update.  On the CPU the same parts run
eagerly, so these tests hold that form against JAX's jitted step:

* both sources and both matchers, three steps (train_det's lr rules, the
  first in warmup, the sources alternating as the source-grouped sampler's
  batches do), from parameters off the init's kinks as in
  ``test_torch_det.py``: every loss within 1e-5 relative, the parameters
  within 1e-4 absolute;
* every captured part (A, C and the auction's rounds) under the host-read
  guard (``host_guard.py``), in the order A, the matcher, C;
* the evaluation forward (``eval/det_eval.detector_forward``, the
  ``CallGraph``'s function) under the guard, one graph run per image,
  the perceiver's graphs kept across evaluations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_perceiver
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.perceiver import Perceiver as JPerceiver
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_det_train_step as j_make_det_step
from groma_tpu_torch.eval import det_eval
from groma_tpu_torch.models.perceiver import Perceiver
from groma_tpu_torch.train import optimizer as topt
from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step
from groma_tpu_torch.utils.graphs import CallGraph
from host_guard import guard_parts, no_host_reads

torch.set_num_threads(2)
CFG = tiny_groma_config().perceiver
LR = 2e-4
LOSS_TOL = 1e-5       # relative, every loss key
PARAM_TOL = 1e-4      # absolute
SOURCES = ('coco', 'sa1b', 'coco')
MATCHERS = ('hungarian', 'auction')


def _export(params):
    return export_perceiver(params, CFG.vit.num_layers,
                            CFG.ddetr.encoder_layers, CFG.ddetr.decoder_layers,
                            CFG.ddetr.num_feature_levels,
                            patch_size=CFG.vit.patch_size)


def _port(params):
    model = Perceiver(CFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in _export(params).items()}, strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _params():
    """JAX's Perceiver and its params, a little off the init's kinks (the
    zero-started leaves get noise of std 1e-2)."""
    jmodel = JPerceiver(CFG)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), np.zeros(
        (2, 56, 56, 3), np.float32))['params']
    rng = np.random.default_rng(16)
    return jmodel, jax.tree_util.tree_map(
        lambda p: p if p.any() else
        rng.normal(0.0, 1e-2, p.shape).astype(p.dtype),
        jax.tree_util.tree_map(np.asarray, params))


def _targets(rng, counts, b=2, t=6):
    valid = np.zeros((b, t), bool)
    for i, n in enumerate(counts):
        valid[i, :n] = True
    boxes = np.concatenate([rng.uniform(0.25, 0.7, (b, t, 2)),
                            rng.uniform(0.05, 0.4, (b, t, 2))], -1)
    return {'class_labels': np.zeros((b, t), np.int32),
            'boxes': np.where(valid[..., None], boxes, 0.0).astype(
                np.float32),
            'valid': valid}


def _batches():
    rng = np.random.default_rng(17)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    return [{'images': images, 'targets': _targets(rng, (3, 5))},
            {'images': images[::-1].copy(),
             'targets': _targets(rng, (6, 2))},
            {'images': images, 'targets': _targets(rng, (0, 4))}]


def _optimizers():
    sched = dict(total_steps=4, warmup_steps=1)
    common = dict(weight_decay=1e-4, max_grad_norm=1.0)
    return (jopt.make_adamw(
        jopt.cosine_schedule(LR, **sched),
        lr_mult_rules=jopt.det_lr_mult_rules(0.1),
        frozen_pred=jopt.freeze_predicate(freeze_vis_encoder=True),
        **common),
        lambda model: topt.make_adamw(
            model, topt.cosine_schedule(LR, **sched),
            lr_mult_rules=topt.det_lr_mult_rules(0.1),
            frozen_pred=topt.freeze_predicate(freeze_vis_encoder=True),
            **common))


@pytest.fixture(scope='module', params=MATCHERS)
def steps(request):
    """Three steps of each package's detection step with one matcher ->
    (matcher, JAX losses, JAX params, port losses, port model, port
    steps)."""
    kind = request.param
    jmodel, params = _params()
    tx, port_opt = _optimizers()
    state = TrainState.create(params, tx)
    batches = _batches()
    jsteps = {s: jax.jit(j_make_det_step(jmodel, CFG.ddetr, tx, s,
                                         matcher=kind))
              for s in set(SOURCES)}
    jlosses = []
    for src, b in zip(SOURCES, batches):
        state, losses = jsteps[src](state, jax.tree_util.tree_map(
            jnp.asarray, b))
        jlosses.append({k: float(v) for k, v in losses.items()})
    model = _port(params)
    opt = port_opt(model)
    tsteps = {s: make_det_train_step(model, CFG.ddetr, opt, s, matcher=kind)
              for s in set(SOURCES)}
    tlosses = [{k: float(v) for k, v in
                tsteps[src](det_batch_to(b, 'cpu')).items()}
               for src, b in zip(SOURCES, batches)]
    return (kind, jlosses, jax.tree_util.tree_map(np.asarray, state.params),
            tlosses, model, tsteps)


def test_det_graph_losses_match_jax(steps):
    _, jlosses, _, tlosses, _, tsteps = steps
    assert {s.mode for s in tsteps.values()} == {'eager (CPU)'}
    for want, got in zip(jlosses, tlosses):
        assert got.pop('updated') == 1.0
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL,
                                       atol=1e-7, err_msg=k)


def test_det_graph_params_match_jax(steps):
    _, _, jparams, _, model, _ = steps
    want = _export(jparams)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize('kind', MATCHERS)
def test_no_captured_part_reads_back(monkeypatch, kind):
    """Parts A and C of both heads' steps, and the auction's rounds, run
    under the guard; the matcher runs between the parts."""
    ran = guard_parts(monkeypatch)
    _, params = _params()
    model = _port(params)
    opt = _optimizers()[1](model)
    tsteps = {s: make_det_train_step(model, CFG.ddetr, opt, s, matcher=kind)
              for s in set(SOURCES)}
    for src, b in zip(SOURCES, _batches()):
        before = len(ran)
        losses = tsteps[src](det_batch_to(b, 'cpu'))
        assert np.isfinite(float(losses['loss']))
        parts = ran[before:]
        if kind == 'hungarian':
            assert parts == ['part 0', 'part 1']
        else:
            assert parts[0] == 'part 0' and parts[-1] == 'part 1'
            assert set(parts[1:-1]) == {'rounds'}
    assert opt.count == len(SOURCES)


def test_evaluation_forward_reads_nothing_back(monkeypatch):
    """evaluate_detector runs one CallGraph call a sample, whose function
    (the forward) reads nothing back; post_process reads after it."""
    _, params = _params()
    model = _port(params).eval()
    calls = []
    run = CallGraph.run

    def guarded(self, fn, state, *inputs, key=()):
        def checked(st, *args):
            with no_host_reads():
                return fn(st, *args)
        calls.append(tuple(inputs[0].shape))
        return run(self, checked, state, *inputs, key=key)
    monkeypatch.setattr(CallGraph, 'run', guarded)
    rng = np.random.default_rng(3)
    samples = [{'images': rng.standard_normal((56, 56, 3)).astype(
        np.float32), 'image_id': i, 'ori_shape': (40, 60),
        'gt': [(0, [5.0, 5.0, 30.0, 20.0])]} for i in range(3)]
    summary = det_eval.evaluate_detector(model, samples)
    assert calls == [(1, 56, 56, 3)] * 3
    # the perceiver keeps its graphs across evaluations
    graph = det_eval.forward_graph(model)
    assert det_eval.evaluate_detector(model, samples) == summary
    assert det_eval.forward_graph(model) is graph
    assert graph.keep == det_eval.EVAL_SHAPES
