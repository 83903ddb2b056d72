"""The port's detection stage against the JAX package's.

Weights come from a JAX ``model.init`` at ``tiny_groma_config().perceiver``
(and a two-level twin), carried across by ``export_perceiver`` and loaded
strictly.  Tolerances: the DDETR outputs within 1e-5 of max|x| per output;
the gradient of a loss over ``pred_boxes`` within 1e-4 of each tensor's
max|grad| (a tensor JAX gives no gradient must get none: the stop-gradient
on the two-stage reference points); MSDA's gather form within 1e-5 of
max|x| in values and gradients; matchers exactly; every loss key within
1e-5 relative; over three AdamW steps (train_det's lr of 2e-4, the first
at lr 0 in warmup, alternating sources) the losses within 1e-5 relative,
the parameters within 1e-4, each leaf's update within 1e-3 of JAX's in
relative Frobenius norm (2.3e-4 measured), the frozen ViT bitwise
unchanged.  The step tests start from parameters a little off the init's
kinks (every sampling point on a cell's centre line), where either
package's gradient may take either side of the bilinear weight's slope.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_perceiver
from groma_tpu.config import tiny_groma_config
from groma_tpu.models.ddetr_loss import ddetr_loss as j_ddetr_loss
from groma_tpu.models.perceiver import Perceiver as JPerceiver
from groma_tpu.ops import matcher as j_matcher
from groma_tpu.ops import msda as j_msda
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_det_train_step as j_make_det_step
from groma_tpu_torch.models.ddetr_loss import ddetr_loss
from groma_tpu_torch.models.perceiver import Perceiver
from groma_tpu_torch.ops import matcher, msda
from groma_tpu_torch.train import optimizer as topt
from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step

torch.set_num_threads(2)
CFG = tiny_groma_config().perceiver
CFG2 = CFG.replace(ddetr=CFG.ddetr.replace(num_feature_levels=2))
LR = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=''):
    """Output dict -> {'logits/coco': array, 'aux/boxes/0': array, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        elif isinstance(v, (list, tuple)):
            out.update({f'{prefix}{k}/{i}': x for i, x in enumerate(v)})
        else:
            out[prefix + k] = v
    return out


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _port(params, cfg):
    sd = export_perceiver(params, cfg.vit.num_layers, cfg.ddetr.encoder_layers,
                          cfg.ddetr.decoder_layers,
                          cfg.ddetr.num_feature_levels,
                          patch_size=cfg.vit.patch_size)
    model = Perceiver(cfg)
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _jax_init(cfg):
    """JAX's Perceiver at ``cfg`` and its params (init at key 0 on two
    56x56 images)."""
    jmodel = JPerceiver(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), np.zeros(
        (2, 56, 56, 3), np.float32))['params']
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope='module', params=[CFG, CFG2], ids=['1level', '2level'])
def det(request):
    """(cfg, JAX model, params, port model, images, JAX outputs)."""
    cfg = request.param
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    jmodel, params = _jax_init(cfg)
    out = jax.jit(jmodel.apply)({'params': params}, images)
    return cfg, jmodel, params, _port(params, cfg), images, out


def _targets(rng, b=2, t=6, counts=(3, 5)):
    valid = np.zeros((b, t), bool)
    for i, n in enumerate(counts):
        valid[i, :n] = True
    boxes = np.concatenate([rng.uniform(0.25, 0.7, (b, t, 2)),
                            rng.uniform(0.05, 0.4, (b, t, 2))], -1)
    return {'class_labels': np.zeros((b, t), np.int32),
            'boxes': np.where(valid[..., None], boxes, 0.0).astype(
                np.float32),
            'valid': valid}


# ------------------------------------------------------------- DDETR head

def test_ddetr_outputs_match_jax_every_key(det):
    cfg, jmodel, params, model, images, out = det
    want = _flat(out)
    with torch.no_grad():
        got = _flat(model(_t(images)))
    assert got.keys() == want.keys()
    assert len([k for k in got if k.startswith('aux/')]) == \
        3 * (cfg.ddetr.decoder_layers - 1)
    assert got['intermediate_reference_points'].shape == (
        2, cfg.ddetr.decoder_layers, cfg.ddetr.num_queries, 4)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(_np(got[k]), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_pred_boxes_gradient_matches_jax(det):
    """No gradient through the two-stage top-k boxes, as JAX's
    stop_gradient: a loss over pred_boxes alone gives the encoder's box
    head, enc_output and its norm no gradient through the references."""
    cfg, jmodel, params, model, images, _ = det
    w = np.random.default_rng(1).standard_normal(
        (2, cfg.ddetr.num_queries, 4)).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({'params': p}, images)['pred_boxes'] * w)
    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        params))
    want = export_perceiver(jgrads, cfg.vit.num_layers,
                            cfg.ddetr.encoder_layers, cfg.ddetr.decoder_layers,
                            cfg.ddetr.num_feature_levels,
                            patch_size=cfg.vit.patch_size)
    model.zero_grad(set_to_none=True)
    (model(_t(images))['pred_boxes'] * _t(w)).sum().backward()
    got = {k: (p.grad.numpy() if p.grad is not None
               else np.zeros(tuple(p.shape), np.float32))
           for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    zero = [k for k, v in want.items() if not np.abs(v).any()]
    assert 'ddetr_transformer.bbox_embed.%d.layers.2.weight' % \
        cfg.ddetr.decoder_layers in zero
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)
    model.zero_grad(set_to_none=True)


# ------------------------------------------------------------- box ops

@pytest.mark.parametrize('name', ['cxcywh_to_xyxy', 'xyxy_to_cxcywh',
                                  'box_iou', 'generalized_box_iou',
                                  'elementwise_iou',
                                  'normalize_box_coordinates'])
def test_box_ops_match_jax(name):
    """Every box op of JAX's ops/bbox.py in the port, on boxes that
    overlap, nest and miss each other (batched in a leading axis where
    the JAX op is pairwise)."""
    from groma_tpu.ops import bbox as j_bbox
    from groma_tpu_torch.ops import bbox as t_bbox
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 60, (2, 7, 2))
    a = np.concatenate([xy, xy + rng.uniform(1, 40, (2, 7, 2))],
                       -1).astype(np.float32)
    b = np.concatenate([a[:, ::-1, :2] + 5, a[:, ::-1, 2:] - 3],
                       -1).astype(np.float32)
    jf, tf = getattr(j_bbox, name), getattr(t_bbox, name)
    if name in ('box_iou', 'generalized_box_iou'):
        want = np.stack([np.asarray(jf(a[i], b[i])) for i in range(2)])
        got = tf(_t(a), _t(b))
    elif name == 'elementwise_iou':
        want, got = np.asarray(jf(a, b)), tf(_t(a), _t(b))
    elif name == 'normalize_box_coordinates':
        want, got = np.asarray(jf(a, (90, 80))), tf(_t(a), (90, 80))
    else:
        want, got = np.asarray(jf(a)), tf(_t(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if name == 'generalized_box_iou':
        diag = t_bbox.elementwise_generalized_box_iou(_t(a), _t(b))
        np.testing.assert_array_equal(
            diag.numpy(), np.diagonal(got.numpy(), axis1=1, axis2=2))


# ------------------------------------------------------------------ MSDA

@pytest.fixture(scope='module')
def gather_case():
    rng = np.random.default_rng(2)
    shapes = ((72, 72), (36, 36))
    b, q, nh, d, p = 1, 9, 2, 4, 3
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, q, nh, len(shapes), p, 2)).astype(
        np.float32)
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    wout = rng.standard_normal((b, q, nh * d)).astype(np.float32)
    return shapes, value, loc, attn, wout


def test_msda_gather_matches_jax_values_and_gradients(gather_case):
    shapes, value, loc, attn, wout = gather_case

    def jloss(v, l_, a):
        return jnp.sum(j_msda.ms_deform_attn(v, shapes, l_, a) * wout)
    want = j_msda.ms_deform_attn(value, shapes, loc, attn)
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(value, loc, attn)
    args = [_t(x).requires_grad_() for x in (value, loc, attn)]
    got = msda.ms_deform_attn(args[0], shapes, args[1], args[2])
    (got * _t(wout)).sum().backward()
    for name, g, w in [('out', got, want)] + [
            (n, a.grad, wg) for n, a, wg in zip(('value', 'loc', 'attn'),
                                                args, want_g)]:
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize('grid,form', [((64, 64), 'dense'),
                                       ((65, 64), 'gather')])
def test_msda_form_dispatch_matches_jax(monkeypatch, grid, form):
    """Dense up to 64x64 cells, gather above, in both packages (JAX's
    choice read from the function its MSDAttention calls while tracing);
    the port's MSDAttention output against JAX's."""
    import groma_tpu.models.ddetr as j_ddetr
    from groma_tpu.config import DDETRConfig
    from groma_tpu_torch.models.ddetr import MSDAttention
    c = DDETRConfig(d_model=8, num_heads=2, num_feature_levels=1)
    picked = []
    for name, tag in (('ms_deform_attn_dense', 'dense'),
                      ('ms_deform_attn', 'gather')):
        monkeypatch.setattr(j_ddetr, name, lambda *a, _f=getattr(
            j_msda, name), _tag=tag: picked.append(_tag) or _f(*a))
    rng = np.random.default_rng(3)
    h, w = grid
    query = rng.standard_normal((1, 5, 8)).astype(np.float32)
    value = rng.standard_normal((1, h * w, 8)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (1, 5, 1, 4)).astype(np.float32)
    jmod = j_ddetr.MSDAttention(c, 2)
    jp = jmod.init(jax.random.PRNGKey(0), query, ref, value, (grid,))
    want = jmod.apply(jp, query, ref, value, (grid,))
    assert set(picked) == {form}
    assert msda.uses_dense_form((grid,)) == (form == 'dense')
    tmod = MSDAttention(c, 2)
    with torch.no_grad():
        for name, mod in tmod.named_children():
            mod.weight.copy_(_t(jp['params'][name]['kernel']).T)
            mod.bias.copy_(_t(jp['params'][name]['bias']))
        got = tmod(_t(query), _t(ref), _t(value), (grid,))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


# -------------------------------------------------------------- matchers

def _costs(seed, b=4, q=30, t=10, counts=(10, 7, 1, 0), bad=True):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (b, q, t)).astype(np.float32)
    valid = np.zeros((b, t), bool)
    for i, n in enumerate(counts):
        valid[i, :n] = True
    if bad:
        cost[0, 3, 2], cost[1, 4, 1], cost[1, 5, 0] = np.nan, np.inf, -np.inf
    return cost, valid


@pytest.mark.parametrize('bad', [False, True], ids=['finite', 'nan_inf'])
def test_hungarian_match_matches_jax(bad):
    for seed in range(3):
        cost, valid = _costs(seed, bad=bad)
        want = np.asarray(j_matcher.hungarian_match(jnp.asarray(cost),
                                                    jnp.asarray(valid)))
        got = matcher.hungarian_match(_t(cost), _t(valid))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[3] == -1).all()            # the image without targets


def _total(cost, assign, valid):
    return sum(cost[i, assign[i, t], t] for i in range(cost.shape[0])
               for t in range(cost.shape[2]) if valid[i, t])


@pytest.mark.parametrize('bad', [False, True], ids=['finite', 'nan_inf'])
def test_auction_match_matches_jax_and_bounds_the_optimum(bad):
    for seed in range(3):
        cost, valid = _costs(seed, bad=bad)
        want = np.asarray(j_matcher.auction_match(jnp.asarray(cost),
                                                  jnp.asarray(valid)))
        got = matcher.auction_match(_t(cost), _t(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        if bad:
            continue
        opt = matcher.hungarian_match(_t(cost), _t(valid)).numpy()
        # JAX's bound: within T * eps * range of scipy's optimum
        rng_ = cost.max() - cost.min()
        assert _total(cost, got, valid) <= _total(cost, opt, valid) \
            + cost.shape[2] * 1e-4 * rng_ + 1e-5


def test_auction_reads_convergence_once_every_check_every_rounds(
        monkeypatch):
    """The host reads the convergence flag once per CHECK_EVERY rounds; the
    rounds past convergence change nothing."""
    cost, valid = _costs(5, bad=False)
    real_topk, real_bool = torch.Tensor.topk, torch.Tensor.__bool__

    def run(every):
        n = {'rounds': 0, 'reads': 0}

        def topk(self, *a, **kw):
            n['rounds'] += 1
            return real_topk(self, *a, **kw)

        def read(self):
            n['reads'] += 1
            return real_bool(self)
        monkeypatch.setattr(matcher, 'CHECK_EVERY', every)
        monkeypatch.setattr(torch.Tensor, 'topk', topk)
        monkeypatch.setattr(torch.Tensor, '__bool__', read)
        try:
            out = matcher.auction_match(_t(cost), _t(valid)).numpy()
        finally:
            monkeypatch.setattr(torch.Tensor, 'topk', real_topk)
            monkeypatch.setattr(torch.Tensor, '__bool__', real_bool)
        return out, n
    every = matcher.CHECK_EVERY
    coarse, n = run(every)
    fine, n1 = run(1)
    np.testing.assert_array_equal(coarse, fine)
    assert n['rounds'] == every * (n['reads'] - 1)
    assert n1['rounds'] <= n['rounds'] < n1['rounds'] + every
    assert n['reads'] < n1['reads']


# ------------------------------------------------------------------ loss

SOURCES, KINDS = ('coco', 'sa1b'), ('hungarian', 'auction')


@pytest.fixture(scope='module')
def jax_losses(det):
    """JAX's loss dicts on the det fixture's outputs, every (source,
    matcher) pair in one jitted call."""
    cfg, _, _, _, _, out = det
    targets = _targets(np.random.default_rng(4))

    def all_losses(out, tg):
        return {f'{s}/{k}': j_ddetr_loss(out, tg, cfg.ddetr, s, matcher=k)
                for s in SOURCES for k in KINDS}
    return targets, jax.jit(all_losses)(
        out, {k: jnp.asarray(v) for k, v in targets.items()})


@pytest.mark.parametrize('source', SOURCES)
@pytest.mark.parametrize('kind', KINDS)
def test_ddetr_loss_matches_jax_every_key(det, jax_losses, source, kind):
    cfg, _, _, model, images, _ = det
    targets, want = jax_losses
    want = want[f'{source}/{kind}']
    with torch.no_grad():
        got = ddetr_loss(model(_t(images)), {k: _t(v) for k, v in
                                             targets.items()},
                         cfg.ddetr, source, matcher=kind)
    assert got.keys() == want.keys()
    assert {'loss_ce_enc', 'loss_giou_0', 'cardinality_error'} <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_ddetr_loss_groups_stages_by_query_count(det, monkeypatch):
    """One matcher call per query count: the decoder's stages together,
    the encoder's proposals apart."""
    cfg, _, _, model, images, _ = det
    calls = []
    real = matcher.hungarian_match
    import groma_tpu_torch.models.ddetr_loss as dl
    monkeypatch.setitem(dl.MATCHERS, 'hungarian',
                        lambda c, v: calls.append(c.shape) or real(c, v))
    targets = _targets(np.random.default_rng(4))
    with torch.no_grad():
        ddetr_loss(model(_t(images)), {k: _t(v) for k, v in targets.items()},
                   cfg.ddetr, 'coco')
    q, s = cfg.ddetr.num_queries, 16 + (4 if cfg is CFG2 else 0)
    assert calls == [(2 * cfg.ddetr.decoder_layers, q, 6), (2, s, 6)]


def test_single_stage_loss_matches_its_matcher_itself(det):
    """_single_stage_loss without a given assignment matches on its own:
    the last layer's losses are ddetr_loss's unsuffixed ones."""
    from groma_tpu_torch.models.ddetr_loss import _single_stage_loss
    cfg, _, _, model, images, _ = det
    tg = {k: _t(v) for k, v in _targets(np.random.default_rng(4)).items()}
    with torch.no_grad():
        out = model(_t(images))
        whole = ddetr_loss(out, tg, cfg.ddetr, 'sa1b')
        alone = _single_stage_loss(
            out['logits']['sa1b'], out['pred_boxes'], tg['class_labels'],
            tg['boxes'], tg['valid'], tg['valid'].sum().float(), cfg.ddetr)
    for k, v in alone.items():
        assert torch.equal(v, whole[k]), k


# ------------------------------------------------------------ train step

STEP_SOURCES = ('coco', 'sa1b', 'coco')
# the self-attention key biases: their exact gradient is 0 (a bias on the
# keys adds the same q.b to every score of a query, which the softmax
# cancels), so Adam's update of them is f32 noise divided by its own size
NO_GRADIENT = ('self_attn.k_proj.bias',)
UPDATE_TOL = 1e-3    # relative Frobenius error of each leaf's update


def _off_kinks(params, rng):
    """``params`` with a little noise (std 1e-2) on every leaf that starts
    at zero.  At init every sampling point lies on a cell's centre line
    (zero offset weights and box deltas), where the slope of the bilinear
    weight flips with the last bit of the location: there the two packages'
    gradients may take either side."""
    return jax.tree_util.tree_map(
        lambda p: p if p.any() else
        rng.normal(0.0, 1e-2, p.shape).astype(p.dtype), params)


@pytest.fixture(scope='module')
def det_steps():
    """Three steps of each package's detection step (frozen ViT, the
    detection lr rules, warmup 1 of 4 steps: the first at lr 0, two past
    it), the sources alternating as the source-grouped sampler's batches
    do -> (JAX losses, JAX params, port losses, port model, params
    before)."""
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    batches = [{'images': images, 'targets': _targets(rng)},
               {'images': images[::-1].copy(),
                'targets': _targets(rng, counts=(6, 2))},
               {'images': images, 'targets': _targets(rng, counts=(0, 4))}]
    jmodel, params = _jax_init(CFG)
    params = _off_kinks(params, rng)
    sched = dict(total_steps=4, warmup_steps=1)
    tx = jopt.make_adamw(
        jopt.cosine_schedule(LR, **sched), weight_decay=1e-4,
        max_grad_norm=1.0, lr_mult_rules=jopt.det_lr_mult_rules(0.1),
        frozen_pred=jopt.freeze_predicate(freeze_vis_encoder=True))
    state = TrainState.create(params, tx)
    jbatches = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]

    def compiled(src):
        return jax.jit(j_make_det_step(jmodel, CFG.ddetr, tx, src)).lower(
            state, jbatches[0]).compile()
    with ThreadPoolExecutor(2) as pool:        # the two compiles overlap
        jsteps = dict(zip(('coco', 'sa1b'), pool.map(compiled,
                                                     ('coco', 'sa1b'))))
    jlosses = []
    for src, b in zip(STEP_SOURCES, jbatches):
        state, losses = jsteps[src](state, b)
        jlosses.append({k: float(v) for k, v in losses.items()})
    model = _port(params, CFG)
    opt = topt.make_adamw(
        model, topt.cosine_schedule(LR, **sched), weight_decay=1e-4,
        max_grad_norm=1.0, lr_mult_rules=topt.det_lr_mult_rules(0.1),
        frozen_pred=topt.freeze_predicate(freeze_vis_encoder=True))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tsteps = {s: make_det_train_step(model, CFG.ddetr, opt, s)
              for s in set(STEP_SOURCES)}
    tlosses = [{k: float(v) for k, v in
                tsteps[src](det_batch_to(b, 'cpu')).items()}
               for src, b in zip(STEP_SOURCES, batches)]
    return jlosses, jax.tree_util.tree_map(np.asarray, state.params), \
        tlosses, model, before, params


def _export(params):
    return export_perceiver(params, CFG.vit.num_layers,
                            CFG.ddetr.encoder_layers, CFG.ddetr.decoder_layers,
                            CFG.ddetr.num_feature_levels,
                            patch_size=CFG.vit.patch_size)


def test_det_step_losses_match_jax(det_steps):
    jlosses, _, tlosses, *_ = det_steps
    for want, got in zip(jlosses, tlosses):
        assert got.pop('updated') == 1.0
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_det_step_params_match_jax(det_steps):
    _, jparams, _, model, *_ = det_steps
    want = _export(jparams)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_det_step_updates_match_jax(det_steps):
    """Each leaf's update over the three steps against JAX's, relative to
    the size of JAX's update: a leaf left still, moved the wrong way or at
    the wrong lr multiplier is off by the whole of it, at any lr."""
    _, jparams, _, model, before, params = det_steps
    start, want = _export(params), _export(jparams)
    after = model.state_dict()
    moved = 0
    for k in want:
        if k.startswith('vis_encoder.') or k.endswith(NO_GRADIENT):
            continue
        np.testing.assert_array_equal(before[k].numpy(), start[k], err_msg=k)
        dj = want[k] - start[k]
        dp = after[k].numpy() - before[k].numpy()
        assert np.linalg.norm(dj) > 0, k
        err = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
        assert err <= UPDATE_TOL, (k, err)
        moved += 1
    assert moved > 100


def test_det_step_freezes_the_vit_and_moves_every_ddetr_leaf(det_steps):
    *_, model, before, _ = det_steps
    after = model.state_dict()
    vit = [k for k in after if k.startswith('vis_encoder.')]
    assert vit and all(torch.equal(after[k], before[k]) for k in vit)
    still = [k for k in after if k.startswith('ddetr_transformer.')
             and torch.equal(after[k], before[k])]
    assert not still, still
    assert all(p.grad is None for k, p in model.named_parameters()
               if k.startswith('vis_encoder.'))


# ------------------------------------------------------------- train_det

@pytest.fixture(scope='module')
def det_data(tmp_path_factory):
    """A seeded COCO-format set with a coco_box and an sa1b_box source, and
    its dataset config."""
    from PIL import Image
    root = tmp_path_factory.mktemp('det_data')
    (root / 'imgs').mkdir()
    rng = np.random.default_rng(7)
    for name, n in (('coco', 6), ('sa1b', 4)):
        images, anns = [], []
        for i in range(n):
            fn = f'{name}{i}.png'
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                            ).save(root / 'imgs' / fn)
            images.append({'id': i, 'file_name': fn, 'width': 64,
                           'height': 48})
            for _ in range(3):
                x, y = rng.uniform(0, 40), rng.uniform(0, 30)
                w, h = rng.uniform(8, 24), rng.uniform(8, 18)
                anns.append({'id': len(anns), 'image_id': i,
                             'bbox': [x, y, w, h], 'area': w * h,
                             'category_id': 1, 'iscrowd': 0})
        with open(root / f'{name}.json', 'w') as f:
            json.dump({'images': images, 'annotations': anns,
                       'categories': [{'id': 1, 'name': 'object'}]}, f)
    (root / 'data.py').write_text(
        f"datasets = [dict(type='coco_box', ann_file='{root / 'coco.json'}',"
        f" img_prefix='{root / 'imgs'}'),\n"
        f"            dict(type='sa1b_box', ann_file='{root / 'sa1b.json'}',"
        f" img_prefix='{root / 'imgs'}')]\n")
    return root


def _det_argv(data, out):
    return ['--dataset_config', str(data / 'data.py'), '--output_dir',
            str(out), '--per_device_train_batch_size', '2',
            '--num_train_epochs', '2', '--warmup_steps', '1',
            '--logging_steps', '1', '--save_strategy', 'steps',
            '--save_steps', '7', '--save_total_limit', '2',
            '--dataloader_num_workers', '2', '--device', 'cpu']


def test_train_det_resumes_at_the_saved_step_and_exports(det_data, tmp_path,
                                                          capsys):
    """5 steps an epoch (3 coco batches, 2 sa1b), 2 epochs.  With the last
    checkpoint removed, a second run resumes at step 7, on the 3rd batch
    of epoch 2, and ends with the losses and parameters of the first.  The
    export loads in run_ddetr --model-dir."""
    from groma_tpu_torch.train.train_det import parse_args, train
    out = tmp_path / 'run'
    whole = train(parse_args(_det_argv(det_data, out)), CFG, 'cpu')
    assert whole['step'] == whole['total_steps'] == 10
    assert sorted(p.name for p in out.glob('checkpoint-*')) == [
        'checkpoint-10.pt', 'checkpoint-7.pt']
    want = {k: v.clone() for k, v in whole['model'].state_dict().items()}
    losses = [s['loss'] for s in whole['losses']]
    assert np.isfinite(losses).all()
    (out / 'checkpoint-10.pt').unlink()
    capsys.readouterr()
    second = train(parse_args(_det_argv(det_data, out)), CFG, 'cpu')
    log = capsys.readouterr().out
    assert 'resumed from step 7' in log and 'step 8/10' in log
    assert 'step 7/' not in log
    np.testing.assert_allclose([s['loss'] for s in second['losses']],
                               losses[7:], rtol=1e-6)
    got = second['model'].state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6,
                                   msg=k)

    from PIL import Image

    from groma_tpu_torch.eval import run_ddetr
    Image.fromarray(np.full((40, 60, 3), 128, np.uint8)).save(
        tmp_path / 'img.png')
    kept = run_ddetr.main(['--model-dir', str(out),
                           '--image-file', str(tmp_path / 'img.png'),
                           '--output-image', str(tmp_path / 'o.png'),
                           '--score-thres', '0.0', '--device', 'cpu'])
    assert kept.ndim == 2 and kept.shape[1] == 4 and len(kept)
    assert (tmp_path / 'o.png').exists()


def test_train_det_flags(capsys):
    """Boolean flags parse strings (JAX's type=bool takes 'False' as
    true); --dp and --tp take any count, as JAX's; the CLI keeps JAX's
    widths."""
    import argparse as ap
    from groma_tpu_torch.train.train_det import parse_args, perceiver_config
    base = ['--dataset_config', 'x', '--output_dir', 'o']
    args = parse_args(base + ['--two_stage', 'False', '--freeze_vis_encoder',
                              'false', '--with_box_refine', 'True'])
    assert (args.two_stage, args.freeze_vis_encoder,
            args.with_box_refine) == (False, False, True)
    assert args.device == 'cuda'
    jax_like = ap.ArgumentParser()
    jax_like.add_argument('--two_stage', type=bool, default=True)
    assert jax_like.parse_args(['--two_stage', 'False']).two_stage is True
    assert parse_args(base + ['--dp', '2']).dp == 2
    assert parse_args(base + ['--tp', '2']).tp == 2
    cfg = perceiver_config(parse_args(base))
    assert (cfg.vit.hidden_size, cfg.vit.num_layers, cfg.ddetr.d_model,
            cfg.ddetr.num_queries, cfg.ddetr.encoder_layers,
            cfg.ddetr.decoder_layers, cfg.image_size) == (1024, 24, 256, 300,
                                                         6, 6, 448)


def test_vis_encoder_loads_a_dinov2_directory(tmp_path):
    """--vis_encoder: a HF Dinov2Model directory (its position table at a
    6x6 grid) lands in the Perceiver's ViT, the table resized to the
    deploy grid as JAX's import_dinov2 resizes it."""
    from groma_tpu.checkpoint.hf_export import export_dinov2, save_safetensors
    from groma_tpu.checkpoint.hf_import import import_dinov2
    from groma_tpu_torch.checkpoint.loader import random_perceiver
    from groma_tpu_torch.train.train_det import load_vis_encoder
    _, params = _jax_init(CFG)
    vit = dict(params['vis_encoder'])
    rng = np.random.default_rng(8)
    vit['pos_embed'] = rng.standard_normal(
        (1, 1 + 36, CFG.vit.hidden_size)).astype(np.float32)
    sd = export_dinov2(vit, CFG.vit.num_layers, CFG.vit.patch_size)
    sd['embeddings.mask_token'] = np.zeros((1, CFG.vit.hidden_size),
                                           np.float32)
    save_safetensors(sd, str(tmp_path / 'model.safetensors'))
    model = random_perceiver(CFG, seed=1)
    load_vis_encoder(model, str(tmp_path))
    want = import_dinov2(sd, CFG.vit.num_layers, CFG.vit.patch_size,
                         deploy_grid=4)
    got = model.vis_encoder.state_dict()
    np.testing.assert_allclose(
        got['embeddings.position_embeddings'].numpy(), want['pos_embed'],
        rtol=0, atol=1e-6)
    for k, v in sd.items():
        if k in got and k != 'embeddings.position_embeddings':
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
