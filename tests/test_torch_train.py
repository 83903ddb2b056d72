"""The port's VL-stage trainer against the JAX package's.

One train step at ``tiny_groma_config(max_seq_len=1024)``: at that length
the LLM takes the flash-attention branch (FLASH_MIN_SEQ), and so does the
ViT, in both packages (JAX's Pallas kernels in interpret mode).  Weights
reach the port through ``from_jax_params``; ``permute_regions=False``.
Tolerances: the loss to 1e-5 relative (f32 sums in another order through
the stack); parameters after one AdamW step at lr 1e-3 to 1e-4 absolute
(Adam divides each gradient by its own magnitude, so gradients near zero
turn f32 noise into update noise; a tenth of the step size bounds it);
frozen parameters bitwise unchanged.  Optimizer and schedule values are held
to optax's; ``fused_cross_entropy`` to the JAX one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_groma
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.constants import IGNORE_INDEX
from groma_tpu.data.tokenization import SpecialIds, expand_template
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.ops.fused_ce import fused_cross_entropy as j_fused_ce
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_vl_train_step as j_make_step
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.ops.fused_ce import fused_cross_entropy
from groma_tpu_torch.train import optimizer as topt
from groma_tpu_torch.train.steps import batch_to, make_vl_train_step
from groma_tpu_torch.train.synthetic import grounded_batch, grounded_kv_mask

torch.set_num_threads(2)
CFG = tiny_groma_config(max_seq_len=1024)
LR = 1e-3


def _batch(cfg, seed=0):
    """Two grounded rows of different lengths: ground boxes, <ground_box>
    tokens in the supervised answer, unused region slots, a padded tail."""
    sp = SpecialIds.from_base_vocab(cfg.llm.vocab_size)
    rng = np.random.default_rng(seed)

    def row(n):
        raw = np.concatenate([[1], rng.integers(3, 256, 5), [sp.image], [7],
                              [sp.region], rng.integers(3, 256, n), [sp.gbox],
                              rng.integers(3, 256, 4), [sp.gbox], [2]])
        labels = raw.copy()
        labels[:9] = IGNORE_INDEX
        return expand_template(raw, labels, sp, cfg.num_image_tokens,
                               cfg.max_region_num, cfg.max_seq_len)

    rows = [row(cfg.max_seq_len - 60), row(cfg.max_seq_len // 3)]
    batch = {k: np.stack([r[k] for r in rows])
             for k in ('input_ids', 'labels', 'region_slot', 'valid')}
    size = cfg.perceiver.image_size
    batch['images'] = rng.standard_normal((2, size, size, 3)).astype(
        np.float32)
    batch['ground_boxes'] = rng.uniform(0.3, 0.6, (2, 3, 4)).astype(
        np.float32)
    batch['ground_valid'] = np.array([[True, True, True],
                                      [True, True, False]])
    batch['refer_boxes'] = np.zeros((2, 1, 4), np.float32)
    batch['refer_valid'] = np.zeros((2, 1), bool)
    return batch


@pytest.fixture(scope='module')
def setup():
    jmodel = JGroma(CFG)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, _batch(CFG)


@pytest.fixture(scope='module', params=['stage2_frozen', 'stage3_llm'])
def one_step(request, setup):
    """One step of each trainer -> (JAX loss, JAX params after, port loss,
    port model after, flash calls the port made)."""
    jmodel, params, batch = setup
    freeze_llm = request.param == 'stage2_frozen'
    tx = jopt.make_adamw(LR, frozen_pred=jopt.freeze_predicate(
        freeze_perceiver=True, freeze_llm=freeze_llm))
    step = jax.jit(j_make_step(jmodel, tx, use_flash=True,
                               permute_regions=False))
    new_state, metrics = step(TrainState.create(params, tx),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
    tmodel = from_jax_params(params, CFG, full_precision=True)
    opt = topt.make_adamw(tmodel, LR, frozen_pred=topt.freeze_predicate(
        freeze_perceiver=True, freeze_llm=freeze_llm))
    calls = []
    import groma_tpu_torch.models.layers as layers
    import groma_tpu_torch.models.llama as llama
    real = llama.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get('causal', False))
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(llama, 'flash_attention', counting)
    mp.setattr(layers, 'flash_attention', counting)
    try:
        out = make_vl_train_step(tmodel, opt, use_flash=True,
                                 permute_regions=False)(batch_to(batch, 'cpu'))
    finally:
        mp.undo()
    return (float(metrics['loss']),
            jax.tree_util.tree_map(np.asarray, new_state.params),
            float(out['loss']), tmodel, calls, freeze_llm)


def test_train_step_loss_matches_jax(one_step):
    jloss, _, tloss, _, calls, _ = one_step
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    # the flash branch was taken: once per ViT layer, once per LLM layer
    assert calls.count(False) == CFG.perceiver.vit.num_layers
    assert calls.count(True) == CFG.llm.num_layers


def test_params_after_one_adamw_step_match_jax(one_step, setup):
    _, params, _ = setup
    _, jparams, _, tmodel, _, freeze_llm = one_step
    before = export_groma(params, CFG)
    want = export_groma(jparams, CFG)
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    assert got.keys() == want.keys()
    moved = set()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
        if not np.array_equal(want[k], before[k]):
            moved.add(k)
        else:
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
    assert not any(k.startswith('perceiver.') for k in moved)
    assert any(k.startswith('region_encoder.') for k in moved)
    assert 'new_input_embs.weight' in moved
    assert any(k.startswith('llm.') for k in moved) == (not freeze_llm)


def test_non_fused_loss_matches_fused(setup):
    """Both CE branches of the forward agree (f32 heads here)."""
    _, params, batch = setup
    tmodel = from_jax_params(params, CFG)
    tb = batch_to(batch, 'cpu')
    args = dict(images=tb['images'], input_ids=tb['input_ids'],
                region_slot=tb['region_slot'], base_valid=tb['valid'],
                labels=tb['labels'], ground_boxes=tb['ground_boxes'],
                ground_valid=tb['ground_valid'])
    with torch.no_grad():
        fused = tmodel(**args, use_flash=True)['loss']
        plain = tmodel(**args, fused_ce=False)
    assert plain['logits'].shape[-1] == CFG.vocab_size
    torch.testing.assert_close(plain['loss'], fused, atol=1e-5, rtol=1e-5)


def test_region_permutation_uses_the_generator(setup):
    _, params, batch = setup
    tmodel = from_jax_params(params, CFG)
    tb = batch_to(batch, 'cpu')

    def kept(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            vis = tmodel.vision(tb['images'], ground_boxes=tb['ground_boxes'],
                                ground_valid=tb['ground_valid'],
                                generator=gen, permute=True)
        return vis['selected_boxes'], vis['selected_mask']

    (b0, m0), (b1, m1) = kept(0), kept(0)
    assert torch.equal(b0, b1) and torch.equal(m0, m1)
    # kept regions come first, in a seeded order, the same set as unpermuted
    with torch.no_grad():
        plain = tmodel.vision(tb['images'], ground_boxes=tb['ground_boxes'],
                              ground_valid=tb['ground_valid'])
    n = plain['selected_mask'].sum(-1)
    assert torch.equal(m0.sum(-1), n)
    for i in range(2):
        k = int(n[i])
        got = sorted(map(tuple, b0[i, :k].tolist()))
        assert got == sorted(map(tuple, plain['selected_boxes'][i, :k]
                                 .tolist()))


def test_synthetic_grounded_batch_has_the_training_layout():
    """The smoke run's batch, made from a seed: expand_template's layout,
    three supervised <ground_box> tokens a row; its key mask drops the
    region slots NMS left unused and the padded tail."""
    sp = SpecialIds.from_base_vocab(CFG.llm.vocab_size)
    batch = grounded_batch(CFG, 3, seed=0, answer_lens=(300, 100))
    again = grounded_batch(CFG, 3, seed=0, answer_lens=(300, 100))
    for k in batch:
        np.testing.assert_array_equal(batch[k], again[k], err_msg=k)
    b, s, r = 3, CFG.max_seq_len, CFG.max_region_num
    size = CFG.perceiver.image_size
    assert batch['input_ids'].shape == (b, s)
    assert batch['images'].shape == (b, size, size, 3)
    for key in ('input_ids', 'labels'):
        assert ((batch[key] == sp.gbox).sum(1) == 3).all()
    # the answer and eos are supervised, the prompt is not
    np.testing.assert_array_equal((batch['labels'] != IGNORE_INDEX).sum(1),
                                  [301, 101, 301])
    assert ((batch['region_slot'] >= 0).sum(1) == 2 * r).all()
    assert (batch['input_ids'] == sp.image).sum() == b * CFG.num_image_tokens
    kept = np.array([3, 0, r])
    mask = grounded_kv_mask(batch, kept)
    np.testing.assert_array_equal(
        mask.sum(1), batch['valid'].sum(1) - 2 * (r - kept))
    assert not (mask & ~batch['valid']).any()
    assert not batch['valid'][:, -1].any()                # a padded tail


# ------------------------------------------------------------- optimizer

def test_cosine_schedule_matches_optax():
    # optax evaluates in f32: 1e-6 of the peak absolute
    for total, warmup_ratio in ((50, 0.1), (7, 0.0), (1, 0.03)):
        want = jopt.cosine_schedule(2e-4, total, warmup_ratio=warmup_ratio)
        got = topt.cosine_schedule(2e-4, total, warmup_ratio=warmup_ratio)
        for step in range(total + 3):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=2e-10)
    assert topt.cosine_schedule(1e-4, 100, warmup_ratio=0.03)(0) == 0.0


class _Toy(torch.nn.Module):
    """Names of the rules: a decayed linear, a norm (no decay), a 0.1x
    sampling_offsets group, a frozen vision-encoder leaf."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(5, 4)
        self.norm = torch.nn.LayerNorm(4)
        self.sampling_offsets = torch.nn.Linear(4, 3)
        self.vis_encoder = torch.nn.Linear(3, 2)


def _toy_jax_tree(m):
    def dense(l):
        return {'kernel': l.weight.detach().numpy().T.copy(),
                'bias': l.bias.detach().numpy().copy()}
    return {'lin': dense(m.lin), 'sampling_offsets': dense(m.sampling_offsets),
            'vis_encoder': dense(m.vis_encoder),
            'norm': {'scale': m.norm.weight.detach().numpy().copy(),
                     'bias': m.norm.bias.detach().numpy().copy()}}


@pytest.mark.parametrize('accum', [1, 2])
def test_adamw_matches_optax(accum):
    """Weight decay with the no-decay rule, lr multipliers, global-norm
    clipping, a frozen leaf, the warmup-cosine schedule and (accum=2)
    optax.MultiSteps gradient accumulation, over 3 updates."""
    torch.manual_seed(0)
    model = _Toy()
    with torch.no_grad():
        model.norm.weight.normal_()
    tree = _toy_jax_tree(model)
    sched = (0.05, 6)
    tx = jopt.make_adamw(jopt.cosine_schedule(*sched, warmup_steps=2),
                         weight_decay=0.1, max_grad_norm=0.5,
                         lr_mult_rules=jopt.det_lr_mult_rules(0.1),
                         frozen_pred=jopt.freeze_predicate(
                             freeze_vis_encoder=True))
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    opt = topt.make_adamw(model, topt.cosine_schedule(*sched, warmup_steps=2),
                          weight_decay=0.1, max_grad_norm=0.5,
                          lr_mult_rules=topt.det_lr_mult_rules(0.1),
                          frozen_pred=topt.freeze_predicate(
                              freeze_vis_encoder=True),
                          accum_steps=accum)
    state = tx.init(tree)
    rng = np.random.default_rng(1)
    for _ in range(3 * accum):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for name, p in model.named_parameters():
            if p.requires_grad:
                mod, leaf = name.split('.')
                g = grads[mod]['scale' if mod == 'norm' and leaf == 'weight'
                               else 'kernel' if leaf == 'weight' else 'bias']
                g = torch.from_numpy(g.T.copy() if leaf == 'weight'
                                     and mod != 'norm' else g)
                p.grad = g if p.grad is None else p.grad + g
        updates, state = tx.update(grads, state, tree)
        tree = optax.apply_updates(tree, updates)
        opt.step()
    assert not model.vis_encoder.weight.requires_grad
    got = _toy_jax_tree(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = got
        for p in path:
            node = node[p.key]
        # the same f32 Adam arithmetic in another order: 1e-6 of unit
        # params, against updates of up to lr 0.05
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))


def _exported_flags(params, flag):
    """JAX param tree -> {port name: flag(JAX path)} through the weight
    bridge: each leaf becomes all-ones or all-zeros and export_groma maps
    it to the reference names the port carries."""
    def one(path, x):
        return np.full(np.shape(x), float(flag(jopt._path_str(path))),
                       np.float32)
    sd = export_groma(jax.tree_util.tree_map_with_path(one, params), CFG)
    out = {}
    for k, v in sd.items():
        assert v.min() == v.max(), k          # one JAX leaf per port tensor
        out[k] = bool(v.max())
    return out


def test_no_decay_names_match_the_jax_rule(setup):
    _, params, _ = setup
    want = _exported_flags(params, jopt._no_decay)
    got = topt.no_decay_names(from_jax_params(params, CFG))
    assert got == {k for k, v in want.items() if v}


@pytest.mark.parametrize('perceiver,llm', [(True, True), (True, False),
                                           (False, True)])
def test_freeze_predicate_maps_the_jax_paths(setup, perceiver, llm):
    _, params, _ = setup
    want = _exported_flags(params, jopt.freeze_predicate(
        freeze_perceiver=perceiver, freeze_llm=llm))
    pred = topt.freeze_predicate(freeze_perceiver=perceiver, freeze_llm=llm)
    assert {k: pred(k) for k in want} == want


def test_fused_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    b, s, h = 2, 300, 16
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    heads = [rng.standard_normal((h, 50)).astype(np.float32) * 0.3,
             rng.standard_normal((h, 7)).astype(np.float32) * 0.3]
    labels = rng.integers(0, 57, (b, s))
    ok = rng.random((b, s)) > 0.3

    def jloss(hd, w0, w1):
        return j_fused_ce(hd, (w0, w1), jnp.asarray(labels), jnp.asarray(ok),
                          chunk=128)

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (hidden, *heads)))
    th, t0, t1 = (torch.from_numpy(x).requires_grad_()
                  for x in (hidden, *heads))
    got = fused_cross_entropy(th, (t0, t1), torch.from_numpy(labels),
                              torch.from_numpy(ok), chunk=128)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for g, w in zip((th.grad, t0.grad, t1.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


# ------------------------------------------------------------ entry point

def test_boolean_flags_parse_as_strings():
    """`--freeze_llm False` (vl_finetune.sh) means False; argparse's
    type=bool would read any non-empty string as True."""
    from groma_tpu_torch.train.train_vl import parse_args
    base = ['--dataset_config', 'x.py', '--output_dir', 'out']
    args = parse_args(base + ['--freeze_llm', 'False', '--freeze_perceiver',
                              'True', '--use_flash_attention', 'false'])
    assert (args.freeze_llm, args.freeze_perceiver,
            args.use_flash_attention) == (False, True, False)
    assert parse_args(base).freeze_llm is False
    assert parse_args(base).freeze_perceiver is True
    with pytest.raises(SystemExit):
        parse_args(base + ['--freeze_llm', 'maybe'])


def test_gradient_checkpointing_is_accepted_and_has_no_effect():
    """vl_finetune.sh passes --gradient_checkpointing True.  As in the JAX
    package (GromaModel builds its LLaMA without remat), the flag parses
    and nothing reads it: its only mentions are the docstring and the
    flag itself (the main test below runs with it)."""
    import groma_tpu_torch.train.train_vl as train_vl
    args = train_vl.parse_args(['--dataset_config', 'x.py', '--output_dir',
                                'o', '--gradient_checkpointing', 'True'])
    assert args.gradient_checkpointing is True
    with open(train_vl.__file__) as f:
        assert f.read().count('gradient_checkpointing') == 2


def test_freeze_llm_false_leaves_the_llm_trainable(setup):
    from groma_tpu_torch.train.train_vl import parse_args
    _, params, _ = setup
    args = parse_args(['--dataset_config', 'x.py', '--output_dir', 'o',
                       '--freeze_llm', 'False'])
    model = from_jax_params(params, CFG, full_precision=True)
    opt = topt.make_adamw(model, 1e-5, frozen_pred=topt.freeze_predicate(
        freeze_perceiver=args.freeze_perceiver, freeze_llm=args.freeze_llm))
    trained = {id(p) for p in opt.params}
    llm = dict(model.named_parameters())
    assert all(id(p) in trained for k, p in llm.items()
               if k.startswith('llm.'))
    assert not any(id(p) in trained for k, p in llm.items()
                   if k.startswith('perceiver.'))


@pytest.fixture(scope='module')
def coco_dir(tmp_path_factory):
    """A synthetic COCO-style REC dataset, its dataset config, and a tiny
    model directory in the reference format."""
    from PIL import Image

    from groma_tpu.checkpoint.hf_export import export_hf_dir
    root = tmp_path_factory.mktemp('vl_data')
    rng = np.random.default_rng(0)
    (root / 'imgs').mkdir()
    images, anns = [], []
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(root / 'imgs' / f'{i}.jpg')
        images.append({'id': i, 'file_name': f'{i}.jpg', 'width': 64,
                       'height': 48, 'caption': f'object number {i}'})
        anns.append({'id': i, 'image_id': i, 'bbox': [8, 8, 24, 24],
                     'area': 576, 'category_id': 1})
    with open(root / 'ann.json', 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': 1, 'name': 'object'}]}, f)
    (root / 'data.py').write_text(
        f"datasets = [dict(type='RefCOCO', ann_file='{root / 'ann.json'}', "
        f"img_prefix='{root / 'imgs'}')]\n")
    cfg = tiny_groma_config()
    jmodel = JGroma(cfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(cfg)))()['params']
    export_hf_dir(jax.tree_util.tree_map(np.asarray, params), cfg,
                  str(root / 'model'))
    return root


def test_train_vl_main_trains_saves_resumes_and_exports(coco_dir, tmp_path,
                                                        capsys):
    from groma_tpu_torch.checkpoint.loader import load_groma
    from groma_tpu_torch.train.train_vl import main
    out = tmp_path / 'run'
    argv = ['--model_name_or_path', str(coco_dir / 'model'),
            '--tokenizer', 'stub', '--dataset_config',
            str(coco_dir / 'data.py'), '--output_dir', str(out),
            '--per_device_train_batch_size', '2',
            '--gradient_accumulation_steps', '2', '--learning_rate', '3e-3',
            '--model_max_length', '128', '--save_steps', '1',
            '--save_total_limit', '2', '--dataloader_num_workers', '2',
            '--gradient_checkpointing', 'True', '--device', 'cpu']
    main(argv + ['--num_train_epochs', '1'])       # 4 batches -> 2 updates
    first = capsys.readouterr().out
    assert 'step 2/2' in first and 'training complete' in first
    assert sorted(p.name for p in out.glob('checkpoint-*.pt')) == [
        'checkpoint-1.pt', 'checkpoint-2.pt']
    after_first = torch.load(out / 'pytorch_model.bin', weights_only=True)

    main(argv + ['--num_train_epochs', '2'])       # resumes at update 2 of 4
    second = capsys.readouterr().out
    assert 'resumed from step 2' in second and 'step 4/4' in second
    assert 'step 1/' not in second
    losses = [float(line.split('loss ')[1].split()[0])
              for line in (first + second).splitlines()
              if line.startswith('step ')]
    assert len(losses) == 4 and np.isfinite(losses).all()

    # the export reloads through the reference-format loader
    model, cfg = load_groma(str(out), full_precision=True)
    assert cfg.llm.num_layers == 2
    final = model.state_dict()
    moved = [k for k in final if not torch.equal(final[k], after_first[k])]
    assert moved and all(k.startswith(('region_encoder.', 'img_txt_bridge.',
                                       'llm.', 'new_input_embs',
                                       'extra_lm_head')) for k in moved)


def test_compose_model_loads_llm_and_perceiver_checkpoints(tmp_path):
    """--llm + --perceiver: the two checkpoint directories (HF names, each
    with its config.json) land in the composed model; the new-token
    embeddings start at the mean base embedding."""
    from groma_tpu.checkpoint.hf_export import export_config, save_safetensors
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.config import ViTConfig
    from groma_tpu_torch.config import tiny_groma_config as port_tiny_config
    from groma_tpu_torch.train.train_vl import compose_model, parse_args
    # the released region encoder's 64 GroupNorm groups need 64k channels;
    # the port reads the configs into its own config classes
    base = port_tiny_config()
    cfg = base.replace(perceiver=base.perceiver.replace(vit=ViTConfig(
        hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
        image_size=56, dtype='float32')))
    sd = random_groma_full(cfg, seed=3).state_dict()
    for part, prefix, key in (('llm', 'llm.', 'llm_cfg'),
                              ('perceiver', 'perceiver.', 'perceiver_cfg')):
        (tmp_path / part).mkdir()
        save_safetensors({k[len(prefix):]: v.numpy() for k, v in sd.items()
                          if k.startswith(prefix)},
                         str(tmp_path / part / 'model.safetensors'))
        (tmp_path / part / 'config.json').write_text(
            json.dumps(export_config(cfg)[key]))
    args = parse_args(['--llm', str(tmp_path / 'llm'), '--perceiver',
                       str(tmp_path / 'perceiver'), '--dataset_config', 'x',
                       '--output_dir', 'o', '--max_region_num', '8'])
    model, got_cfg = compose_model(args, 'cpu')
    assert (got_cfg.llm, got_cfg.perceiver) == (cfg.llm, cfg.perceiver)
    composed = model.state_dict()
    for k, v in sd.items():
        if k.startswith(('llm.', 'perceiver.')):
            torch.testing.assert_close(composed[k], v, rtol=0, atol=0,
                                       msg=k)
    emb = composed['llm.model.embed_tokens.weight']
    torch.testing.assert_close(
        composed['new_input_embs.weight'],
        emb.mean(0, keepdim=True).expand(cfg.num_new_token, -1))
