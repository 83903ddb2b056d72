"""The port's distribution (``parallel/mesh.py``, the sharded steps and
checkpoints) against the JAX package's single-process steps.

Two gloo ranks (``torch.multiprocessing`` with the spawn method, the
process group's ``init_method`` a file under ``tmp_path``, so that no port
is shared between test workers; every group is joined with a timeout of
its own, so a hang fails its test alone) train the tiny model with FSDP
over a (dp 1, fsdp 2) mesh and with plain data parallelism over (dp 2,
fsdp 1), each rank on its half of the global batch:

* one ``train_vl`` update (two micro-batches of accumulation, stage 3:
  the LLM trains, the perceiver is frozen inside wrapped units): the
  gradient after the first micro-batch within 1e-4 of max|grad| of JAX's
  gradient of the global loss, the losses within 1e-5 relative, the
  parameters after the update within 1e-4;
* three ``train_det`` steps (sources coco, sa1b, coco: each step leaves
  one objectness head without a gradient; clipping at a global norm of
  1): losses within 1e-5 relative, parameters within 1e-4, each leaf's
  update within 1e-3 of JAX's in relative Frobenius norm;
* the halves differ in their supervised token and box counts (one rank
  holds no box at all in the third step), so a mean of per-rank means
  would miss;
* a checkpoint written by the two ranks resumes on the two ranks (their
  shards bitwise) and on one process (the parameters bitwise).
"""

import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from groma_tpu.checkpoint.hf_export import export_groma, export_perceiver
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.constants import IGNORE_INDEX
from groma_tpu.data.tokenization import SpecialIds, expand_template
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.perceiver import Perceiver as JPerceiver
from groma_tpu.parallel.mesh import discover_launch_env as j_discover
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_det_train_step as j_det_step
from groma_tpu.train.steps import make_vl_train_step as j_vl_step
from groma_tpu_torch.parallel import mesh

torch.set_num_threads(2)
CFG = tiny_groma_config()
VL_LR, DET_LR = 1e-3, 2e-4
DET_SOURCES = ('coco', 'sa1b', 'coco')
BOX_COUNTS = ((3, 5), (6, 2), (0, 4))
# HSDP, 2 replicas of 2 shards: four images a batch, one a rank
HSDP_COUNTS = ((3, 5, 1, 2), (6, 2, 0, 4), (0, 4, 2, 2))
JOIN_TIMEOUT = 300          # seconds a spawned group may take
UPDATE_TOL = 1e-3
# exact gradient 0 (a key bias is cancelled by the softmax): Adam turns
# its f32 noise into update noise, as tests/test_torch_det.py notes
NO_GRADIENT = ('self_attn.k_proj.bias',)


# ---------------------------------------------------------------- data

def _vl_batch(seed=0):
    """Two grounded rows of different lengths and ground-box counts."""
    sp = SpecialIds.from_base_vocab(CFG.llm.vocab_size)
    rng = np.random.default_rng(seed)

    def row(n):
        raw = np.concatenate([[1], rng.integers(3, 256, 5), [sp.image], [7],
                              [sp.region], rng.integers(3, 256, n), [sp.gbox],
                              rng.integers(3, 256, 4), [sp.gbox], [2]])
        labels = raw.copy()
        labels[:9] = IGNORE_INDEX
        return expand_template(raw, labels, sp, CFG.num_image_tokens,
                               CFG.max_region_num, CFG.max_seq_len)

    rows = [row(CFG.max_seq_len - 60), row(CFG.max_seq_len // 3)]
    batch = {k: np.stack([r[k] for r in rows])
             for k in ('input_ids', 'labels', 'region_slot', 'valid')}
    size = CFG.perceiver.image_size
    batch['images'] = rng.standard_normal((2, size, size, 3)).astype(
        np.float32)
    batch['ground_boxes'] = rng.uniform(0.3, 0.6, (2, 3, 4)).astype(
        np.float32)
    batch['ground_valid'] = np.array([[True, True, True],
                                      [True, True, False]])
    batch['refer_boxes'] = np.zeros((2, 1, 4), np.float32)
    batch['refer_valid'] = np.zeros((2, 1), bool)
    return batch


def _det_batches(box_counts=BOX_COUNTS, seed=6):
    """One detection batch for each entry of ``box_counts``, an image for
    each of its counts (that many valid boxes)."""
    rng = np.random.default_rng(seed)
    b = len(box_counts[0])
    images = rng.standard_normal((b, 56, 56, 3)).astype(np.float32)
    out = []
    for i, counts in enumerate(box_counts):
        t = 6
        valid = np.zeros((b, t), bool)
        for r, n in enumerate(counts):
            valid[r, :n] = True
        boxes = np.concatenate([rng.uniform(0.25, 0.7, (b, t, 2)),
                                rng.uniform(0.05, 0.4, (b, t, 2))], -1)
        out.append({'images': images if i % 2 == 0 else images[::-1].copy(),
                    'targets': {
                        'class_labels': np.zeros((b, t), np.int32),
                        'boxes': np.where(valid[..., None], boxes,
                                          0.0).astype(np.float32),
                        'valid': valid}})
    return out


def _half(tree, rank, world):
    if isinstance(tree, dict):
        return {k: _half(v, rank, world) for k, v in tree.items()}
    n = tree.shape[0] // world
    return tree[rank * n:(rank + 1) * n]


def _off_kinks(params, rng):
    """Noise (std 1e-2) on every leaf that starts at zero (see
    tests/test_torch_det.py: the init's sampling points sit on the
    bilinear weight's kinks)."""
    return jax.tree_util.tree_map(
        lambda p: p if p.any() else
        rng.normal(0.0, 1e-2, p.shape).astype(p.dtype), params)


# ------------------------------------------------------- the ranks' side

def _ranks(rank, world, init, dp, vl_sd, det_sd, out_dir):
    """One rank: the VL update, the detection steps and the checkpoint
    round trips; rank 0 writes what the test reads."""
    import torch.distributed as dist

    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.train import optimizer as topt
    from groma_tpu_torch.train.steps import batch_to, make_vl_train_step
    from groma_tpu_torch.train.train_vl import maybe_resume, save_checkpoint

    torch.set_num_threads(1)
    pm.init_distributed('cpu', init_method=init, num_processes=world,
                        process_id=rank)
    grid = pm.make_mesh(dp=dp, device_type='cpu')
    out = {}

    def vl_model():
        m = from_state_dict(vl_sd, CFG, full_precision=True)
        pm.shard_model(m, grid)
        return m, topt.make_adamw(m, VL_LR, accum_steps=2,
                                  frozen_pred=topt.freeze_predicate(
                                      freeze_perceiver=True))

    model, opt = vl_model()
    step = make_vl_train_step(model, opt, permute_regions=False)
    local = batch_to(_half(_vl_batch(), rank, world), 'cpu')
    first = step(local)
    out['vl_grads'] = {n: p.grad.full_tensor() for n, p in
                       model.named_parameters() if p.grad is not None}
    second = step(local)
    assert (first['updated'], second['updated']) == (False, True)
    out['vl_losses'] = [float(first['loss']), float(second['loss'])]
    out['vl_params'] = pm.full_model_state(model)

    ck = os.path.join(out_dir, 'ckpt')
    save_checkpoint(ck, 1, model, opt, CFG, keep=1)
    dist.barrier()
    again, again_opt = vl_model()
    assert maybe_resume(ck, again, again_opt) == 1
    for (n, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p.to_local(), q.to_local()), n
    ours, theirs = opt.opt.state_dict(), again_opt.opt.state_dict()
    for i, st in ours['state'].items():
        for k, v in st.items():
            w = theirs['state'][i][k]
            assert torch.equal(v.to_local() if hasattr(v, 'to_local') else v,
                               w.to_local() if hasattr(w, 'to_local') else w)
    assert (again_opt.count, again_opt.micro) == (opt.count, opt.micro)

    out['det_losses'], out['det_params'] = _det_steps(rank, world, grid,
                                                      det_sd, BOX_COUNTS)
    if rank == 0:
        torch.save(out, os.path.join(out_dir, 'result.pt'))
    dist.barrier()
    dist.destroy_process_group()


def _det_steps(rank, world, grid, det_sd, box_counts, grads_of=None):
    """The three detection steps of ``_det_batches(box_counts)`` on this
    rank's slice of each batch, the Perceiver sharded over ``grid`` (None:
    a single process) -> (each step's losses, the parameters gathered
    whole).  ``grads_of`` (name, list): that parameter's gradient, as the
    optimizer reads it, appended at each step."""
    from groma_tpu_torch.models.perceiver import Perceiver
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.train import optimizer as topt
    from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step
    det = Perceiver(CFG.perceiver)
    det.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in det_sd.items()}, strict=True)
    if grid is not None:
        pm.shard_model(det, grid)
    det_opt = topt.make_adamw(
        det, DET_LR, weight_decay=1e-4, max_grad_norm=1.0,
        lr_mult_rules=topt.det_lr_mult_rules(0.1),
        frozen_pred=topt.freeze_predicate(freeze_vis_encoder=True))
    if grads_of is not None:
        name, out = grads_of
        param, adam_step = det.get_parameter(name), det_opt.opt.step

        def read_grad_then_step(*a, **kw):
            out.append(param.grad.detach().clone().numpy())
            return adam_step(*a, **kw)
        det_opt.opt.step = read_grad_then_step
    steps = {s: make_det_train_step(det, CFG.perceiver.ddetr, det_opt, s)
             for s in set(DET_SOURCES)}
    losses = [{k: float(v) for k, v in
               steps[src](det_batch_to(_half(b, rank, world), 'cpu')).items()}
              for src, b in zip(DET_SOURCES, _det_batches(box_counts))]
    return losses, pm.full_model_state(det)


def _hsdp_ranks(rank, world, init, dp, det_sd, out_dir):
    """One rank of the detection steps under HSDP (dp replicas of
    world / dp shards)."""
    import torch.distributed as dist

    from groma_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    pm.init_distributed('cpu', init_method=init, num_processes=world,
                        process_id=rank)
    grid = pm.make_mesh(dp=dp, device_type='cpu')
    losses, params = _det_steps(rank, world, grid, det_sd, HSDP_COUNTS)
    if rank == 0:
        torch.save({'det_losses': losses, 'det_params': params},
                   os.path.join(out_dir, 'result.pt'))
    dist.barrier()
    dist.destroy_process_group()


def _train_det_ranks(rank, world, init, argv, out_dir):
    """One rank of ``train_det`` through its own entry point (the group
    joined first, from a file, so that no port is taken)."""
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.train import train_det
    torch.set_num_threads(1)
    pm.init_distributed('cpu', init_method=init, num_processes=world,
                        process_id=rank)
    res = train_det.train(train_det.parse_args(argv), t_tiny().perceiver,
                          'cpu')
    if rank == 0:
        torch.save(res['losses'], os.path.join(out_dir, 'result.pt'))
    torch.distributed.destroy_process_group()


def _spawn(tmp_path, world, *args, target=_ranks):
    """Run ``target`` on ``world`` spawned processes; every one must end
    with code 0 within JOIN_TIMEOUT seconds (the rest are killed)."""
    ctx = multiprocessing.get_context('spawn')
    init = 'file://' + str(tmp_path / 'group')
    procs = [ctx.Process(target=target,
                         args=(r, world, init, *args, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [p.pid for p in procs if p.is_alive()]
        assert not hung, f'ranks {hung} still running after {JOIN_TIMEOUT} s'
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return torch.load(tmp_path / 'result.pt', weights_only=False)


# ------------------------------------------------------- the JAX side

@pytest.fixture(scope='module')
def reference():
    """JAX's single-process VL update (two micro-batches under
    optax.MultiSteps) and detection steps on the global batches, and the
    weights both sides start from."""
    jmodel = JGroma(CFG)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in _vl_batch().items()}
    tx = optax.MultiSteps(jopt.make_adamw(VL_LR, frozen_pred=(
        jopt.freeze_predicate(freeze_perceiver=True))), 2)
    step = jax.jit(j_vl_step(jmodel, tx, permute_regions=False))
    state = TrainState.create(params, tx)
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        return jmodel.apply({'params': p}, images=batch['images'],
                            input_ids=batch['input_ids'],
                            region_slot=batch['region_slot'],
                            base_valid=batch['valid'], labels=batch['labels'],
                            refer_boxes=batch['refer_boxes'],
                            refer_valid=batch['refer_valid'],
                            ground_boxes=batch['ground_boxes'],
                            ground_valid=batch['ground_valid'], rng=key,
                            permute=False)['loss']
    grads = jax.jit(jax.grad(loss_fn))(params)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch, key)
        losses.append(float(metrics['loss']))
    vl = {'losses': losses, 'grads': export_groma(
        jax.tree_util.tree_map(np.asarray, grads), CFG),
        'params': export_groma(jax.tree_util.tree_map(
            np.asarray, state.params), CFG), 'start': params}

    return vl, _jax_det_steps(BOX_COUNTS)


def _jax_det_steps(box_counts):
    """JAX's three single-process detection steps on
    ``_det_batches(box_counts)`` -> {'losses', 'start', 'params'} (the
    parameters under the reference's names)."""
    pc = CFG.perceiver
    jdet = JPerceiver(pc)
    dparams = jax.jit(jdet.init)(jax.random.PRNGKey(0), np.zeros(
        (2, 56, 56, 3), np.float32))['params']
    dparams = _off_kinks(jax.tree_util.tree_map(np.asarray, dparams),
                         np.random.default_rng(7))
    dtx = jopt.make_adamw(
        DET_LR, weight_decay=1e-4, max_grad_norm=1.0,
        lr_mult_rules=jopt.det_lr_mult_rules(0.1),
        frozen_pred=jopt.freeze_predicate(freeze_vis_encoder=True))
    dstate = TrainState.create(dparams, dtx)
    dsteps = {s: jax.jit(j_det_step(jdet, pc.ddetr, dtx, s))
              for s in set(DET_SOURCES)}
    dlosses = []
    for src, b in zip(DET_SOURCES, _det_batches(box_counts)):
        dstate, ls = dsteps[src](dstate, jax.tree_util.tree_map(jnp.asarray,
                                                                 b))
        dlosses.append({k: float(v) for k, v in ls.items()})

    def exp(p):
        return export_perceiver(p, pc.vit.num_layers,
                                pc.ddetr.encoder_layers,
                                pc.ddetr.decoder_layers,
                                pc.ddetr.num_feature_levels,
                                patch_size=pc.vit.patch_size)
    return {'losses': dlosses, 'start': exp(dparams),
            'params': exp(jax.tree_util.tree_map(np.asarray,
                                                 dstate.params))}


@pytest.fixture(scope='module', params=[(1, 2), (2, 1)],
                ids=['fsdp2', 'dp2'])
def runs(request, reference, tmp_path_factory):
    """The two ranks' results at mesh (dp, fsdp) -> (dp, results, the
    checkpoint directory)."""
    dp, fsdp = request.param
    vl, det = reference
    tmp = tmp_path_factory.mktemp(f'ranks_dp{dp}')
    res = _spawn(tmp, dp * fsdp, dp, export_groma(vl['start'], CFG),
                 det['start'])
    return dp, res, tmp / 'ckpt'


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- tests

@pytest.mark.parametrize('env', [
    {},
    {'RANK': '3', 'WORLD_SIZE': '8', 'MASTER_ADDR': '10.0.0.1',
     'MASTER_PORT': '1234'},
    {'RANK': '0', 'WORLD_SIZE': '2', 'MASTER_ADDR': 'a',
     'SLURM_PROCID': '1', 'SLURM_NTASKS': '4'},
    {'SLURM_PROCID': '1', 'SLURM_NTASKS': '4', 'SLURM_NODELIST': 'node[1-4]'},
    {'SLURM_PROCID': '2', 'SLURM_NTASKS': '4',
     'SLURM_LAUNCH_NODE_IPADDR': '10.1.1.1', 'MASTER_PORT': '77'},
    {'COORDINATOR_ADDRESS': 'h:9', 'JAX_NUM_PROCESSES': '2',
     'JAX_PROCESS_ID': '1'},
    {'COORDINATOR_ADDRESS': 'h:9'},
])
def test_discover_launch_env_matches_jax(env):
    assert mesh.discover_launch_env(env) == j_discover(env)


def test_a_single_process_needs_no_group_and_refuses_what_it_cannot_do():
    assert mesh.init_distributed('cpu') is False
    assert mesh.rank_and_world() == (0, 1)
    assert mesh.make_mesh(dp=1, device_type='cpu') is None
    with pytest.raises(ValueError, match='torchrun'):
        mesh.make_mesh(dp=1, tp=2, device_type='cpu')
    with pytest.raises(ValueError, match='torchrun'):
        mesh.make_mesh(dp=2, device_type='cpu')


@pytest.mark.parametrize('module', ['train_vl', 'train_det'])
def test_trainers_parse_tensor_parallelism(module):
    import importlib
    parse = importlib.import_module(
        f'groma_tpu_torch.train.{module}').parse_args
    base = ['--dataset_config', 'x', '--output_dir', 'o']
    assert parse(base + ['--dp', '4']).dp == 4
    args = parse(base + ['--dp', '2', '--tp', '2'])
    assert (args.dp, args.tp) == (2, 2)
    assert parse(base).tp == 1


def test_rank_batches_cut_contiguous_slices_and_refuse_a_ragged_batch():
    batches = [[0, 1, 2, 3], [7, 6, 5, 4]]
    assert [list(mesh.RankBatches(batches, r, 2)) for r in (0, 1)] == [
        [[0, 1], [7, 6]], [[2, 3], [5, 4]]]
    with pytest.raises(ValueError, match='does not divide'):
        list(mesh.RankBatches([[0, 1, 2]], 0, 2))


def test_permute_rows_shuffle_a_slice_as_the_whole_batch_does():
    """A rank's rows draw the global batch's noise and keep their own
    rows of it: the kept regions come out in the unsharded order."""
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    model = random_groma_full(CFG.replace(box_score_thres=0.0), seed=0)
    images = torch.from_numpy(_vl_batch()['images'])

    def selected(imgs, rows):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            vis = model.vision(imgs, generator=gen, permute=True,
                               permute_rows=rows)
        return vis['selected_boxes'], vis['selected_mask']
    boxes, kept = selected(images, None)
    assert int(kept.sum(1).min()) > 2
    for rows, sl in (((1, 2), slice(1, 2)), ((0, 2), slice(0, 1))):
        got_boxes, got_kept = selected(images[sl], rows)
        assert torch.equal(got_kept, kept[sl])
        torch.testing.assert_close(got_boxes, boxes[sl], atol=1e-5, rtol=0)


def test_the_halves_differ_in_tokens_and_boxes():
    b = _vl_batch()
    supervised = (b['labels'] != IGNORE_INDEX).sum(1)
    assert supervised[0] != supervised[1]
    assert b['ground_valid'].sum(1).tolist() == [3, 2]
    assert all(a != c for a, c in BOX_COUNTS) and 0 in BOX_COUNTS[2]


def test_vl_gradient_matches_jax(runs, reference):
    _, res, _ = runs
    want = reference[0]['grads']
    got = res['vl_grads']
    assert got and not any(k.startswith('perceiver.') for k in got)
    assert any(k.startswith('llm.model.layers.') for k in got)
    for k, g in got.items():
        w = want[k]
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


def test_vl_losses_match_jax(runs, reference):
    _, res, _ = runs
    np.testing.assert_allclose(res['vl_losses'], reference[0]['losses'],
                               rtol=1e-5)


def test_vl_params_after_the_update_match_jax(runs, reference):
    _, res, _ = runs
    want = reference[0]['params']
    got = res['vl_params']
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def _same_det_losses(ref, res):
    for want, got in zip(ref['losses'], res['det_losses']):
        got = dict(got)
        assert got.pop('updated') == 1.0
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_det_losses_match_jax(runs, reference):
    _same_det_losses(reference[1], runs[1])


def test_det_params_and_updates_match_jax(runs, reference):
    _same_det_params(reference[1], runs[1])


def _same_det_params(ref, res):
    start, want = ref['start'], ref['params']
    got = {k: _np(v) for k, v in res['det_params'].items()}
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
        if k.startswith('vis_encoder.'):
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
            continue
        if k.endswith(NO_GRADIENT):
            continue
        dj, dp = want[k] - start[k], got[k] - start[k]
        assert np.linalg.norm(dj) > 0, k
        err = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
        assert err < UPDATE_TOL, (k, err)
        moved += 1
    assert moved > 50


def test_a_two_rank_checkpoint_resumes_on_one_process(runs, reference):
    """Saved by two ranks (whole tensors, rank 0's file), resumed by a
    single process into a fresh model and optimizer: the parameters and
    Adam's moments bitwise those the ranks held."""
    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.train import optimizer as topt
    from groma_tpu_torch.train.train_vl import maybe_resume
    _, res, ck = runs
    assert sorted(os.listdir(ck)) == ['checkpoint-1.pt']
    model = from_state_dict(export_groma(reference[0]['start'], CFG), CFG,
                            full_precision=True)
    opt = topt.make_adamw(model, VL_LR, accum_steps=2,
                          frozen_pred=topt.freeze_predicate(
                              freeze_perceiver=True))
    assert maybe_resume(str(ck), model, opt) == 1
    got = model.state_dict()
    for k, v in res['vl_params'].items():
        assert torch.equal(got[k], v), k
    assert (opt.count, opt.micro) == (1, 2)
    saved = torch.load(ck / 'checkpoint-1.pt', weights_only=True)
    assert json.dumps(saved['config'], sort_keys=True) == json.dumps(
        CFG.to_dict(), sort_keys=True)
    state = opt.opt.state_dict()['state']
    assert state.keys() == saved['optimizer']['opt']['state'].keys()
    for i, st in state.items():
        for k, v in st.items():
            assert torch.equal(v, saved['optimizer']['opt']['state'][i][k])


def _det_data(root):
    """A COCO-format set of two sources (6 coco and 4 sa1b images, 1 to 4
    boxes each) and its dataset config."""
    from PIL import Image
    (root / 'imgs').mkdir(parents=True)
    rng = np.random.default_rng(11)
    for name, n in (('coco', 6), ('sa1b', 4)):
        images, anns = [], []
        for i in range(n):
            fn = f'{name}{i}.png'
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                            ).save(root / 'imgs' / fn)
            images.append({'id': i, 'file_name': fn, 'width': 64,
                           'height': 48})
            for _ in range(1 + (i * 7 + len(name)) % 4):
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
    return root / 'data.py'


def test_train_det_on_two_ranks_is_the_one_process_run(tmp_path):
    """``train_det`` through its entry point on two gloo ranks (FSDP, each
    rank half of every global batch of 2) and in one process: an epoch of
    5 steps, both sources, the losses within 1e-5 relative and the exported
    weights within 1e-4; the two-rank run's checkpoint and export written
    once, by rank 0."""
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    from groma_tpu_torch.train import train_det
    cfg_file = _det_data(tmp_path / 'data')

    def argv(out):
        return ['--dataset_config', str(cfg_file), '--output_dir', str(out),
                '--per_device_train_batch_size', '2', '--num_train_epochs',
                '1', '--warmup_steps', '1', '--logging_steps', '1',
                '--dataloader_num_workers', '1', '--device', 'cpu']
    ranks = tmp_path / 'ranks'
    ranks.mkdir()
    got = _spawn(ranks, 2, argv(ranks / 'out'), target=_train_det_ranks)
    one = train_det.train(train_det.parse_args(argv(tmp_path / 'one')),
                          t_tiny().perceiver, 'cpu')
    assert len(got) == len(one['losses']) == 5
    for g, w in zip(got, one['losses']):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert sorted(os.listdir(ranks / 'out')) == [
        'checkpoint-5.pt', 'config.json', 'pytorch_model.bin']
    a = torch.load(ranks / 'out' / 'pytorch_model.bin', weights_only=True)
    b = torch.load(tmp_path / 'one' / 'pytorch_model.bin', weights_only=True)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


# the one leaf whose update the port's single-process det steps part from
# JAX's by more than UPDATE_TOL at the HSDP batches
DEPARTING_LEAF = 'ddetr_transformer.bbox_embed.0.layers.2.weight'


@pytest.fixture(scope='module')
def hsdp_one_process():
    """JAX's and the port's single-process det steps on the HSDP batches
    -> (JAX's result, the port's losses, parameters and its gradients of
    DEPARTING_LEAF at each step)."""
    ref = _jax_det_steps(HSDP_COUNTS)
    grads = []
    losses, params = _det_steps(0, 1, None, ref['start'], HSDP_COUNTS,
                                grads_of=(DEPARTING_LEAF, grads))
    return ref, losses, params, grads


def test_hsdp_det_steps_match_one_process_and_jax(tmp_path,
                                                  hsdp_one_process):
    """Four gloo ranks, HSDP: 2 replicas of 2 FSDP shards, one image a
    rank, box counts differing between ranks (one empty in each of the
    last two steps): the gradient averaged over the replicas of the
    shards' reduce-scatter, the clipping norm summed over the shard axis
    only.  The losses within 1e-5 relative and the parameters within 1e-4
    of JAX's; each leaf's update within UPDATE_TOL of the port's own
    single-process steps on the same batches.  (Against JAX one leaf's
    update, the first box head's last weight, parts by 2.2e-3 at these
    four images in a single process too: see the next test.)"""
    from groma_tpu_torch.parallel import mesh as pm
    ref, one_losses, one_params, _ = hsdp_one_process
    res = _spawn(tmp_path, 4, 2, ref['start'], target=_hsdp_ranks)
    _same_det_losses(ref, res)
    assert pm.rank_and_world() == (0, 1)
    for want, got in zip(one_losses, res['det_losses']):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    _same_det_params({'start': ref['start'],
                      'params': {k: _np(v) for k, v in one_params.items()}},
                     res)
    for k, v in ref['params'].items():
        np.testing.assert_allclose(_np(res['det_params'][k]), v, rtol=0,
                                   atol=1e-4, err_msg=k)


def test_the_det_leaf_parting_from_jax_parts_at_adams_eps(hsdp_one_process):
    """The port's single-process update of DEPARTING_LEAF parts from
    JAX's by more than UPDATE_TOL, and all of it lies in the elements
    whose first-step gradient is below 1e-7, ten times Adam's eps of
    1e-8: there Adam's division turns the gradient's f32 rounding into
    its update.  Every other leaf's update is within UPDATE_TOL."""
    ref, _, params, grads = hsdp_one_process
    start = ref['start'][DEPARTING_LEAF]
    want = ref['params'][DEPARTING_LEAF] - start
    diff = _np(params[DEPARTING_LEAF]) - start - want
    at_eps = np.abs(grads[0]) < 1e-7
    assert len(grads) == 3 and at_eps.any() and not at_eps.all()
    assert np.linalg.norm(diff) / np.linalg.norm(want) > UPDATE_TOL
    assert np.linalg.norm(np.where(at_eps, 0.0, diff)) / \
        np.linalg.norm(want) < 1e-4
    _same_det_params(
        {'start': {k: v for k, v in ref['start'].items()
                   if k != DEPARTING_LEAF},
         'params': {k: v for k, v in ref['params'].items()
                    if k != DEPARTING_LEAF}},
        {'det_params': {k: v for k, v in params.items()
                        if k != DEPARTING_LEAF}})
