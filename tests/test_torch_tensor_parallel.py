"""The port's tensor parallelism (``parallel/mesh.py``'s tp axis and
``parallel/tensor_parallel.py``) against the JAX package's single-device
results, which is what ``tests/test_sharding.py`` asserts GSPMD
reproduces.

Gloo ranks on the CPU (``torch.multiprocessing``'s spawn method, the
group's ``init_method`` a file under ``tmp_path``; each group joined with
a timeout of its own, so a hang fails its tests alone), a few groups, each
running several checks:

* placements (no group): every parameter of ``tiny_groma_config()`` and
  every leaf of a quantized tree is cut where JAX's ``param_pspec`` puts
  its tp / vocab axis, through the loader's name map (``export_groma`` on
  a tree whose leaves carry their own index) with a kernel's dim
  transposed, at tp = 2 and 4 (the 114 new-token rows whole at 4); the
  whole-head departure at GQA with fewer KV heads than tp; the DDETR
  decoder's ``q_proj`` / ``k_proj`` / ``v_proj`` whole;
* serving, four ranks: ``LlamaForCausalLM`` at (dp 2, tp 2) within 2e-4 /
  1e-4 of JAX's logits, its greedy prefill and 5 decode steps exact; a
  GQA LLaMA at tp 4 (k/v whole beside one query head a rank) the same;
  ``BatchEngine(qp=None)`` on a Groma cut over tp 2 (``mesh.cut_tp``)
  on two replicas, rank 0 of each tp pair taking the requests (the
  second submitted while the first decodes): the tokens those of JAX's
  ``Generator``, exactly;
* training, four ranks: one ``train_vl`` update (two micro-batches) at
  (fsdp 2, tp 2), at (dp 2, tp 2) and at tp 4 (the 114 new-token rows
  whole on every rank): the first micro-batch's gradient within 1e-4 of
  max|grad| of JAX's (at tp 4 every rank's, as its optimizer reads it),
  the losses within 1e-5 relative, the parameters after the update within
  1e-4; the same step with the copy-to-tp backward all-reduce left out
  misses the gradient check, and with the reduce-from-tp forward one left
  out the loss; a
  tp = 2 checkpoint resumes on the four ranks (their slices bitwise) and
  on one process (parameters and Adam's moments bitwise);
* ``train_det --tp 2`` on four ranks (the detector replicated over tp,
  FSDP over the two data ranks) is the one-process run.
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

from groma_tpu.checkpoint.hf_export import export_groma, export_llama
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import LlamaConfig as JLlamaConfig
from groma_tpu.config import tiny_groma_config
from groma_tpu.constants import IGNORE_INDEX
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.data.tokenization import SpecialIds, expand_template
from groma_tpu.eval.generate import Generator as JGenerator
from groma_tpu.models.llama_quant import quantize_llama_params as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama import LlamaForCausalLM as JLlama
from groma_tpu.models.llama import make_kv_cache as j_cache
from groma_tpu.parallel.mesh import param_pspec
from groma_tpu.train import optimizer as jopt
from groma_tpu.train.steps import TrainState
from groma_tpu.train.steps import make_vl_train_step as j_vl_step
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.parallel import mesh

torch.set_num_threads(2)
CFG = tiny_groma_config()
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=4, dtype='float32')
GQA = dict(LLAMA, num_kv_heads=2)       # 2 KV heads: whole at tp 4
VL_LR = 1e-3
ENGINE_MAX_NEW = 5
DECODE_STEPS = 5
JOIN_TIMEOUT = 300          # seconds a spawned group may take


# ---------------------------------------------------------- placements

class _Mesh:
    """What ``param_pspec`` reads of a mesh: its axis sizes."""

    def __init__(self, tp, fsdp):
        self.shape = {'dp': 1, 'fsdp': fsdp, 'tp': tp}


def _jax_tp_dim(path, shape, tp, fsdp):
    """The dim JAX's ``param_pspec`` puts 'tp' on (alone or with fsdp), or
    None."""
    spec = param_pspec(path, shape, _Mesh(tp, fsdp), fsdp_min_size=1)
    for d, s in enumerate(spec):
        if s == 'tp' or (isinstance(s, tuple) and 'tp' in s):
            return d
    return None


def _path(path):
    return '/'.join(str(getattr(p, 'key', p)) for p in path)


def _jax_paths_of_port_names(cfg):
    """Port parameter name -> (JAX's path, JAX's shape), through
    ``export_groma`` on a tree whose leaves hold their own index."""
    m = JGroma(cfg)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           **_dummy_batch(cfg)))['params']
    flat, tdef = jax.tree_util.tree_flatten_with_path(shapes)
    marked = jax.tree_util.tree_unflatten(
        tdef, [np.full(leaf.shape, i, np.float32)
               for i, (_, leaf) in enumerate(flat)])
    out = {}
    for name, v in export_groma(marked, cfg).items():
        i = int(v.reshape(-1)[0])
        assert (v == i).all(), name
        out[name] = (_path(flat[i][0]), tuple(flat[i][1].shape))
    return out


@pytest.fixture(scope='module')
def name_map():
    return _jax_paths_of_port_names(CFG)


def _port_dim(jpath, jdim, ndim):
    if jdim is None:
        return None
    return ndim - 1 - jdim if jpath.endswith('/kernel') else jdim


@pytest.mark.parametrize('tp,fsdp', [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_every_groma_parameter_is_cut_where_jax_puts_tp(name_map, tp, fsdp):
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    params = dict(random_groma_full(t_tiny()).named_parameters())
    assert params.keys() == name_map.keys()
    hd = CFG.llm.hidden_size // CFG.llm.num_heads
    cut = {}
    for name, p in params.items():
        jpath, jshape = name_map[name]
        want = _port_dim(jpath, _jax_tp_dim(jpath, jshape, tp, fsdp),
                         len(jshape))
        got = mesh.tp_placement(name, tuple(p.shape), tp, hd)
        assert got == want, (name, jpath, got, want)
        if got is not None:
            cut[name] = got
    llm_linears = 7 * CFG.llm.num_layers
    vocab = {'llm.model.embed_tokens.weight', 'llm.lm_head.weight'}
    new = {'new_input_embs.weight', 'extra_lm_head.weight'}
    assert vocab <= cut.keys()
    # 114 rows: cut at tp 2, whole at tp 4 (JAX drops tp last)
    assert (new <= cut.keys()) == (tp == 2)
    assert len(cut) == llm_linears + 2 + (2 if tp == 2 else 0)
    assert all(k.startswith('llm.') or k in new for k in cut)


def test_the_detector_matches_no_rule(name_map):
    """The DDETR decoder's self-attention is ``self_attn.q_proj`` here and
    ``self_attn_q`` in JAX: no rule cuts it, nor anything else of the
    Perceiver or the region encoder."""
    for part in 'qkv':
        names = [k for k in name_map if 'decoder.layers.' in k
                 and f'self_attn.{part}_proj' in k]
        assert names and all(f'/self_attn_{part}/' in name_map[k][0]
                             for k in names)
    for name, (jpath, jshape) in name_map.items():
        if name.startswith(('perceiver.', 'region_encoder.',
                            'img_txt_bridge.')):
            assert mesh.jax_path(name) is None, name
            assert _jax_tp_dim(jpath, jshape, 2, 1) is None, jpath
            assert mesh.tp_placement(name, jshape[::-1], 2, 16) is None


@pytest.mark.parametrize('bits', [8, 16])
@pytest.mark.parametrize('tp', [2, 4])
def test_quantized_leaves_are_cut_where_jax_puts_tp(bits, tp):
    """The quantized tree's leaves (fused ``qkv_proj`` / ``gate_up_proj``
    and their scales, ``o_proj`` / ``down_proj``, the padded ``lm_head``)
    keep JAX's layout, so its rules apply to them undimmed."""
    from groma_tpu_torch.checkpoint.loader import random_groma_full
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    from groma_tpu_torch.models.llama_quant import quantize_llama_params
    model = random_groma_full(t_tiny())
    sd = {k[len('llm.'):]: v for k, v in model.state_dict().items()
          if k.startswith('llm.')}
    ours = quantize_llama_params(sd, model.cfg.llm, bits=bits)
    theirs = j_quantize(_llama_tree_from_hf(sd, CFG.llm), CFG.llm, bits=bits)
    tflat = dict((_path(p), v) for p, v in
                 jax.tree_util.tree_flatten_with_path(theirs)[0])
    seen = 0
    for i, layer in enumerate(ours['layers']):
        for key, leaf in layer.items():
            if not isinstance(leaf, dict):
                continue
            for part, v in leaf.items():
                jpath = f'layers/[{i}]/{key}/{part}'
                jshape = tuple(tflat[jpath].shape)
                assert tuple(v.shape) == jshape, jpath
                got = mesh.tp_placement(f'layers.{i}.{key}.{part}',
                                        jshape, tp)
                assert got == _jax_tp_dim(jpath, jshape, tp, 1), jpath
                seen += 1
    for part, v in ours['lm_head'].items():
        jshape = tuple(tflat[f'lm_head/{part}'].shape)
        assert mesh.tp_placement(f'lm_head.{part}', jshape, tp) == \
            _jax_tp_dim(f'lm_head/{part}', jshape, tp, 1)
    assert seen == CFG.llm.num_layers * (4 if bits == 16 else 8)


def _llama_tree_from_hf(sd, c):
    """HF-named LLaMA tensors -> JAX's LLaMA tree (the inverse of
    ``export_llama``)."""
    def n(k):
        return np.asarray(sd[k].detach().float().numpy())
    out = {'norm': {'scale': n('model.norm.weight')}}
    for i in range(c.num_layers):
        p = f'model.layers.{i}.'
        out[f'layers_{i}'] = {
            'input_layernorm': {'scale': n(p + 'input_layernorm.weight')},
            'post_attention_layernorm': {
                'scale': n(p + 'post_attention_layernorm.weight')},
            'self_attn': {proj: {'kernel': n(p + f'self_attn.{proj}.weight').T}
                          for proj in ('q_proj', 'k_proj', 'v_proj',
                                       'o_proj')},
            **{proj: {'kernel': n(p + f'mlp.{proj}.weight').T}
               for proj in ('gate_proj', 'up_proj', 'down_proj')}}
    return {'model': out, 'embed_tokens': n('model.embed_tokens.weight'),
            'lm_head': {'kernel': n('lm_head.weight').T}}


def test_attention_is_cut_at_whole_heads_only():
    """The departure from JAX (ROADMAP.md §3): at GQA with 2 KV heads of
    16 over tp 4, JAX cuts k_proj's 32 columns into quarters of a head;
    the port keeps k/v whole on every rank.  q/o (4 heads) are cut as JAX
    cuts them, and so is everything at tp 2."""
    hd = 16
    k = ('model.layers.0.self_attn.k_proj.weight', (32, 64))
    q = ('model.layers.0.self_attn.q_proj.weight', (64, 64))
    o = ('model.layers.0.self_attn.o_proj.weight', (64, 64))
    jk = 'model/layers_0/self_attn/k_proj/kernel'
    assert _jax_tp_dim(jk, (64, 32), 4, 1) == 1           # JAX: inside a head
    assert mesh.tp_placement(*k, 4, hd) is None          # the port: whole
    assert mesh.tp_placement(*k, 4) == 0                 # JAX's rule alone
    assert mesh.tp_placement(*k, 2, hd) == 0
    assert mesh.tp_placement(*q, 4, hd) == 0
    assert mesh.tp_placement(*o, 4, hd) == 1


# ------------------------------------------------------------ spawning

def _spawn(tmp_path, world, target, *args):
    """Run ``target`` on ``world`` spawned processes; every one must end
    with code 0 within JOIN_TIMEOUT seconds (the rest are killed) ->
    each rank's saved result (None where it saved none)."""
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
    return [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
            if (tmp_path / f'rank{r}.pt').exists() else None
            for r in range(world)]


def _join(rank, world, init):
    from groma_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    pm.init_distributed('cpu', init_method=init, num_processes=world,
                        process_id=rank)


def _save(rank, out, out_dir):
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))


# ------------------------------------------------------------ serving

def _llama_ids(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (8, 16)).astype(np.int64),
            rng.integers(0, 128, (2, 6)).astype(np.int64))


def _jax_llama(c: dict, seed: int):
    """JAX's single-device LLaMA: (its HF-named weights, the logits of the
    forward ids, the greedy decode's tokens), as tests/test_sharding.py
    computes them."""
    cfg = JLlamaConfig(**c)
    model = JLlama(cfg)
    ids, dec_ids = _llama_ids(seed)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids[:1])
                        )['params']
    logits, _ = jax.jit(lambda p, x: model.apply({'params': p}, x))(
        params, jnp.asarray(ids))

    def generate(params, ids):
        cache = j_cache(cfg, ids.shape[0], 16)
        lg, cache = model.apply({'params': params}, ids, cache=cache)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)

        def step(carry, i):
            tok, cache = carry
            lg, cache = model.apply(
                {'params': params}, tok[:, None], cache=cache,
                position_ids=jnp.full_like(tok[:, None], 6) + i)
            nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
            return (nxt, cache), nxt
        (_, _), toks = jax.lax.scan(step, (tok, cache),
                                    jnp.arange(DECODE_STEPS))
        return jnp.concatenate([tok[None], toks], 0).T
    toks = np.asarray(jax.jit(generate)(params, jnp.asarray(dec_ids)))
    sd = export_llama(jax.tree_util.tree_map(np.asarray, params),
                      cfg.num_layers)
    return sd, np.asarray(logits), toks


def _engine_requests():
    # the same ids in every process (the stub tokenizer hashes strings)
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=CFG.num_image_tokens,
                      max_region_num=CFG.max_region_num,
                      max_seq_len=CFG.max_seq_len,
                      image_size=CFG.perceiver.image_size)
    rng = np.random.default_rng(3)
    reqs = []
    for query in ('a thing', 'the other thing on the left'):
        t = build_rec_prompt(query, tok, spec)
        img = rng.standard_normal(
            (CFG.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return tok.sp.eos, reqs


def _jax_engine_reference():
    """JAX's Groma weights and its single-device ``Generator``'s greedy
    tokens for each engine request."""
    eos, reqs = _engine_requests()
    model = JGroma(CFG)
    params = jax.jit(lambda: model.init(jax.random.PRNGKey(2),
                                        **_dummy_batch(CFG)))()['params']
    gen = JGenerator(model, params,
                     max_len=CFG.max_seq_len + ENGINE_MAX_NEW + 8)
    want = []
    for img, ids, rslot, valid in reqs:
        toks, _ = gen.generate(jnp.asarray(img)[None],
                               jnp.asarray(ids)[None],
                               jnp.asarray(rslot)[None],
                               jnp.asarray(valid)[None],
                               max_new_tokens=ENGINE_MAX_NEW, eos_id=eos)
        want.append([int(x) for x in toks[0]])
    return export_groma(jax.tree_util.tree_map(np.asarray, params), CFG), \
        want


def _port_llama(c: dict, sd):
    from groma_tpu_torch.config import LlamaConfig
    from groma_tpu_torch.models.llama import LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig(**c))
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       sd.items()})
    return m


def _llama_run(model, ids, dec_ids, rows, drows):
    """The forward's logits of ``ids[rows]`` and the greedy prefill plus
    DECODE_STEPS steps of ``dec_ids[drows]`` (as ``_jax_llama``)."""
    from groma_tpu_torch.models.llama import make_kv_cache
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids[rows]))
        x = torch.from_numpy(dec_ids[drows])
        cache = make_kv_cache(model.model.cfg, x.shape[0], 16,
                              kv_heads=model.model.kv_heads)
        lg, cache = model(x, cache=cache)
        tok = lg[:, -1].argmax(-1)
        toks = [tok]
        for i in range(DECODE_STEPS):
            lg, cache = model(tok[:, None], cache=cache,
                              position_ids=torch.full_like(tok[:, None],
                                                           6 + i))
            tok = lg[:, -1].argmax(-1)
            toks.append(tok)
    return logits.numpy(), torch.stack(toks, 1).numpy()


def _serve_ranks(rank, world, init, ref, out_dir):
    """One rank of the serving group: the LLaMA at (dp 2, tp 2), the GQA
    LLaMA at tp 4, then the engine on a Groma cut over tp 2 on two
    replicas."""
    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    from groma_tpu_torch.eval.generate_quant import QuantGenerator
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.serve.engine import BatchEngine
    _join(rank, world, init)
    out = {}
    ids, dec_ids = _llama_ids(0)

    grid = pm.make_mesh(dp=2, tp=2, device_type='cpu')
    drank, _ = pm.rank_and_world(grid.data_group)
    out['groups'] = (pm.rank_and_world(grid.data_group),
                     pm.rank_and_world(grid.tp_group),
                     tuple(grid.mesh.flatten().tolist()))
    model = _port_llama(LLAMA, ref['llama'][0])
    pm.shard_model(model, grid)
    out['llama_plan'] = dict(model.tp_plan)
    rows = slice(drank * 4, drank * 4 + 4)
    drows = slice(drank, drank + 1)
    out['llama'] = _llama_run(model, ids, dec_ids, rows, drows) + (
        (rows, drows),)

    model = _port_llama(GQA, ref['gqa'][0])
    pm.shard_model(model, pm.make_mesh(dp=1, tp=4, device_type='cpu'))
    out['gqa_plan'] = dict(model.tp_plan)
    out['gqa_kv_heads'] = model.model.kv_heads
    out['gqa'] = _llama_run(model, *_llama_ids(1), slice(0, 8), slice(0, 2))

    grid = pm.make_mesh(dp=2, tp=2, device_type='cpu')
    groma = from_state_dict(ref['groma'], t_tiny())
    pm.cut_tp(groma, grid.tp_group)
    eos, reqs = _engine_requests()
    try:
        BatchEngine(groma, {'layers': []}, kv_bits=8)
    except ValueError as e:
        out['quantized_refused'] = str(e)
    try:
        QuantGenerator(groma, {'layers': []}, kv_bits=8)
    except ValueError as e:
        out['quant_generator_refused'] = str(e)
    engine = BatchEngine(groma, None, max_slots=2,
                         max_len=CFG.max_seq_len + ENGINE_MAX_NEW + 8,
                         eos_id=eos, chunk=2, max_new_tokens=ENGINE_MAX_NEW)
    if torch.distributed.get_rank(grid.tp_group) == 0:
        first = engine.submit(*reqs[0])
        stream = first.token_stream()
        got = [next(stream)]
        # submitted while the first request decodes
        second = engine.submit(*reqs[1])
        got += list(stream)
        out['engine'] = [got, list(second.token_stream())]
        out['engine_stats'] = engine.stats()
    else:
        try:
            engine.submit(*reqs[0])
        except RuntimeError as e:
            out['follower_refused'] = str(e)
    engine.close()
    out['engine_alive'] = engine._thread.is_alive()
    out['engine_fatal'] = repr(engine._fatal)
    _save(rank, out, out_dir)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope='module')
def serving(tmp_path_factory):
    ref = {'llama': _jax_llama(LLAMA, 0), 'gqa': _jax_llama(GQA, 1)}
    ref['groma'], ref['engine'] = _jax_engine_reference()
    tmp = tmp_path_factory.mktemp('serve')
    return ref, _spawn(tmp, 4, _serve_ranks,
                       {k: ref[k] for k in ('llama', 'gqa', 'groma')})


def test_llama_forward_at_dp2_tp2_matches_jax(serving):
    ref, ranks = serving
    want = ref['llama'][1]
    for res in ranks:
        logits, _, (rows, _) = res['llama']
        np.testing.assert_allclose(logits, want[rows], atol=2e-4, rtol=1e-4)


def test_the_mesh_lays_tp_innermost(serving):
    """At (dp 2, tp 2): rank = data rank x 2 + tp rank, as JAX's
    ``reshape(dp, fsdp, tp)``."""
    _, ranks = serving
    assert [r['groups'] for r in ranks] == [
        ((r // 2, 2), (r % 2, 2), (0, 1, 2, 3)) for r in range(4)]


def test_llama_cuts_every_linear_and_both_vocab_tables(serving):
    _, ranks = serving
    plan = ranks[0]['llama_plan']
    assert plan['model.embed_tokens.weight'] == 0
    assert plan['lm_head.weight'] == 0
    assert sum(k.startswith('model.layers.') for k in plan) == 7 * 2
    assert all(plan[k] == 1 for k in plan
               if k.endswith(('o_proj.weight', 'down_proj.weight')))


def test_llama_greedy_decode_at_dp2_tp2_matches_jax(serving):
    ref, ranks = serving
    for res in ranks:
        _, toks, (_, drows) = res['llama']
        np.testing.assert_array_equal(toks, ref['llama'][2][drows])


def test_gqa_llama_at_tp4_keeps_kv_whole_and_matches_jax(serving):
    ref, ranks = serving
    for res in ranks:
        logits, toks = res['gqa']
        np.testing.assert_allclose(logits, ref['gqa'][1], atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(toks, ref['gqa'][2])
        assert res['gqa_kv_heads'] == 2
        assert not any('k_proj' in k or 'v_proj' in k
                       for k in res['gqa_plan'])
        assert sum('q_proj' in k for k in res['gqa_plan']) == 2


def test_engine_on_a_tp_cut_groma_serves_jaxs_tokens(serving):
    ref, ranks = serving
    leaders = [r for r in ranks if 'engine' in r]
    assert len(leaders) == 2            # rank 0 of each tp pair
    for res in leaders:
        assert res['engine'] == ref['engine']
        st = res['engine_stats']
        assert st['submitted'] == st['finished'] == 2
    assert all(len(t) >= 2 for t in ref['engine'])


def test_engine_refuses_the_quantized_modes_on_a_tp_cut_model(serving):
    _, ranks = serving
    for res in ranks:
        assert 'item 11c' in res['quantized_refused']


def test_quant_generator_refuses_a_tp_cut_model(serving):
    """The quantized forward has no tp all-reduce: on a tp-cut Groma it
    would give wrong logits silently, so ``QuantGenerator`` refuses it on
    every rank, as the engine does."""
    _, ranks = serving
    for res in ranks:
        assert 'item 11c' in res['quant_generator_refused']
        assert 'QuantGenerator' in res['quant_generator_refused']


def test_engine_followers_refuse_requests_and_stop_with_rank_0(serving):
    _, ranks = serving
    followers = [r for r in ranks if 'engine' not in r]
    assert len(followers) == 2
    for res in followers:
        assert 'rank 0 of the tp group' in res['follower_refused']
    assert not any(r['engine_alive'] for r in ranks)
    assert all(r['engine_fatal'] == 'None' for r in ranks)


# ------------------------------------------------------------ training

def _vl_batch(seed=0):
    """Two grounded rows of different lengths and ground-box counts (as
    tests/test_torch_parallel.py's)."""
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


def _half(tree, rank, world):
    if isinstance(tree, dict):
        return {k: _half(v, rank, world) for k, v in tree.items()}
    n = tree.shape[0] // world
    return tree[rank * n:(rank + 1) * n]


def _train_ranks(rank, world, init, vl_sd, out_dir):
    """One rank of the training group: the VL update at (fsdp 2, tp 2)
    with its checkpoint round trip, the controls without the copy-to-tp
    backward all-reduce and without the reduce-from-tp forward one, the
    update at (dp 2, tp 2), and at tp 4 with the gradients each rank's
    optimizer reads."""
    import torch.distributed as dist

    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.parallel import tensor_parallel
    from groma_tpu_torch.train import optimizer as topt
    from groma_tpu_torch.train.steps import batch_to, make_vl_train_step
    from groma_tpu_torch.train.train_vl import maybe_resume, save_checkpoint
    _join(rank, world, init)
    out = {}

    def vl_model(grid):
        m = from_state_dict(vl_sd, CFG, full_precision=True)
        pm.shard_model(m, grid)
        return m, topt.make_adamw(m, VL_LR, accum_steps=2,
                                  frozen_pred=topt.freeze_predicate(
                                      freeze_perceiver=True))

    def read_by_the_optimizer(opt, key):
        """Keep this rank's gradients as AdamW hands them to torch's step
        (after its tp mean) and the global norm its clip would read."""
        adam_step = opt.opt.step

        def read_then_step(*a, **kw):
            grads = [p.grad for p in opt.params]
            out[key + '_read'] = {n: g.detach().clone()
                                  for n, g in zip(opt.names, grads)}
            out[key + '_norm'] = float(torch.sqrt(topt._sum_of_squares(
                grads, opt.tp_cut, opt.tp_group)))
            return adam_step(*a, **kw)
        opt.opt.step = read_then_step

    def update(dp, key, tp=2):
        grid = pm.make_mesh(dp=dp, tp=tp, device_type='cpu')
        model, opt = vl_model(grid)
        if tp != 2:
            read_by_the_optimizer(opt, key)
        step = make_vl_train_step(model, opt, permute_regions=False)
        local = batch_to(_half(_vl_batch(),
                               *pm.rank_and_world(grid.data_group)), 'cpu')
        first = step(local)
        out[key + '_grads'] = pm.full_grads(model)
        second = step(local)
        assert (first['updated'], second['updated']) == (False, True)
        out[key + '_losses'] = [float(first['loss']), float(second['loss'])]
        out[key + '_params'] = pm.full_model_state(model)
        out[key + '_plan'] = dict(model.tp_plan)
        return grid, model, opt

    grid, model, opt = update(1, 'fsdp2')
    ck = os.path.join(out_dir, 'ckpt')
    save_checkpoint(ck, 1, model, opt, CFG, keep=1)
    dist.barrier()
    again, again_opt = vl_model(grid)
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
    out['resumed_on_ranks'] = True

    # the control: the column-parallel inputs' gradients left partial
    backward = tensor_parallel._CopyToTP.backward
    tensor_parallel._CopyToTP.backward = staticmethod(lambda ctx, g:
                                                      (g, None))
    model, opt = vl_model(grid)
    step = make_vl_train_step(model, opt, permute_regions=False)
    step(batch_to(_half(_vl_batch(), *pm.rank_and_world(grid.data_group)),
                  'cpu'))
    out['control_grads'] = pm.full_grads(model)
    tensor_parallel._CopyToTP.backward = backward

    # the forward control: the row-parallel partial sums (and the vocab
    # lookups) left unsummed
    forward = tensor_parallel._ReduceFromTP.forward
    tensor_parallel._ReduceFromTP.forward = staticmethod(lambda ctx, x, g:
                                                         x.clone())
    model, opt = vl_model(grid)
    step = make_vl_train_step(model, opt, permute_regions=False)
    out['forward_control_loss'] = float(step(batch_to(
        _half(_vl_batch(), *pm.rank_and_world(grid.data_group)),
        'cpu'))['loss'])
    tensor_parallel._ReduceFromTP.forward = forward

    update(2, 'dp2')
    update(1, 'tp4', tp=4)
    _save(rank, out if rank == 0 else
          {k: out[k] for k in ('tp4_read', 'tp4_norm')}, out_dir)
    dist.barrier()
    dist.destroy_process_group()


def _jax_vl_reference():
    """JAX's single-process VL update (two micro-batches under
    optax.MultiSteps) on the global batch: its losses, the gradient of the
    global loss, the parameters before and after (reference names)."""
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
    return {'losses': losses,
            'grads': export_groma(jax.tree_util.tree_map(np.asarray, grads),
                                  CFG),
            'params': export_groma(jax.tree_util.tree_map(
                np.asarray, state.params), CFG),
            'start': export_groma(params, CFG)}


@pytest.fixture(scope='module')
def training(tmp_path_factory):
    ref = _jax_vl_reference()
    tmp = tmp_path_factory.mktemp('train')
    ranks = _spawn(tmp, 4, _train_ranks, ref['start'])
    res = dict(ranks[0], tp4_ranks=ranks)
    return ref, res, tmp / 'ckpt'


def _np(t):
    return t.detach().float().numpy()


def _grad_misses(got, want) -> list:
    """The leaves whose gradient is not within 1e-4 of max|grad| of
    JAX's."""
    return [k for k, g in got.items()
            if not np.allclose(_np(g), want[k], rtol=0,
                               atol=1e-4 * max(np.abs(want[k]).max(), 1e-6))]


@pytest.mark.parametrize('mesh_name', ['fsdp2', 'dp2'])
def test_vl_gradient_at_tp2_matches_jax(training, mesh_name):
    ref, res, _ = training
    got = res[mesh_name + '_grads']
    assert got and not any(k.startswith('perceiver.') for k in got)
    assert res[mesh_name + '_plan'] and set(res[mesh_name + '_plan']) < \
        set(got)
    assert _grad_misses(got, ref['grads']) == []


@pytest.mark.parametrize('mesh_name', ['fsdp2', 'dp2'])
def test_vl_losses_at_tp2_match_jax(training, mesh_name):
    ref, res, _ = training
    np.testing.assert_allclose(res[mesh_name + '_losses'], ref['losses'],
                               rtol=1e-5)


@pytest.mark.parametrize('mesh_name', ['fsdp2', 'dp2'])
def test_vl_params_after_the_update_at_tp2_match_jax(training, mesh_name):
    ref, res, _ = training
    got = res[mesh_name + '_params']
    assert got.keys() == ref['params'].keys()
    for k, want in ref['params'].items():
        np.testing.assert_allclose(_np(got[k]), want, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_the_step_without_the_copy_to_tp_all_reduce_misses(training):
    """Without the copy-to-tp backward all-reduce, every leaf upstream of a
    column-parallel product (the norms, the embeddings, the bridge, the
    region encoder) takes a partial gradient."""
    ref, res, _ = training
    missed = _grad_misses(res['control_grads'], ref['grads'])
    assert any(k.startswith('img_txt_bridge.') for k in missed)
    assert any(k.endswith('input_layernorm.weight') for k in missed)
    assert any(k.startswith('region_encoder.') for k in missed)


def test_the_step_without_the_reduce_from_tp_all_reduce_misses_the_loss(
        training):
    """Without the reduce-from-tp forward all-reduce, every row-parallel
    product and vocab lookup gives this rank's partial sum: the loss is
    no longer within the losses' 1e-5 of JAX's."""
    ref, res, _ = training
    assert abs(res['forward_control_loss'] - ref['losses'][0]) \
        > 1e-5 * abs(ref['losses'][0])


def test_vl_update_at_tp4_keeps_the_new_token_rows_whole_and_matches_jax(
        training):
    """At tp 4 the 114 new-token rows do not divide: ``extra_lm_head`` and
    ``new_input_embs`` stay whole on every rank (JAX's fallback) while the
    base vocabulary is cut.  The gradient each rank's optimizer reads
    (after its mean over tp), leaf by leaf, its slice of a cut leaf,
    within 1e-4 of max|grad| of JAX's, and the global norm the clip reads
    within 1e-5 of JAX's; the losses and the parameters after the update
    as at tp 2."""
    ref, res, _ = training
    plan = res['tp4_plan']
    assert 'extra_lm_head.weight' not in plan
    assert 'new_input_embs.weight' not in plan
    assert plan['llm.lm_head.weight'] == 0
    assert plan['llm.model.embed_tokens.weight'] == 0
    read = [r['tp4_read'] for r in res['tp4_ranks']]
    assert 'extra_lm_head.weight' in read[0]
    norm = np.sqrt(sum(float((ref['grads'][k].astype(np.float64) ** 2)
                             .sum()) for k in read[0]))
    for r, got in enumerate(read):
        assert got.keys() == read[0].keys()
        for k, g in got.items():
            want = ref['grads'][k]
            if k in plan:
                n = g.shape[plan[k]]
                want = np.take(want, range(r * n, (r + 1) * n),
                               axis=plan[k])
            np.testing.assert_allclose(
                _np(g), want, rtol=0,
                atol=1e-4 * max(np.abs(ref['grads'][k]).max(), 1e-6),
                err_msg=f'rank {r}: {k}')
        np.testing.assert_allclose(res['tp4_ranks'][r]['tp4_norm'], norm,
                                   rtol=1e-5)
    np.testing.assert_allclose(res['tp4_losses'], ref['losses'], rtol=1e-5)
    for k, want in ref['params'].items():
        np.testing.assert_allclose(_np(res['tp4_params'][k]), want, rtol=0,
                                   atol=1e-4, err_msg=k)


def test_a_tp2_checkpoint_resumes_on_the_ranks_and_on_one_process(training):
    """Saved at (fsdp 2, tp 2) (whole tensors, rank 0's file), resumed on
    the four ranks (checked there, slice for slice) and by a single
    process into a fresh model and optimizer: the parameters and Adam's
    moments bitwise those the ranks held."""
    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.train import optimizer as topt
    from groma_tpu_torch.train.train_vl import maybe_resume
    ref, res, ck = training
    assert res['resumed_on_ranks']
    assert sorted(os.listdir(ck)) == ['checkpoint-1.pt']
    model = from_state_dict(ref['start'], CFG, full_precision=True)
    opt = topt.make_adamw(model, VL_LR, accum_steps=2,
                          frozen_pred=topt.freeze_predicate(
                              freeze_perceiver=True))
    assert maybe_resume(str(ck), model, opt) == 1
    got = model.state_dict()
    for k, v in res['fsdp2_params'].items():
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
            if k != 'step':
                assert v.shape == opt.params[i].shape


# ------------------------------------------------------------ train_det

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


def _train_det_ranks(rank, world, init, argv, out_dir):
    """One rank of ``train_det`` through its own entry point."""
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.train import train_det
    _join(rank, world, init)
    res = train_det.train(train_det.parse_args(argv), t_tiny().perceiver,
                          'cpu')
    model = res['model']
    _save(rank, {'losses': res['losses'],
                 'plan': getattr(model, 'tp_plan', None),
                 'data': pm.rank_and_world(model.data_group),
                 'tp': pm.rank_and_world(model.tp_group),
                 'params': pm.full_model_state(model)},
          out_dir)
    torch.distributed.destroy_process_group()


def test_train_det_at_tp2_on_four_ranks_is_the_one_process_run(tmp_path):
    """``train_det --tp 2`` on four gloo ranks: no detector parameter is
    cut (an empty plan), the two tp ranks of each data rank share its half
    of every global batch of 2, FSDP shards over the two data ranks, the
    ranks' parameters bitwise equal after the epoch; an
    epoch of 5 steps, both sources: the losses within 1e-5 relative of the
    one-process run and the exported weights within 1e-4."""
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
    got = _spawn(ranks, 4, _train_det_ranks,
                 argv(ranks / 'out') + ['--tp', '2'])
    one = train_det.train(train_det.parse_args(argv(tmp_path / 'one')),
                          t_tiny().perceiver, 'cpu')
    assert [g['plan'] for g in got] == [{}] * 4
    assert [g['data'] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    # the model carries its tp group, so the optimizer averages every
    # gradient over the tp replicas, which stay bitwise equal
    assert [g['tp'] for g in got] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    for res in got[1:]:
        assert res['params'].keys() == got[0]['params'].keys()
        for k, v in got[0]['params'].items():
            assert torch.equal(res['params'][k], v), k
    for res in got:
        assert len(res['losses']) == len(one['losses']) == 5
        for g, w in zip(res['losses'], one['losses']):
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


def test_a_single_process_refuses_a_tp_mesh():
    """In one process the mesh needs a group (the torchrun refusal at any
    size above 1), and without one the rank and world are (0, 1)."""
    assert mesh.make_mesh(dp=1, tp=1, device_type='cpu') is None
    with pytest.raises(ValueError, match='dp 1 x fsdp 1 x tp 2'):
        mesh.make_mesh(dp=1, tp=2, device_type='cpu')
    assert mesh.rank_and_world() == (0, 1)
