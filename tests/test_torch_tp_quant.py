"""The quantized tree under tensor parallelism (``mesh.cut_quant_tree``,
``models/llama_quant`` on a cut tree, ``QuantGenerator`` and the engine
on it) against the JAX package's single-device results, which GSPMD's
sharded program reproduces (``__graft_entry__._dryrun_quant_decode``).

Gloo ranks on the CPU, spawned once for the module (as
``test_torch_tensor_parallel.py`` spawns them), run every check below
and save what the tests read:

* JAX's dry run: an int8 tree, B = 2, a 16-token prefill into a float
  cache and one decode, at (dp 2, tp 2) and at tp 4 (also with
  grouped-query attention: 2 KV heads, whole on each rank at tp 4), and
  an int4 tree at
  (dp 2, tp 2) (hidden 512, intermediate 1280: five 256-row scale
  blocks, which tp 2 splits as 7B's 43 are split): the prefill's last
  logits and the decode's within atol 2e-4 / rtol 1e-4 of JAX's
  ``quant_llama_forward`` / ``quant_llama_logits``, the next tokens
  exactly;
* the int4 cut: ``down_proj``'s shares on block boundaries (2 and 3
  blocks), every cut leaf dequantizing to the whole tree's rows or
  columns, bitwise;
* two controls on the int8 dry run at tp 2 that must miss the logits
  tolerance: the row-parallel all-reduce left out, and ``qkv_proj`` cut
  contiguously (JAX's storage split, which crosses q | k | v);
* a row-parallel product on 2 ranks in bf16 (int8 and int4 leaves):
  the f32 partial sums, added and cast once, bitwise the all-reduced
  result;
* ``QuantGenerator`` on a Groma cut over tp 2 (``quantize_groma_llm``
  gathering the whole weights and cutting the tree): int8 + kv8, int8 +
  kv16, int4 + kv8, ``use_flash`` off on one replica and on on the other
  (the CPU takes the plain versions), and int8 + kv8 with
  ``spec_lookahead=4``: the greedy tokens and selected boxes of JAX's
  ``QuantGenerator`` on one device, exactly;
* ``BatchEngine`` on a Groma cut over tp 2: int4 + paged kv8 (the
  production configuration) on one replica, int8 + contiguous kv8 and
  then the same with the chunked prefill (32-token chunks, bursts
  between them) on the other, 2 slots, the second request submitted
  while the first decodes: JAX's engine's tokens, exactly, and every
  page returned;
* the refusals that remain, each naming its ROADMAP.md item: the W8A8
  prefill under tp (11f), the decode megakernel on a cut tree (11g), an
  int4 tree at a tp whose ``o_proj`` rows are not whole blocks (11h), and
  the engine's speculative mode under tp (11e).

Also, without a group: the int8 and int4 plans (#1's and #7's
``decode_plan`` / ``prefill_plan``, #7's ``prefill_stages``) at a tp = 2
rank's 7B shapes cover every weight row once with no empty split, and
the int4 stages each lie in one scale block of each plane.
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
import groma_tpu.ops.paged_attention as j_paged
from groma_tpu.checkpoint.hf_export import export_groma
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import LlamaConfig as JLlamaConfig
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate_quant import QuantGenerator as JQuantGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_qgroma
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama import make_kv_cache as j_cache
from groma_tpu.models.llama_quant import quant_llama_forward as j_forward
from groma_tpu.models.llama_quant import quant_llama_logits as j_logits
from groma_tpu.models.llama_quant import quantize_llama_params as j_quantize
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.ops import quant as t_quant
from groma_tpu_torch.ops import quant4 as t_quant4
from groma_tpu_torch.parallel.mesh import mlp_share

torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 1e-4             # logits, as PR 19's tp tests hold them
LLAMA8 = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=4, dtype='float32')
LLAMA4 = dict(vocab_size=256, hidden_size=512, intermediate_size=1280,
              num_layers=2, num_heads=8, num_kv_heads=8, dtype='float32')
GQA = dict(LLAMA8, num_kv_heads=2)  # k and v whole on each rank at tp 4
PRE, MAXLEN = 16, 32                # the dry run's prefill and cache
CFG8 = tiny_groma_config()
CFG4 = CFG8.replace(llm=CFG8.llm.replace(**{
    k: LLAMA4[k] for k in ('hidden_size', 'intermediate_size',
                           'num_heads', 'num_kv_heads')}))
GEN_MAX_NEW = 6
GEN_CASES = ((8, 8), (8, 16), (4, 8))     # (weight bits, kv bits)
SPEC = 4
ENGINE_MAX_NEW = 6
CHUNK = 32                          # the chunked engine's prefill chunk
JOIN_TIMEOUT = 420                  # seconds the spawned group may take


# ------------------------------------------------------------- the weights

def _hf_llama(c: dict, seed: int) -> dict:
    """Seeded HF-named LLaMA weights (numpy f32)."""
    rng = np.random.default_rng(seed)
    d, f, v = c['hidden_size'], c['intermediate_size'], c['vocab_size']
    kv = d // c['num_heads'] * c['num_kv_heads']

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)
    sd = {'model.embed_tokens.weight': w(v, d) * np.float32(0.02 * d ** .5),
          'model.norm.weight': np.ones(d, np.float32),
          'lm_head.weight': w(v, d)}
    for i in range(c['num_layers']):
        p = f'model.layers.{i}.'
        sd.update({
            p + 'input_layernorm.weight':
                (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            p + 'post_attention_layernorm.weight':
                (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            **{p + f'self_attn.{n}.weight': w(kv if n in ('k_proj', 'v_proj')
                                              else d, d)
               for n in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            p + 'mlp.gate_proj.weight': w(f, d),
            p + 'mlp.up_proj.weight': w(f, d),
            p + 'mlp.down_proj.weight': w(d, f)})
    return sd


def _jax_tree(sd: dict, c: dict) -> dict:
    """HF-named weights -> JAX's LLaMA param tree."""
    out = {'norm': {'scale': sd['model.norm.weight']}}
    for i in range(c['num_layers']):
        p = f'model.layers.{i}.'
        out[f'layers_{i}'] = {
            'input_layernorm': {'scale': sd[p + 'input_layernorm.weight']},
            'post_attention_layernorm': {
                'scale': sd[p + 'post_attention_layernorm.weight']},
            'self_attn': {n: {'kernel': sd[p + f'self_attn.{n}.weight'].T}
                          for n in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            **{n: {'kernel': sd[p + f'mlp.{n}.weight'].T}
               for n in ('gate_proj', 'up_proj', 'down_proj')}}
    return {'model': out, 'embed_tokens': sd['model.embed_tokens.weight'],
            'lm_head': {'kernel': sd['lm_head.weight'].T}}


def _dry_ids(c: dict) -> np.ndarray:
    return np.random.default_rng(3).integers(
        0, c['vocab_size'], (2, PRE)).astype(np.int64)


def _jax_dry_run(c: dict, bits: int, seed: int) -> dict:
    """JAX's dry-run program on one device: the prefill's last logits, the
    next tokens, the decode's logits and tokens."""
    cfg = JLlamaConfig(**c)
    sd = _hf_llama(c, seed)
    qp = j_quantize(_jax_tree(sd, c), cfg, bits=bits)
    ids = jnp.asarray(_dry_ids(c), jnp.int32)
    b = ids.shape[0]

    @jax.jit
    def run(qp, ids):
        cache = j_cache(cfg, b, MAXLEN)
        pos = jnp.broadcast_to(jnp.arange(PRE)[None], (b, PRE))
        h, cache = j_forward(qp, cfg, qp['embed_tokens'][ids],
                             jnp.ones((b, PRE), bool), pos, cache)
        first = j_logits(qp, h[:, -1:])[:, 0]
        tok = jnp.argmax(first, -1)
        h, _ = j_forward(qp, cfg, qp['embed_tokens'][tok[:, None]],
                         jnp.ones((b, 1), bool),
                         jnp.full((b, 1), PRE, jnp.int32), cache)
        second = j_logits(qp, h)[:, -1]
        return first, tok, second, jnp.argmax(second, -1)
    out = [np.asarray(t) for t in run(qp, ids)]
    return {'sd': sd, 'first': out[0], 'tok': out[1], 'second': out[2],
            'tok2': out[3]}


def _requests(cfg, n: int, seed: int):
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        t = build_rec_prompt(f'the thing {i} on the left', tok, spec)
        img = rng.standard_normal(
            (cfg.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return tok.sp.eos, reqs


def _jax_groma(cfg, seed: int):
    model = JGroma(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: model.init(jax.random.PRNGKey(seed),
                           **_dummy_batch(cfg)))()['params'])
    return model, params


def _jax_serving() -> dict:
    """JAX's QuantGenerator tokens and boxes for each (bits, kv bits) case
    and the speculative one, and JAX's engine tokens (int4 + paged kv8 on
    CFG4, int8 + contiguous kv8 on CFG8, one-shot and chunked); the decode
    attention kernels in the Pallas interpreter (the port's plain
    versions' order)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_decode_attention, 'int8_decode_attention',
                   lambda *a: j_decode_attention._call_kernel(
                       *a, interpret=True))
        mp.setattr(j_paged, 'paged_int8_decode_attention',
                   lambda q, kp, ks, vp, vs, t, ln: j_paged._call_kernel(
                       t, ln, q, kp, ks, vp, vs, interpret=True))
        for name, cfg in (('8', CFG8), ('4', CFG4)):
            jmodel, params = _jax_groma(cfg, seed=int(name))
            out[f'groma{name}'] = export_groma(params, cfg)
            eos, reqs = _requests(cfg, 2, seed=int(name))
            img, ids, rslot, valid = reqs[0]
            args = [jnp.asarray(a)[None] for a in (img, ids, rslot, valid)]
            for bits, kv in GEN_CASES + ((8, 'spec'),):
                if str(bits) != name:
                    continue
                gen = JQuantGenerator(
                    jmodel, params, j_qgroma(params, cfg, bits=bits),
                    max_len=cfg.max_seq_len + 64,
                    kv_bits=8 if kv == 'spec' else kv,
                    spec_lookahead=SPEC if kv == 'spec' else 0)
                toks, vis = gen.generate(*args, max_new_tokens=GEN_MAX_NEW,
                                         eos_id=eos)
                out[('gen', bits, kv)] = (np.asarray(toks),
                                          np.asarray(vis['selected_boxes']),
                                          np.asarray(vis['selected_mask']))
            modes = ('paged',) if name == '4' else ('contiguous', 'chunked')
            for mode in modes:
                engine = JEngine(jmodel, params, qp=j_qgroma(
                    params, cfg, bits=int(name)), max_slots=2,
                    max_len=cfg.max_seq_len + ENGINE_MAX_NEW + 8,
                    eos_id=eos, chunk=2, max_new_tokens=ENGINE_MAX_NEW,
                    kv_bits=8, paged_kv=mode == 'paged',
                    prefill_chunk_tokens=CHUNK if mode == 'chunked'
                    else None)
                try:
                    sessions = [engine.submit(*r) for r in reqs]
                    out[('engine', mode)] = [list(s.token_stream())
                                             for s in sessions]
                finally:
                    engine.close()
    return out


# ------------------------------------------------------------ spawning

def _spawn(tmp_path, world, target, *args):
    """Run ``target`` on ``world`` spawned processes, each within
    JOIN_TIMEOUT seconds and with exit code 0 -> each rank's result."""
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
            for r in range(world)]


def _port_dry_run(qp, cfg, ids) -> dict:
    """The dry-run program on the port's (cut) tree for the rows ``ids``."""
    from groma_tpu_torch.models.llama import make_kv_cache
    from groma_tpu_torch.models.llama_quant import (local_heads,
                                                    quant_llama_forward,
                                                    quant_llama_logits)
    ids = torch.from_numpy(ids)
    b = ids.shape[0]
    with torch.no_grad():
        cache = make_kv_cache(cfg, b, MAXLEN,
                              kv_heads=local_heads(qp, cfg)[1])
        pos = torch.arange(PRE)[None].expand(b, PRE)
        h, cache = quant_llama_forward(qp, cfg, qp['embed_tokens'][ids],
                                       torch.ones((b, PRE), dtype=bool), pos,
                                       cache)
        first = quant_llama_logits(qp, h[:, -1:])[:, 0]
        tok = first.argmax(-1)
        h, _ = quant_llama_forward(qp, cfg, qp['embed_tokens'][tok[:, None]],
                                   torch.ones((b, 1), dtype=bool),
                                   torch.full((b, 1), PRE), cache)
        second = quant_llama_logits(qp, h)[:, -1]
    return {'first': first.numpy(), 'tok': tok.numpy(),
            'second': second.numpy(), 'tok2': second.argmax(-1).numpy()}


def _whole_tree(sd, c, bits):
    from groma_tpu_torch.config import LlamaConfig
    from groma_tpu_torch.models.llama_quant import quantize_llama_params
    cfg = LlamaConfig(**c)
    return cfg, quantize_llama_params(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, bits=bits)


def _int4_cut_checks(whole, cut, cfg) -> dict:
    """Each cut int4 leaf against the whole tree's rows / columns
    (dequantized, bitwise) and the MLP share's blocks."""
    from groma_tpu_torch.ops.quant4 import (INT4_BLOCK,
                                            dequantize_weight_int4)
    tp = cut['tp']
    m0, m1 = tp['mlp']
    hd = cfg.hidden_size // cfg.num_heads
    q0, q1 = tp['q_first'] * hd, (tp['q_first'] + tp['heads']) * hd
    inter, nh = cfg.intermediate_size, cfg.num_heads

    def deq(leaf):
        return dequantize_weight_int4({**leaf, 'block': INT4_BLOCK})
    ok = []
    for lw, lc in zip(whole['layers'], cut['layers']):
        ok.append(torch.equal(deq(lc['down_proj']),
                              deq(lw['down_proj'])[m0:m1]))
        ok.append(torch.equal(deq(lc['o_proj']), deq(lw['o_proj'])[q0:q1]))
        gu = deq(lw['gate_up_proj'])
        ok.append(torch.equal(deq(lc['gate_up_proj']), torch.cat(
            [gu[:, m0:m1], gu[:, inter + m0:inter + m1]], 1)))
        qkv = deq(lw['qkv_proj'])
        ok.append(torch.equal(deq(lc['qkv_proj']), torch.cat(
            [qkv[:, q0:q1], qkv[:, nh * hd + q0:nh * hd + q1],
             qkv[:, 2 * nh * hd + q0:2 * nh * hd + q1]], 1)))
        ok.append(all(lc[k]['q'].dtype == torch.uint8
                      for k in ('qkv_proj', 'o_proj', 'gate_up_proj',
                                'down_proj')))
    return {'blocks': ((m1 - m0) // INT4_BLOCK, m0 % INT4_BLOCK,
                       m1 % INT4_BLOCK), 'equal': all(ok)}


def _controls(sd, c, group, rows) -> dict:
    """The int8 dry run at tp 2 with the row-parallel all-reduce left
    out, and with qkv_proj cut contiguously."""
    import groma_tpu_torch.models.llama_quant as lq
    from groma_tpu_torch.parallel import mesh as pm
    cfg, whole = _whole_tree(sd, c, 8)
    real = lq.row_parallel_quant
    lq.row_parallel_quant = lambda x, qw, g, product: product(
        x, qw, out_dtype=torch.float32).to(x.dtype)
    try:
        no_reduce = _port_dry_run(pm.cut_quant_tree(whole, cfg, group), cfg,
                                  rows)
    finally:
        lq.row_parallel_quant = real
    cut = pm.cut_quant_tree(whole, cfg, group)
    r, tp = cut['tp']['rank'], cut['tp']['size']
    for lw, lc in zip(whole['layers'], cut['layers']):
        n = lw['qkv_proj']['q'].shape[1] // tp
        lc['qkv_proj'] = {k: v[..., r * n:(r + 1) * n].contiguous()
                          for k, v in lw['qkv_proj'].items()}
    return {'no_reduce': no_reduce, 'contiguous_qkv': _port_dry_run(
        cut, cfg, rows)}


def _row_parallel_bitwise(group, rank) -> dict:
    """A row-parallel product in bf16 on 2 ranks, int8 and int4 leaves:
    this rank's f32 partial and the all-reduced result."""
    from groma_tpu_torch.models.llama_quant import _qmm, quantize_kernel
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.parallel.tensor_parallel import row_parallel_quant
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(5, 1024, generator=gen).to(torch.bfloat16)
    w = torch.randn(1024, 192, generator=gen) / 32
    out = {}
    for bits in (8, 4):
        leaf = quantize_kernel(w, bits)
        k0, k1 = pm.mlp_share(1024, 2, rank, bits == 4)
        mine = pm._quant_rows(leaf, k0, k1)
        xr = x[:, k0:k1].contiguous()
        out[bits] = (_qmm(xr, mine, out_dtype=torch.float32),
                     row_parallel_quant(xr, mine, group, _qmm))
    return out


def _generator_cases(groma_sd, cfg, bits_cases, flash, group, eos, req):
    """QuantGenerator on a Groma cut over ``group``: per case the tokens,
    boxes and mask."""
    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                     quantize_groma_llm)
    from groma_tpu_torch.parallel import mesh as pm
    tcfg = _port_cfg(cfg)
    model = from_state_dict(groma_sd, tcfg)
    pm.cut_tp(model, group)
    out = {}
    args = [a[None] for a in req]
    for bits, kv in bits_cases:
        qp = quantize_groma_llm(model, tcfg, bits=bits)
        gen = QuantGenerator(model, qp, max_len=cfg.max_seq_len + 64,
                             kv_bits=8 if kv == 'spec' else kv,
                             use_flash=flash,
                             spec_lookahead=SPEC if kv == 'spec' else 0)
        toks, vis = gen.generate(*args, max_new_tokens=GEN_MAX_NEW,
                                 eos_id=eos)
        out[(bits, kv)] = (toks, vis['selected_boxes'],
                           vis['selected_mask'],
                           gen.last_stats['decode_mode'],
                           gen.last_stats['prefill_mode'])
    return model, out


def _port_cfg(cfg):
    from groma_tpu_torch.config import tiny_groma_config as t_tiny
    c = t_tiny()
    return c.replace(llm=c.llm.replace(
        hidden_size=cfg.llm.hidden_size,
        intermediate_size=cfg.llm.intermediate_size,
        num_heads=cfg.llm.num_heads, num_kv_heads=cfg.llm.num_kv_heads))


def _engine_case(groma_sd, cfg, bits, mode, group, eos, reqs) -> dict:
    """The engine in ``mode`` ('paged', 'contiguous' or 'chunked') on a
    Groma whose model and tree are cut over ``group`` (the tree cut from
    the whole one): the leader's tokens and stats."""
    from groma_tpu_torch.checkpoint.loader import from_state_dict
    from groma_tpu_torch.eval.generate_quant import quantize_groma_llm
    from groma_tpu_torch.parallel import mesh as pm
    from groma_tpu_torch.serve.engine import BatchEngine
    tcfg = _port_cfg(cfg)
    model = from_state_dict(groma_sd, tcfg)
    whole = quantize_groma_llm(model, tcfg, bits=bits)
    pm.cut_tp(model, group)
    qp = pm.cut_quant_tree(whole, tcfg.llm, group)
    del whole
    engine = BatchEngine(model, qp, max_slots=2,
                         max_len=cfg.max_seq_len + ENGINE_MAX_NEW + 8,
                         eos_id=eos, chunk=2, max_new_tokens=ENGINE_MAX_NEW,
                         kv_bits=8, paged_kv=mode == 'paged',
                         prefill_chunk_tokens=CHUNK if mode == 'chunked'
                         else None)
    out = {'pools_heads': (engine._pools['k'][0].shape[1] if mode == 'paged'
                           else engine._cache['k'][0].shape[1])}
    wants, between = [], engine._burst_between

    def counted(want):
        wants.append(want)
        return between(want)
    engine._burst_between = counted
    if torch.distributed.get_rank(group) == 0:
        first = engine.submit(*reqs[0])
        stream = first.token_stream()
        got = [next(stream)]
        second = engine.submit(*reqs[1])     # while the first decodes
        got += list(stream)
        out['tokens'] = [got, list(second.token_stream())]
        out['stats'] = engine.stats()
    engine.close()
    out['fatal'] = repr(engine._fatal)
    out['bursts_between'] = sum(wants)     # rank 0's: the others follow
    return out


def _refusals(ref, group4) -> dict:
    """What a cut tree refuses below the serving layer, each error's
    text."""
    from groma_tpu_torch.models.llama_quant import (
        quant_llama_decode_megakernel, quant_llama_forward)
    from groma_tpu_torch.ops.decode_megakernel import stack_decode_params
    from groma_tpu_torch.parallel import mesh as pm
    out = {}
    cfg4, whole4 = _whole_tree(ref['dry4']['sd'], LLAMA4, 4)
    try:
        pm.cut_quant_tree(whole4, cfg4, group4)
    except ValueError as e:
        out['o_proj_blocks'] = str(e)
    cfg, whole = _whole_tree(ref['dry8']['sd'], LLAMA8, 8)
    cut = pm.cut_quant_tree(whole, cfg, group4)
    for name, call in (
            ('megakernel', lambda: quant_llama_decode_megakernel(
                cut, {}, cfg, torch.zeros(1, 1, 64), None, {})),
            ('stack', lambda: stack_decode_params(cut)),
            ('w8a8', lambda: quant_llama_forward(
                cut, cfg, torch.zeros(1, 300, 64),
                torch.ones(1, 300, dtype=bool),
                torch.arange(300)[None], w8a8=True))):
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
    return out


def _serving_refusals(model, cfg) -> dict:
    """What QuantGenerator and the engine refuse on a tp-cut Groma."""
    from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                     quantize_groma_llm)
    from groma_tpu_torch.serve.engine import BatchEngine
    qp = quantize_groma_llm(model, _port_cfg(cfg))
    out = {}
    for name, make in (
            ('gen_w8a8', lambda: QuantGenerator(model, qp, kv_bits=8,
                                                w8a8_prefill=True)),
            ('engine_w8a8', lambda: BatchEngine(model, qp, kv_bits=8,
                                                w8a8_prefill=True)),
            ('engine_spec', lambda: BatchEngine(model, qp, kv_bits=8,
                                                spec_lookahead=SPEC))):
        try:
            make()
        except ValueError as e:
            out[name] = str(e)
    return out


def _ranks(rank, world, init, ref, out_dir):
    from groma_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    pm.init_distributed('cpu', init_method=init, num_processes=world,
                        process_id=rank)
    out = {}
    grid = pm.make_mesh(dp=2, tp=2, device_type='cpu')
    drank, _ = pm.rank_and_world(grid.data_group)
    tp2 = grid.tp_group
    rows = _dry_ids(LLAMA8)[drank:drank + 1]
    cfg8, whole8 = _whole_tree(ref['dry8']['sd'], LLAMA8, 8)
    out['dry8_tp2'] = _port_dry_run(pm.cut_quant_tree(whole8, cfg8, tp2),
                                    cfg8, rows)
    out['controls'] = _controls(ref['dry8']['sd'], LLAMA8, tp2, rows)
    cfg4, whole4 = _whole_tree(ref['dry4']['sd'], LLAMA4, 4)
    cut4 = pm.cut_quant_tree(whole4, cfg4, tp2)
    out['int4_cut'] = _int4_cut_checks(whole4, cut4, cfg4)
    out['dry4_tp2'] = _port_dry_run(cut4, cfg4,
                                    _dry_ids(LLAMA4)[drank:drank + 1])
    del whole4, cut4
    out['row_parallel'] = _row_parallel_bitwise(tp2, pm.rank_and_world(
        tp2)[0])

    # QuantGenerator: flash off on data rank 0, on on data rank 1
    flash = drank == 1
    out['gen'] = {}
    for name, cfg in (('8', CFG8), ('4', CFG4)):
        eos, reqs = _requests(cfg, 2, seed=int(name))
        cases = [c for c in GEN_CASES + ((8, 'spec'),)
                 if str(c[0]) == name and (c[1] != 'spec' or not flash)]
        model, got = _generator_cases(ref[f'groma{name}'], cfg, cases,
                                      flash, tp2, eos, reqs[0])
        out['gen'].update(got)
        if name == '8':
            out['refused'] = _serving_refusals(model, cfg)
        del model

    # the engine: int4 + paged kv8 on data rank 0, int8 + kv8 on 1, one
    # shot and chunked
    name, cfg = ('4', CFG4) if drank == 0 else ('8', CFG8)
    eos, reqs = _requests(cfg, 2, seed=int(name))
    out['engine'] = {mode: _engine_case(ref[f'groma{name}'], cfg, int(name),
                                        mode, tp2, eos, reqs)
                     for mode in (('paged',) if drank == 0
                                  else ('contiguous', 'chunked'))}

    grid4 = pm.make_mesh(dp=1, tp=4, device_type='cpu')
    out['dry8_tp4'] = _port_dry_run(
        pm.cut_quant_tree(whole8, cfg8, grid4.tp_group), cfg8,
        _dry_ids(LLAMA8))
    cfgg, wholeg = _whole_tree(ref['gqa']['sd'], GQA, 8)
    for name, group in (('gqa_tp4', grid4.tp_group), ('gqa_tp2', tp2)):
        cut = pm.cut_quant_tree(wholeg, cfgg, group)
        out[name] = _port_dry_run(cut, cfgg, _dry_ids(GQA))
        out[name]['tp'] = {k: v for k, v in cut['tp'].items()
                           if k != 'group'}
    out['refused'].update(_refusals(ref, grid4.tp_group))
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope='module')
def group(tmp_path_factory):
    ref = {'dry8': _jax_dry_run(LLAMA8, 8, 0),
           'dry4': _jax_dry_run(LLAMA4, 4, 1),
           'gqa': _jax_dry_run(GQA, 8, 2)}
    ref.update(_jax_serving())
    sent = {k: v for k, v in ref.items() if not isinstance(k, tuple)}
    for k in ('dry8', 'dry4', 'gqa'):
        sent[k] = {'sd': ref[k]['sd']}
    return ref, _spawn(tmp_path_factory.mktemp('tp_quant'), 4, _ranks, sent)


def _close(got, want):
    np.testing.assert_allclose(got['first'], want['first'], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got['second'], want['second'], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(got['tok'], want['tok'])
    np.testing.assert_array_equal(got['tok2'], want['tok2'])


def _rows(want, r):
    return {k: want[k][r:r + 1] for k in ('first', 'tok', 'second', 'tok2')}


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize('case', ['dry8_tp2', 'dry4_tp2'])
def test_the_dry_run_at_dp2_tp2_gives_jaxs_logits_and_tokens(group, case):
    ref, ranks = group
    want = ref['dry8' if case == 'dry8_tp2' else 'dry4']
    for r, res in enumerate(ranks):
        _close(res[case], _rows(want, r // 2))


def test_the_int8_dry_run_at_tp4_gives_jaxs_logits_and_tokens(group):
    ref, ranks = group
    for res in ranks:
        _close(res['dry8_tp4'], ref['dry8'])


@pytest.mark.parametrize('case,kv_heads', [('gqa_tp4', 2), ('gqa_tp2', 1)])
def test_gqa_keeps_kv_whole_where_tp_does_not_divide_it(group, case,
                                                        kv_heads):
    """Grouped-query attention (4 query over 2 KV heads): at tp 4 each
    rank takes one query head beside both KV heads, whole; at tp 2 one KV
    head a rank.  JAX's dry-run logits and tokens either way."""
    ref, ranks = group
    for res in ranks:
        _close(res[case], ref['gqa'])
        assert (res[case]['tp']['heads'], res[case]['tp']['kv_heads']) == \
            (4 // (4 if case == 'gqa_tp4' else 2), kv_heads)


def test_the_int4_cut_takes_whole_scale_blocks_without_requantizing(group):
    """tp 2 over five 256-row blocks: 2 and 3 blocks, on boundaries; each
    cut leaf dequantizes to the whole tree's rows or columns, bitwise."""
    _, ranks = group
    assert [res['int4_cut']['blocks'] for res in ranks] == \
        [(2, 0, 0), (3, 0, 0)] * 2
    assert all(res['int4_cut']['equal'] for res in ranks)


@pytest.mark.parametrize('control', ['no_reduce', 'contiguous_qkv'])
def test_the_controls_miss(group, control):
    """The row-parallel all-reduce left out, or qkv_proj cut where JAX's
    storage puts tp (contiguously, across q | k | v): the logits miss."""
    ref, ranks = group
    for r, res in enumerate(ranks):
        got = res['controls'][control]['first']
        want = _rows(ref['dry8'], r // 2)['first']
        assert not np.allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('bits', [8, 4])
def test_a_row_parallel_product_is_its_f32_partials_summed_once(group, bits):
    _, ranks = group
    for pair in (ranks[:2], ranks[2:]):
        (p0, y0), (p1, y1) = (res['row_parallel'][bits] for res in pair)
        assert p0.dtype == torch.float32 and y0.dtype == torch.bfloat16
        assert torch.equal(y0, (p0 + p1).to(torch.bfloat16))
        assert torch.equal(y0, y1)


@pytest.mark.parametrize('case', list(GEN_CASES) + [(8, 'spec')])
def test_quant_generator_on_a_tp_cut_groma_serves_jaxs_tokens(group, case):
    ref, ranks = group
    toks, boxes, mask = ref[('gen', *case)]
    assert toks.shape[1] >= 2
    seen = 0
    for res in ranks:
        if case not in res['gen']:          # speculation: flash off only
            continue
        got, gboxes, gmask, decode_mode, prefill_mode = res['gen'][case]
        np.testing.assert_array_equal(got, toks)
        np.testing.assert_array_equal(gmask, mask)
        np.testing.assert_allclose(gboxes, boxes, atol=1e-5)
        # a gloo group's collectives run on the host: nothing captured
        assert (decode_mode, prefill_mode) == ('eager: gloo tp group',
                                               'eager')
        seen += 1
    assert seen == (2 if case[1] == 'spec' else 4)


@pytest.mark.parametrize('bits,mode', [(4, 'paged'), (8, 'contiguous'),
                                       (8, 'chunked')])
def test_engine_on_a_tp_cut_tree_serves_jaxs_tokens(group, bits, mode):
    """int4 + paged kv8 (the production configuration) on one replica of
    two tp ranks, int8 + contiguous kv8, one-shot and chunked, on the
    other: JAX's engine's tokens, every page back in the pool, the caches
    on 2 of 4 KV heads (int4's 4 of 8)."""
    ref, ranks = group
    pair = ranks[:2] if mode == 'paged' else ranks[2:]
    leader = pair[0]['engine'][mode]
    assert leader['tokens'] == ref[('engine', mode)]
    assert all(len(t) >= 2 for t in leader['tokens'])
    st = leader['stats']
    assert st['submitted'] == st['finished'] == 2
    if mode == 'paged':
        assert st['free_pages'] == st['total_pages']
        assert st['truncated'] == 0
    heads = (CFG4 if bits == 4 else CFG8).llm.num_heads // 2
    assert [res['engine'][mode]['pools_heads'] for res in pair] == \
        [heads] * 2
    assert all(res['engine'][mode]['fatal'] == 'None' for res in pair)
    # the chunked prefill of the second request ran bursts between chunks
    assert (leader['bursts_between'] > 0) == (mode == 'chunked')


@pytest.mark.parametrize('name,item', [
    ('o_proj_blocks', '11h'), ('megakernel', '11g'), ('stack', '11g'),
    ('w8a8', '11f'), ('gen_w8a8', '11f'), ('engine_w8a8', '11f'),
    ('engine_spec', '11e')])
def test_what_a_cut_tree_still_refuses_names_its_roadmap_item(group, name,
                                                                item):
    _, ranks = group
    for res in ranks:
        text = res['refused'].get(name)
        assert text and f'item {item}' in text, (name, text)


# ---------------------------------------------- the plans at a rank's shapes

# (K, N) of a tp = 2 rank's matmuls at 7B width: the int8 tree's even cut
# and the int4 tree's block-aligned MLP shares (21 and 22 of 43 blocks)
TP2_INT8 = {'qkv_proj': (4096, 6144), 'o_proj': (2048, 4096),
            'gate_up_proj': (4096, 11008), 'down_proj': (5504, 4096),
            'lm_head': (4096, 16128)}
TP2_INT4 = {'qkv_proj': (4096, 6144), 'o_proj': (2048, 4096),
            'gate_up_proj r0': (4096, 2 * 5376),
            'gate_up_proj r1': (4096, 2 * 5632),
            'down_proj r0': (5376, 4096), 'down_proj r1': (5632, 4096),
            'lm_head': (4096, 16128)}


def test_the_int4_mlp_shares_at_7b_are_21_and_22_blocks():
    assert [mlp_share(11008, 2, r, True) for r in (0, 1)] == \
        [(0, 5376), (5376, 11008)]
    assert [mlp_share(11008, 2, r, False) for r in (0, 1)] == \
        [(0, 5504), (5504, 11008)]


def _covered_once(split_rows, splits, rows):
    seen = np.zeros(rows, dtype=int)
    for s in range(splits):
        lo, hi = s * split_rows, min((s + 1) * split_rows, rows)
        assert lo < hi                              # no split empty
        seen[lo:hi] += 1
    return (seen == 1).all()


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('shape', list(TP2_INT8))
def test_int8_plans_cover_a_tp2_ranks_shapes(shape, sms):
    k, n = TP2_INT8[shape]
    for m in (1, 8, 40, 192):
        split_rows, splits = t_quant.decode_plan(m, k, n, sms)
        assert split_rows % t_quant.DECODE_TILE[0] == 0
        assert _covered_once(split_rows, splits, k)
    ctas, tt, ct = t_quant.prefill_plan(2048, n, sms)
    seen = np.zeros((tt, ct), dtype=int)
    for tiles in t_quant.prefill_tiles(2048, n, sms):
        assert tiles
        for t, c in tiles:
            seen[t, c] += 1
    assert (seen == 1).all() and ctas == min(sms, tt * ct)


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('shape', list(TP2_INT4))
def test_int4_plans_cover_a_tp2_ranks_shapes_inside_scale_blocks(shape, sms):
    k, n = TP2_INT4[shape]
    kh, block = k // 2, t_quant4.INT4_BLOCK
    assert k % block == 0 and n % 64 == 0
    split_rows, splits = t_quant4.decode_plan(k, n, sms)
    rows = t_quant4.DECODE_TILE[0]
    assert split_rows % rows == 0
    assert _covered_once(split_rows, splits, kh)
    for r in range(0, kh, rows):                # a tile in one block a plane
        assert r // block == (r + rows - 1) // block
        assert (kh + r) // block == (kh + r + rows - 1) // block
    seen = np.zeros(k, dtype=int)
    for k0, packed, half, blk, _ in t_quant4.prefill_stages(k):
        end = k0 + t_quant4.PREFILL_STAGE_ROWS
        seen[k0:end] += 1
        assert k0 // block == (end - 1) // block == blk
        assert packed == k0 - half * kh and (half == 1) == (k0 >= kh)
    assert (seen == 1).all()
    ctas, tt, ct = t_quant4.prefill_plan(2048, n, sms)
    assert sum(map(len, t_quant4.prefill_tiles(2048, n, sms))) == tt * ct
