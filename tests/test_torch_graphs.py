"""The decode loops as step functions (``utils.graphs.StepGraph``): the body
that the card captures as a CUDA graph and replays, here run eagerly on
the CPU, against the JAX package on the same weights and inputs.

* Greedy tokens exactly: the ``Generator``'s scan (kv16) against JAX's
  ``decode_scan``; ``QuantGenerator`` int8/kv8 and int4/kv8 against JAX's
  ``QuantGenerator``; ``BatchEngine`` contiguous (int8/kv8 and
  ``qp=None``) and paged (int4/kv8) against JAX's ``BatchEngine``.  Each
  also shows that its decode went through ``StepGraph.run``.
* The megakernel loop, the cache index a device word advanced in place by
  the step, through ``fused_decode_step_plain``, against JAX's megakernel
  in the Pallas interpreter: ``HIDDEN_TOL`` x max|hidden|, the tolerance of
  ``test_torch_megakernel.py`` (the same algebra in f32, sums in another
  order).
* The decode at a 0-d device index bitwise equal to the decode at a host
  index, at B = 1 and 2, for the bf16-path LLaMA and the quantized one.
* A guard: inside every loop's step, a host read (``Tensor.item``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``.cpu``,
  ``.numpy``, ``.tolist``) or host data put on a device
  (``torch.tensor`` / ``torch.as_tensor`` of non-tensor data with a
  ``device``) raises: a captured step may do neither.
* ``true_div`` bitwise the IEEE division it was.

The int4 trees need K in whole 256-row blocks: hidden 256, intermediate
768, 2 heads of 128 (``CFG4``, as ``test_torch_engine.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import groma_tpu.ops.decode_attention as j_decode_attention
import groma_tpu.ops.decode_megakernel as j_mk
import groma_tpu.ops.paged_attention as j_paged
from groma_tpu.checkpoint.hf_export import export_llama
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import LlamaConfig, tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate import Generator as JGenerator
from groma_tpu.eval.generate_quant import QuantGenerator as JQuantGenerator
from groma_tpu.eval.generate_quant import quantize_groma_llm as j_quantize
from groma_tpu.eval.rec import build_rec_prompt
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu.models.llama_quant import (
    make_quant_kv_cache as j_qcache,
    quant_llama_decode_megakernel as j_decode_megakernel,
    quant_llama_forward as j_forward,
    quantize_llama_params as j_quantize_llama)
from groma_tpu.serve.engine import BatchEngine as JEngine
from groma_tpu_torch.checkpoint.loader import (from_jax_params, random_groma,
                                               random_groma_unquantized)
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval.generate import Generator
from groma_tpu_torch.eval.generate_quant import (QuantGenerator,
                                                 quantize_groma_llm)
from groma_tpu_torch.models.llama import LlamaModel, make_kv_cache
from groma_tpu_torch.models.llama_quant import (
    make_quant_kv_cache, quant_llama_decode_megakernel, quant_llama_forward,
    quantize_llama_params)
from groma_tpu_torch.ops import decode_megakernel as mk
from groma_tpu_torch.ops.quant import true_div
from groma_tpu_torch.serve.engine import BatchEngine
from groma_tpu_torch.utils.graphs import StepGraph

torch.set_num_threads(2)

CFG = tiny_groma_config(box_score_thres=0.0)
CFG4 = CFG.replace(llm=CFG.llm.replace(hidden_size=256, intermediate_size=768,
                                       num_heads=2, num_kv_heads=2))
MAX_NEW = 6
HIDDEN_TOL = 1e-5          # test_torch_megakernel.py's, x max|hidden|


def _prompts(cfg, n, seed=0):
    tok = StableStubTokenizer(base_vocab=cfg.llm.vocab_size)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        t = build_rec_prompt(f'thing {i}', tok, spec)
        img = rng.standard_normal(
            (cfg.perceiver.image_size,) * 2 + (3,)).astype(np.float32)
        reqs.append((img, t['input_ids'], t['region_slot'], t['valid']))
    return tok, reqs


def _batch(reqs):
    return tuple(np.stack([r[i] for r in reqs]) for i in range(4))


@pytest.fixture
def step_runs(monkeypatch):
    """Every StepGraph.run's step count, in order."""
    runs = []
    run = StepGraph.run

    def recording(self, n):
        runs.append(n)
        return run(self, n)
    monkeypatch.setattr(StepGraph, 'run', recording)
    return runs


@pytest.fixture
def interpret(monkeypatch):
    """JAX's int8 and paged decode attention in the Pallas interpreter."""
    monkeypatch.setattr(
        j_decode_attention, 'int8_decode_attention',
        lambda *a: j_decode_attention._call_kernel(*a, interpret=True))
    monkeypatch.setattr(
        j_paged, 'paged_int8_decode_attention',
        lambda q, kp, ks, vp, vs, t, l: j_paged._call_kernel(
            t, l, q, kp, ks, vp, vs, interpret=True))


@pytest.fixture(scope='module')
def params():
    model = JGroma(CFG)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG)))()['params']
    return model, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope='module')
def params4():
    model = JGroma(CFG4)
    p = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                   **_dummy_batch(CFG4)))()['params']
    return model, jax.tree_util.tree_map(np.asarray, p)


# ------------------------------------------------- the loops against JAX

@pytest.mark.parametrize('b', [1, 2])
def test_generator_scan_matches_jax(params, step_runs, b):
    jmodel, p = params
    tok, reqs = _prompts(CFG, b)
    args = _batch(reqs)
    max_len = CFG.max_seq_len + MAX_NEW
    kw = dict(max_new_tokens=MAX_NEW, eos_id=tok.sp.eos)
    want, _ = JGenerator(jmodel, p, max_len=max_len).generate(
        *map(jnp.asarray, args), use_scan=True, **kw)
    gen = Generator(from_jax_params(p, CFG), max_len=max_len)
    got, _ = gen.generate(*args, use_scan=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert step_runs == [MAX_NEW - 1]
    assert gen.last_stats['decode_forwards'] == MAX_NEW - 1


@pytest.mark.parametrize('bits', [8, 4])
def test_quant_generator_matches_jax(params4, step_runs, bits):
    jmodel, p = params4
    tok, reqs = _prompts(CFG4, 2, seed=1)
    args = _batch(reqs)
    max_len = CFG4.max_seq_len + MAX_NEW
    kw = dict(max_new_tokens=MAX_NEW, eos_id=tok.sp.eos)
    want, _ = JQuantGenerator(jmodel, p, j_quantize(p, CFG4, bits=bits),
                              max_len=max_len, kv_bits=8).generate(
        *map(jnp.asarray, args), **kw)
    tmodel = from_jax_params(p, CFG4)
    tqp = quantize_groma_llm(tmodel, CFG4, bits=bits)
    assert tqp['layers'][0]['down_proj']['q'].dtype == (
        torch.uint8 if bits == 4 else torch.int8)
    gen = QuantGenerator(tmodel, tqp, max_len=max_len, kv_bits=8)
    got, _ = gen.generate(*args, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert sum(step_runs) == gen.last_stats['decode_forwards'] > 0


@pytest.mark.parametrize('bits,kv_bits,paged', [
    (8, 8, False), (None, 16, False), (4, 8, True)],
    ids=['int8-contiguous', 'unquantized', 'int4-paged'])
def test_engine_matches_jax_engine(params4, interpret, step_runs, bits,
                                   kv_bits, paged):
    jmodel, p = params4
    tok, reqs = _prompts(CFG4, 3, seed=2)
    kw = dict(max_slots=2, max_len=CFG4.max_seq_len + MAX_NEW + 8,
              eos_id=tok.sp.eos, chunk=2, max_new_tokens=MAX_NEW,
              kv_bits=kv_bits, paged_kv=paged)
    jqp = None if bits is None else j_quantize(p, CFG4, bits=bits)
    tmodel = from_jax_params(p, CFG4)
    tqp = None if bits is None else quantize_groma_llm(tmodel, CFG4,
                                                       bits=bits)
    outs = []
    for engine in (JEngine(jmodel, p, qp=jqp, **kw),
                   BatchEngine(tmodel, tqp, **kw)):
        try:
            sessions = [engine.submit(*r) for r in reqs]
            outs.append([list(s.token_stream()) for s in sessions])
        finally:
            engine.close()
    assert outs[1] == outs[0]
    assert all(len(o) >= 2 for o in outs[1])
    assert step_runs and set(step_runs) == {2}


@pytest.mark.parametrize('kind', ['generator', 'quant-generator'])
def test_a_kept_scan_answers_as_a_fresh_one(kind):
    """A generator keeps its scan (cache, state, graph) across calls of one
    batch size: a second and third call, on other prompts and lengths,
    give the tokens of a fresh generator; a new batch size makes a new
    scan."""
    tok, reqs = _prompts(CFG, 3, seed=6)
    max_len = CFG.max_seq_len + MAX_NEW

    def make():
        if kind == 'generator':
            return Generator(random_groma_unquantized(CFG, seed=0),
                             max_len=max_len)
        model, qp = random_groma(CFG, seed=0)
        return QuantGenerator(model, qp, max_len=max_len, kv_bits=8)
    kept = make()
    calls = [(reqs[:1], MAX_NEW), (reqs[1:2], 3), (reqs[:2], MAX_NEW),
             (reqs[2:3], MAX_NEW)]
    scans = []
    for rows, n in calls:
        got, _ = kept.generate(*_batch(rows), max_new_tokens=n, eos_id=-1)
        want, _ = make().generate(*_batch(rows), max_new_tokens=n,
                                  eos_id=-1)
        np.testing.assert_array_equal(got, want)
        scans.append(kept._decode)
    assert scans[0] is scans[1] and scans[2] is not scans[1]


def _mk_setup():
    """test_torch_megakernel.py's config at intermediate 512: seeded int4
    trees for both packages and an int8 cache after a 12-token prefill,
    row 1 with masked old positions, row 7 fully masked."""
    b, pre, maxlen = 8, 12, 256
    cfg = LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=2,
                      dtype='float32')
    rng = np.random.default_rng(7)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
    d, f = cfg.hidden_size, cfg.intermediate_size
    model = {'norm': {'scale': 1 + 0.1 * w(d)}}
    for i in range(cfg.num_layers):
        model[f'layers_{i}'] = {
            'input_layernorm': {'scale': 1 + 0.1 * w(d)},
            'post_attention_layernorm': {'scale': 1 + 0.1 * w(d)},
            'self_attn': {q: {'kernel': w(d, d)}
                          for q in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
            'gate_proj': {'kernel': w(d, f)}, 'up_proj': {'kernel': w(d, f)},
            'down_proj': {'kernel': w(f, d)}}
    jp = {'model': model}
    jqp = j_quantize_llama(jp, cfg, bits=4)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_llama(jp, cfg.num_layers).items()}
    tqp = quantize_llama_params(sd, cfg, bits=4)
    emb = (rng.standard_normal((b, pre, d)) * 0.5).astype(np.float32)
    jcache = j_qcache(cfg, b, maxlen)
    _, jcache = j_forward(jqp, cfg, jnp.asarray(emb),
                          jnp.ones((b, pre), bool),
                          jnp.broadcast_to(jnp.arange(pre)[None], (b, pre)),
                          jcache)
    mask = np.asarray(jcache['mask']).copy()
    mask[1, 3:7] = False
    mask[7] = False
    jcache['mask'] = jnp.asarray(mask)
    tc = make_quant_kv_cache(cfg, b, maxlen)
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        tc[key] = [torch.from_numpy(np.array(a)) for a in jcache[key]]
    tc['mask'] = torch.from_numpy(np.array(jcache['mask']))
    tc['index'] = int(jcache['index'])
    return cfg, jqp, tqp, jcache, tc, rng


def _megakernel_loop(cfg, tqp, tkv, embs, valid):
    """The megakernel decode loop as the card captures it: the step picks
    its embedding and writes its hidden state at the device step counter;
    the cache index is stack_kv_cache's device word."""
    tsp = mk.stack_decode_params(tqp)
    steps = embs.shape[0]
    state = {'kv': tkv, 'embs': embs, 'valid': valid,
             'hidden': torch.zeros((steps, *embs.shape[1:])),
             'step': torch.zeros((), dtype=torch.int64)}

    def step(st):
        at = st['step'].view(1)
        emb = st['embs'].index_select(0, at)[0]
        h, _ = quant_llama_decode_megakernel(tqp, tsp, cfg, emb, st['valid'],
                                             st['kv'])
        st['hidden'].index_copy_(0, at, h[None])
        st['step'].add_(1)
    StepGraph(step, state).run(steps)
    return state['hidden']


def test_megakernel_loop_on_a_device_word_matches_jax(monkeypatch):
    cfg, jqp, tqp, jcache, tc, rng = _mk_setup()
    orig = j_mk.fused_decode_step
    monkeypatch.setattr(j_mk, 'fused_decode_step',
                        lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    b, steps = 8, 3
    valid = np.ones((b, 1), bool)
    valid[7] = False
    embs = (rng.standard_normal((steps, b, 1, cfg.hidden_size)) * 0.5
            ).astype(np.float32)
    jsp, jst = j_mk.stack_decode_params(jqp), j_mk.stack_kv_cache(jcache)
    want = []
    for i in range(steps):
        h, jst = j_decode_megakernel(jqp, jsp, cfg, jnp.asarray(embs[i]),
                                     jnp.asarray(valid), jst)
        want.append(np.asarray(h))
    tkv = mk.stack_kv_cache(tc)
    word = tkv['index']
    assert word.dtype == torch.int32 and word.dim() == 0
    got = _megakernel_loop(cfg, tqp, tkv, torch.from_numpy(embs),
                           torch.from_numpy(valid))
    for i in range(steps):
        err = np.abs(got[i].numpy() - want[i]).max()
        assert err <= HIDDEN_TOL * np.abs(want[i]).max(), (i, err)
    assert tkv['index'] is word and int(word) == int(jst['index'])
    np.testing.assert_array_equal(tkv['mask'].numpy(),
                                  np.asarray(jst['mask']))


def test_plain_megakernel_step_takes_a_device_word():
    """fused_decode_step_plain at a 0-d int32 word writes what it writes
    at the same host slot, bitwise."""
    cfg, _, tqp, _, tc, rng = _mk_setup()
    sp = mk.stack_decode_params(tqp)
    b = 8
    x = torch.from_numpy((rng.standard_normal((b, cfg.hidden_size)) * 0.5)
                         .astype(np.float32))
    mask_bias = torch.where(tc['mask'], 0.0, -1e30).float()
    cur = torch.zeros((b, 1))
    cos, sin = torch.ones((b, 128)), torch.zeros((b, 128))
    out = []
    for pos in (12, torch.tensor(12, dtype=torch.int32)):
        kv = {k: [t.clone() for t in tc[k]]
              for k in ('k', 'v', 'k_scale', 'v_scale')}
        h = mk.fused_decode_step_plain(sp, x, kv, mask_bias, cur, cos, sin,
                                       pos)
        out.append((h, kv))
    assert torch.equal(out[0][0], out[1][0])
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        for a, c in zip(out[0][1][key], out[1][1][key]):
            assert torch.equal(a, c)


# ------------------------------------ the device index against the host one

def _copy_cache(cache):
    return {k: [t.clone() for t in v] if isinstance(v, list)
            else v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('path', ['bf16-path', 'int8-kv8', 'int8-kv16'])
def test_device_index_decode_is_bitwise_the_host_index_decode(path, b):
    cfg = CFG.llm
    rng = np.random.default_rng(3)
    s, steps, max_len = 10, 3, 16
    emb = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.hidden_size)).astype(np.float32))
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[-1, 7:] = False
    pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
    xs = [torch.from_numpy(rng.standard_normal(
        (b, 1, cfg.hidden_size)).astype(np.float32)) for _ in range(steps)]
    one = torch.ones((b, 1), dtype=torch.bool)
    if path == 'bf16-path':
        torch.manual_seed(0)
        model = LlamaModel(cfg)

        def fwd(x, m, p, c):
            return model(x, m, p, c)
        cache = make_kv_cache(cfg, b, max_len)
    else:
        _, qp = random_groma(CFG, seed=0)

        def fwd(x, m, p, c):
            return quant_llama_forward(qp, cfg, x, m, p, c)
        cache = (make_quant_kv_cache if path == 'int8-kv8'
                 else make_kv_cache)(cfg, b, max_len)
    with torch.no_grad():
        _, cache = fwd(emb, valid, pos, cache)
        host, dev = cache, _copy_cache(cache)
        dev['index'] = torch.tensor(host['index'])
        word = dev['index']
        for i, x in enumerate(xs):
            p = pos[:, -1:] + 1 + i
            want, host = fwd(x, one, p, host)
            got, dev = fwd(x, one, p, dev)
            assert torch.equal(got, want)
    assert dev['index'] is word and int(word) == host['index'] == s + steps
    for key in host:
        if key != 'index':
            for a, c in zip(*((host[key], dev[key]) if isinstance(
                    host[key], list) else ([host[key]], [dev[key]]))):
                assert torch.equal(a, c), key


# ------------------------------------------------------------ the guard

_READS = ('item', '__bool__', '__int__', '__float__', '__index__', 'cpu',
          'numpy', 'tolist')


@contextlib.contextmanager
def _no_host_io():
    """Host reads of a tensor and host data sent to a device raise."""
    saved = {n: getattr(torch.Tensor, n) for n in _READS}
    factories = {'tensor': torch.tensor, 'as_tensor': torch.as_tensor}

    def read(name):
        def refuse(*a, **kw):
            raise AssertionError(f'a decode step read a tensor on the host '
                                 f'(Tensor.{name})')
        return refuse

    def upload(name, fn):
        def checked(data, *a, **kw):
            if not torch.is_tensor(data) and kw.get('device') is not None:
                raise AssertionError(f'a decode step sent host data to a '
                                     f'device (torch.{name})')
            return fn(data, *a, **kw)
        return checked
    try:
        for n in _READS:
            setattr(torch.Tensor, n, read(n))
        for n, fn in factories.items():
            setattr(torch, n, upload(n, fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        for n, fn in factories.items():
            setattr(torch, n, fn)


@pytest.fixture
def guarded(monkeypatch):
    """Every StepGraph step runs under _no_host_io; -> the steps run."""
    steps = []
    run = StepGraph.run

    def guarded_run(self, n):
        step = self.step

        def checked(st):
            with _no_host_io():
                step(st)
            steps.append(1)
        self.step = checked
        try:
            return run(self, n)
        finally:
            self.step = step
    monkeypatch.setattr(StepGraph, 'run', guarded_run)
    return steps


def test_the_guard_catches_a_host_read():
    t = torch.ones(2)
    with _no_host_io():
        with pytest.raises(AssertionError, match='item'):
            t.sum().item()
        with pytest.raises(AssertionError, match='__bool__'):
            bool(t.all())
        with pytest.raises(AssertionError, match='device'):
            torch.tensor(1.0, device=t.device)
        torch.tensor(1.0)          # a host scalar, no device: allowed
    assert t.sum().item() == 2.0


@pytest.mark.parametrize('loop', [
    'generator', 'generator-sampled', 'quant-generator', 'engine-int8',
    'engine-unquantized', 'engine-paged-sampled', 'megakernel'])
def test_steps_read_nothing_back(guarded, loop):
    tok, reqs = _prompts(CFG, 2, seed=4)
    kw = dict(max_new_tokens=MAX_NEW, eos_id=-1)
    max_len = CFG.max_seq_len + MAX_NEW
    if loop.startswith('generator'):
        gen = Generator(random_groma_unquantized(CFG, seed=0),
                        max_len=max_len)
        gen.generate(*_batch(reqs[:1]), **kw,
                     temperature=0.7 if loop.endswith('sampled') else 0.0)
        assert len(guarded) == MAX_NEW - 1
    elif loop == 'quant-generator':
        model, qp = random_groma(CFG, seed=0)
        QuantGenerator(model, qp, max_len=max_len, kv_bits=8).generate(
            *_batch(reqs[:1]), **kw)
        assert len(guarded) == MAX_NEW - 1
    elif loop.startswith('engine'):
        if loop == 'engine-unquantized':
            model, qp = random_groma_unquantized(CFG, seed=0), None
        else:
            model, qp = random_groma(CFG, seed=0)
        engine = BatchEngine(model, qp, max_slots=2,
                             max_len=max_len + 8, eos_id=-1, chunk=2,
                             max_new_tokens=MAX_NEW,
                             kv_bits=16 if qp is None else 8,
                             paged_kv=loop.startswith('engine-paged'))
        temp = 0.7 if loop.endswith('sampled') else 0.0
        try:
            sessions = [engine.submit(*r, temperature=temp) for r in reqs]
            assert all(len(list(s.token_stream())) == MAX_NEW
                       for s in sessions)
        finally:
            engine.close()
        assert len(guarded) >= MAX_NEW - 1
    else:
        cfg, _, tqp, _, tc, rng = _mk_setup()
        embs = torch.from_numpy((rng.standard_normal(
            (2, 8, 1, cfg.hidden_size)) * 0.5).astype(np.float32))
        _megakernel_loop(cfg, tqp, mk.stack_kv_cache(tc), embs,
                         torch.ones((8, 1), dtype=torch.bool))
        assert len(guarded) == 2


# ------------------------------------------------------------- true_div

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d', [127.0, 3.0, 10.0])
def test_true_div_is_the_ieee_division(dtype, d):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(4096) * 300,
                        np.arange(-500, 500) * d / 2]).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    got = true_div(torch.from_numpy(x), d)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), x / x.dtype.type(d))
    assert torch.equal(got, torch.from_numpy(x) / torch.tensor(d, dtype=dtype))
