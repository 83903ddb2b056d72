"""The port's caption metrics, region-captioning kit and LLaVA-bench kit
against the JAX package's.

* ``eval/cap.py``: every case of ``tests/test_cap_metrics.py`` scored by
  both packages, equal to the last bit (both are the same pure-Python
  arithmetic); METEOR's stem stage runs the port's own Porter stemmer,
  held word for word to nltk's (which JAX's METEOR imports) over the
  repository's prose and a list of the rules' corner cases.
* ``eval/region_cap.py``: the prompt, the captions of the unquantized
  ``Generator`` (JAX's greedy tokens exactly, so the same text), the shard
  files and the merged scores, and the two CLIs run on the same exported
  tiny checkpoint and COCO-format drill data: identical shards and
  scores.
* ``eval/vqa.py``: the answers of ``answer_questions`` (JAX's exactly),
  the judge harness over the carried assets (its own copy, byte for byte
  JAX's): reviews, resume, the visual context join, the judge factory, the
  summaries and the CLI's output identical.
"""

import filecmp
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import groma_tpu.eval.cap as j_cap
import groma_tpu.eval.region_cap as j_region_cap
import groma_tpu.eval.vqa as j_vqa
from groma_tpu.checkpoint.hf_export import export_hf_dir
from groma_tpu.checkpoint.loader import _dummy_batch
from groma_tpu.config import tiny_groma_config
from groma_tpu.data.datasets.base import VLDataSpec
from groma_tpu.eval.generate import Generator as JGenerator
from groma_tpu.models.groma import GromaModel as JGroma
from groma_tpu_torch.checkpoint.loader import from_jax_params
from groma_tpu_torch.data.tokenizer import StableStubTokenizer
from groma_tpu_torch.eval import cap, region_cap, vqa
from groma_tpu_torch.eval.generate import Generator

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_TABLE = os.path.join(REPO, 'groma_tpu', 'eval', 'table')
T_TABLE = vqa.TABLE
CFG = tiny_groma_config(box_score_thres=0.0)
SPEC = VLDataSpec(num_image_tokens=CFG.num_image_tokens,
                  max_region_num=CFG.max_region_num,
                  max_seq_len=CFG.max_seq_len,
                  image_size=CFG.perceiver.image_size)


# ------------------------------------------------------------ cap.py

CANDS = {'a': 'a cat sits on the mat', 'b': 'dog runs in the park'}
REFS = {'a': ['a cat sits on the mat', 'the cat is on the mat'],
        'b': ['a bird flies over the sea']}
CAP_CASES = [
    ('bleu', {'x': 'the quick brown fox jumps'},
     {'x': ['the quick brown fox jumps']}, {}),
    ('meteor', {'x': 'the cat sat on the mat'},
     {'x': ['the cat sat on the mat']}, {}),
    ('meteor', {'x': 'the cat sat'}, {'x': ['the cat is on the mat']}, {}),
    ('meteor', {'x': 'a b c d'}, {'x': ['a b c d']}, {}),
    ('meteor', {'x': 'a c b d'}, {'x': ['a b c d']}, {}),
    ('meteor', {'x': 'xyz qrs'}, {'x': ['abc def']}, {}),
    ('cider_d', CANDS, REFS, {}),
    ('cider_d', {'a': 'completely unrelated words here', 'b': 'zig zag zog'},
     REFS, {}),
    ('score_captions', CANDS, REFS, {}),
    ('meteor', {'x': ''}, {'x': ['a b']}, {}),
    ('rouge_l', {'x': 'the cat sat on the mat'},
     {'x': ['a cat sat on a mat', 'the cat is on the mat']}, {}),
    ('rouge_l', {'x': 'red box'}, {'x': ['the big red box on the left']},
     {}),
    ('rouge_l', {'x': 'a b c d'}, {'x': ['a b', 'a b c d e f g h']}, {}),
    ('rouge_l', {'x': ''}, {'x': ['a b']}, {}),
    ('meteor', {'x': 'a man riding horses near the walls'},
     {'x': ['a man rides a horse near the wall']}, {'use_stem': False}),
    ('meteor', {'x': 'a man riding horses near the walls'},
     {'x': ['a man rides a horse near the wall']}, {'use_stem': True}),
    ('meteor', {'x': 'the cat sat on the mat'},
     {'x': ['the cat sat on the mat']}, {'use_stem': True}),
    ('score_captions',
     {'1': 'two dogs are playing happily in the grassy fields',
      '2': 'a woman holding an umbrella while walking'},
     {'1': ['dogs played happily on a grassy field', 'two puppies playing'],
      '2': ['the women held umbrellas', 'a lady walks with her umbrella']},
     {}),
]


@pytest.mark.parametrize('fn,cands,refs,kw', CAP_CASES)
def test_caption_scores_equal_jax(fn, cands, refs, kw):
    assert getattr(cap, fn)(cands, refs, **kw) == \
        getattr(j_cap, fn)(cands, refs, **kw)


def test_meteor_stems_with_the_ports_stemmer():
    """The port's METEOR stems with nltk's Porter stemmer, as JAX's."""
    stem, j_stem = cap._porter(), j_cap._porter()
    assert stem is not None and j_stem is not None
    words = 'riding horses walls rides horse wall happily skies'.split()
    assert [stem(w) for w in words] == [j_stem(w) for w in words]


METEOR_CASES = [(c, r) for fn, c, r, _ in CAP_CASES if fn == 'meteor']


@pytest.mark.parametrize('cands,refs', METEOR_CASES)
def test_meteor_without_nltk_is_exact_only_as_jax(cands, refs, monkeypatch):
    """Where nltk is absent (the card's machine) both METEORs match exact
    words only, and still agree."""
    monkeypatch.setitem(sys.modules, 'nltk.stem.porter', None)
    assert cap._porter() is None and j_cap._porter() is None
    assert cap.meteor(cands, refs) == j_cap.meteor(cands, refs) == \
        cap.meteor(cands, refs, use_stem=False)


# ------------------------------------------------------ region_cap.py

@pytest.fixture(scope='module')
def models():
    jmodel = JGroma(CFG)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0),
                                         **_dummy_batch(CFG)))()['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, from_jax_params(params, CFG)


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
             'sample_id': 10 + i,
             'refer_box': np.array([0.3 + 0.1 * i, 0.5, 0.3, 0.4 - 0.1 * i],
                                   np.float32)} for i in range(n)]


def test_region_cap_prompt_equals_jax():
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    want = j_region_cap.build_region_cap_prompt(tok, SPEC)
    got = region_cap.build_region_cap_prompt(tok, SPEC)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_region_captions_shards_and_scores_equal_jax(models, tmp_path):
    jmodel, params, tmodel = models
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    jgen = JGenerator(jmodel, params, max_len=CFG.max_seq_len + 16)
    tgen = Generator(tmodel, max_len=CFG.max_seq_len + 16)
    jpaths, tpaths = [], []
    for rank, part in enumerate((_samples(2), _samples(1, seed=1))):
        jpaths.append(j_region_cap.generate_region_captions(
            jgen, part, tok, SPEC, str(tmp_path / 'jax'), max_new_tokens=8,
            rank=rank))
        tpaths.append(region_cap.generate_region_captions(
            tgen, part, tok, SPEC, str(tmp_path / 'port'), max_new_tokens=8,
            rank=rank))
    for jp, tp in zip(jpaths, tpaths):
        assert os.path.basename(jp) == os.path.basename(tp)
        with open(jp) as f, open(tp) as g:
            want, got = json.load(f), json.load(g)
        assert got == want and all(r['caption'] for r in got)
    refs = {10: 'a small thing on the left', '11': ['a dog', 'the cat'],
            10 ** 6: 'no such sample'}
    assert region_cap.merge_and_score(str(tmp_path / 'port'), refs) == \
        j_region_cap.merge_and_score(str(tmp_path / 'jax'), refs)


def _drill_data(root, n=3, seed=0):
    """COCO-format region-caption data: one PNG and one annotation (a box
    and its caption) per image."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    (root / 'images').mkdir(parents=True)
    images, anns = [], []
    for i in range(n):
        w, h = 64 + 8 * i, 56
        name = f'vg_{i}.png'
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)) \
            .save(root / 'images' / name)
        images.append({'id': i, 'file_name': name, 'width': w, 'height': h})
        anns.append({'id': i, 'image_id': i, 'bbox': [8.0, 6.0, 24.0, 20.0],
                     'category_id': 1, 'area': 480.0, 'iscrowd': 0,
                     'caption': f'a thing number {i}'})
    ann = root / 'region_cap.json'
    with open(ann, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': 1, 'name': 'object'}]}, f)
    return str(root / 'images'), str(ann)


def test_region_cap_cli_equals_jax(models, tmp_path, monkeypatch, capsys):
    _, params, _ = models
    ckpt = str(tmp_path / 'ckpt')
    export_hf_dir(params, CFG, ckpt)
    images, ann = _drill_data(tmp_path / 'data')
    common = ['--model-dir', ckpt, '--img-prefix', images, '--ann-file',
              ann, '--tokenizer', 'stub', '--max-new-tokens', '6']
    monkeypatch.setattr(sys, 'argv', ['region_cap', *common, '--result-dir',
                                      str(tmp_path / 'jax')])
    j_region_cap.main()
    want = json.loads(capsys.readouterr().out)
    got = region_cap.main(common + ['--result-dir', str(tmp_path / 'port'),
                                    '--device', 'cpu'])
    assert json.loads(capsys.readouterr().out) == got == want
    assert got['num'] == 3
    assert filecmp.cmp(tmp_path / 'jax' / 'captions_rank0.json',
                       tmp_path / 'port' / 'captions_rank0.json',
                       shallow=False)


# ------------------------------------------------------------ vqa.py

def test_carried_judge_assets_are_jaxs():
    names = []
    for root, _, files in os.walk(J_TABLE):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), J_TABLE)
            names.append(rel)
            assert filecmp.cmp(os.path.join(J_TABLE, rel),
                               os.path.join(T_TABLE, rel), shallow=False), rel
    assert len(names) >= 8 and 'rule.json' in names
    assert vqa.load_rules() == j_vqa.load_rules()


def test_answers_equal_jax(models):
    jmodel, params, tmodel = models
    tok = StableStubTokenizer(base_vocab=CFG.llm.vocab_size)
    with open(os.path.join(T_TABLE, 'question.jsonl')) as f:
        questions = [json.loads(line) for line in f][:2]
    rng = np.random.default_rng(2)
    samples = [{'image': rng.standard_normal((56, 56, 3)).astype(np.float32),
                'question': q['text'], 'question_id': q['question_id']}
               for q in questions]
    jgen = JGenerator(jmodel, params, max_len=CFG.max_seq_len + 16)
    tgen = Generator(tmodel, max_len=CFG.max_seq_len + 16)
    want = j_vqa.answer_questions(jgen, samples, tok, SPEC, max_new_tokens=8)
    got = vqa.answer_questions(tgen, samples, tok, SPEC, max_new_tokens=8)
    assert got == want and len(got) == 2


def test_judge_prompt_and_score_parsing_equal_jax():
    args = ('What is shown?', 'ctx', 'A dog.', 'A cat.')
    assert vqa.build_judge_prompt(*args) == j_vqa.build_judge_prompt(*args)
    for review in ('8 6\nwhy', '7, 9', 'garbage', '', '3.5 4.25 extra'):
        assert vqa.parse_judge_scores(review) == \
            j_vqa.parse_judge_scores(review)
    qs = [{'question_id': 1, 'text': 'q one', 'category': 'conv'},
          {'question_id': 2, 'text': 'q two'}]
    a1 = [{'question_id': 1, 'text': 'x'}, {'question_id': 2, 'text': 'y'}]
    a2 = [{'question_id': 2, 'text': 'z'}, {'question_id': 1, 'text': 'w'}]

    def judge(system, prompt):
        return f'{len(prompt) % 10} 5\n{system[:10]}'
    got = vqa.review_answers(qs, a1, a2, {1: 'c'}, judge)
    assert got == j_vqa.review_answers(qs, a1, a2, {1: 'c'}, judge)
    assert vqa.summarize_reviews(got) == j_vqa.summarize_reviews(got)


def test_review_files_over_the_carried_assets_equal_jax(tmp_path):
    def run(mod, table, out):
        return mod.review_files(
            f'{table}/question.jsonl',
            f'{table}/answer/answer_alpaca-13b.jsonl',
            f'{table}/answer/answer_vicuna-13b.jsonl',
            mod.make_judge('stub'), output_path=str(out))
    got = run(vqa, T_TABLE, tmp_path / 'port.jsonl')
    want = run(j_vqa, J_TABLE, tmp_path / 'jax.jsonl')
    assert got == want and len(got) == 80
    assert (tmp_path / 'port.jsonl').read_text() == \
        (tmp_path / 'jax.jsonl').read_text()
    # resume: nothing is judged again
    again = vqa.review_files(
        f'{T_TABLE}/question.jsonl',
        f'{T_TABLE}/answer/answer_alpaca-13b.jsonl',
        f'{T_TABLE}/answer/answer_vicuna-13b.jsonl', judge=None,
        output_path=str(tmp_path / 'port.jsonl'))
    assert again == got
    assert vqa.summarize_reviews(got) == j_vqa.summarize_reviews(want)
    assert vqa.summarize_reviews(got)['generic']['relative_score'] == 100.0


def test_visual_context_join_equals_jax(tmp_path):
    ctx_path = f'{T_TABLE}/caps_boxes_coco2014_val_80.jsonl'
    contexts = vqa.load_contexts(ctx_path)
    assert contexts == j_vqa.load_contexts(
        f'{J_TABLE}/caps_boxes_coco2014_val_80.jsonl')
    image = sorted(contexts)[3]
    q = tmp_path / 'q.jsonl'
    q.write_text(json.dumps({'question_id': 1, 'image': image,
                             'text': 'What is shown?',
                             'category': 'conv'}) + '\n')
    a = tmp_path / 'a.jsonl'
    a.write_text(json.dumps({'question_id': 1, 'answer_id': 'x',
                             'text': 'A thing.'}) + '\n')
    prompts = []

    def spy(system, prompt):
        prompts.append((system, prompt))
        return '8 6\nbecause'
    got = vqa.review_files(str(q), str(a), str(a), spy,
                           context_path=ctx_path)
    want = j_vqa.review_files(str(q), str(a), str(a), spy,
                              context_path=ctx_path)
    assert got == want and got[0]['tuple'] == [8.0, 6.0]
    assert prompts[0] == prompts[1]
    assert f'[Context]\n{contexts[image]}' in prompts[0][1]


def test_make_judge_specs_match_jax():
    assert vqa.make_judge('stub')('s', 'p') == j_vqa.make_judge('stub')('s',
                                                                      'p')
    assert callable(vqa.make_judge('http://localhost:1/judge'))
    with pytest.raises(ValueError):
        vqa.make_judge('openai')


def test_judge_cli_equals_jax(capsys):
    argv = ['-a', f'{T_TABLE}/answer/answer_bard.jsonl',
            f'{T_TABLE}/answer/answer_gpt35.jsonl', '--judge', 'stub']
    got = vqa.main(argv)
    out = capsys.readouterr().out
    j_vqa.main(['-q', f'{J_TABLE}/question.jsonl', '-a',
                f'{J_TABLE}/answer/answer_bard.jsonl',
                f'{J_TABLE}/answer/answer_gpt35.jsonl', '--judge', 'stub'])
    assert out == capsys.readouterr().out
    assert json.loads(out) == got and got


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')


def test_region_cap_refuses_the_cpu_by_default(no_card, tmp_path):
    images, ann = _drill_data(tmp_path / 'data', n=1)
    with pytest.raises(RuntimeError, match='--device cpu'):
        region_cap.main(['--model-dir', 'tiny', '--tokenizer', 'stub',
                         '--img-prefix', images, '--ann-file', ann,
                         '--result-dir', str(tmp_path / 'out')])
