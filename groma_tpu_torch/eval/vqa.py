"""Question answering and the pairwise judge harness, LLaVA-bench style
(counterpart of ``groma_tpu/eval/vqa.py``).

The reference answers with model_vqa.py and has GPT review each pair of
answers (eval_gpt_review_visual.py, summarize_gpt_review.py) over its
judge assets, which the port carries in ``eval/table/`` (rules, questions,
answers, the COCO caption-and-box contexts).  ``answer_questions`` runs
the unquantized model's ``Generator``; the judge is any callable
``judge(system, prompt) -> review``: ``make_judge('stub')`` scores both
answers 5, ``make_judge('http:<url>')`` posts to a server the user points
it at.  Prompts and the relative-score summary follow the reference.

    python -m groma_tpu_torch.eval.vqa -a A1.jsonl A2.jsonl --judge stub
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List

import numpy as np

from groma_tpu_torch.data.conversation import conv_templates
from groma_tpu_torch.data.datasets.base import VLDataSpec, intro_conversation
from groma_tpu_torch.data.tokenization import expand_template

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'table')
RULE_PATH = os.path.join(TABLE, 'rule.json')


def load_rules() -> dict:
    """Per-category judge rules (reference: groma/eval/table/rule.json)."""
    with open(RULE_PATH) as f:
        return json.load(f)


JUDGE_SYSTEM = (
    'You are a helpful and precise assistant for checking the quality of '
    'the answer.')
JUDGE_RULE = (
    'We would like to request your feedback on the performance of two AI '
    'assistants in response to the user question displayed above. The user '
    'asks the question on observing an image. Please rate the helpfulness, '
    'relevance, accuracy, level of details of their responses. Each '
    'assistant receives an overall score on a scale of 1 to 10, where a '
    'higher score indicates better overall performance. Please first '
    'output a single line containing only two values indicating the scores '
    'for Assistant 1 and 2, respectively. In the subsequent line, please '
    'provide a comprehensive explanation of your evaluation.')


def answer_questions(generator, samples: Iterable[dict],
                     tokenizer, spec: VLDataSpec,
                     conv_temp: str = 'llava',
                     max_new_tokens: int = 256) -> List[dict]:
    """``samples``: dicts with 'image' (normalized), 'question' and
    'question_id'.  Greedy answers from ``generator``
    (``eval.generate.Generator``) -> [{'question_id', 'text'}], the shape
    model_vqa.py writes."""
    conv = conv_templates[conv_temp]
    sp = tokenizer.sp
    out = []
    for s in samples:
        messages = intro_conversation(conv)
        messages.append((conv.roles[0], s['question']))
        messages.append((conv.roles[1], None))
        ids = tokenizer.encode(conv.get_prompt(messages))
        t = expand_template(ids, None, sp, spec.num_image_tokens,
                            spec.max_region_num, spec.max_seq_len)
        tokens, _ = generator.generate(
            s['image'][None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None], max_new_tokens=max_new_tokens, eos_id=sp.eos)
        text = tokenizer.decode(
            [int(tok) for tok in tokens[0] if tok != sp.eos])
        out.append({'question_id': s['question_id'], 'text': text})
    return out


def build_judge_prompt(question: str, context: str, answer1: str,
                       answer2: str) -> str:
    """(reference: eval_gpt_review_visual.py prompt assembly)."""
    return (f'[Context]\n{context}\n\n'
            f'[Question]\n{question}\n\n'
            f'[Assistant 1]\n{answer1}\n\n[End of Assistant 1]\n\n'
            f'[Assistant 2]\n{answer2}\n\n[End of Assistant 2]\n\n'
            f'[System]\n{JUDGE_RULE}\n\n')


def parse_judge_scores(review: str):
    """First line 'x y' -> (x, y); (-1, -1) on failure
    (reference: eval_gpt_review_visual.py parse_score)."""
    try:
        parts = review.splitlines()[0].replace(',', ' ').split()
        return float(parts[0]), float(parts[1])
    except Exception:
        return -1.0, -1.0


def review_answers(questions: List[dict], answers1: List[dict],
                   answers2: List[dict], contexts: Dict,
                   judge: Callable[[str, str], str]) -> List[dict]:
    """Run the pairwise judge; ``judge(system, prompt) -> review text``."""
    reviews = []
    a1 = {a['question_id']: a for a in answers1}
    a2 = {a['question_id']: a for a in answers2}
    for q in questions:
        qid = q['question_id']
        prompt = build_judge_prompt(q['text'],
                                    contexts.get(qid, ''),
                                    a1[qid]['text'], a2[qid]['text'])
        review = judge(JUDGE_SYSTEM, prompt)
        s1, s2 = parse_judge_scores(review)
        reviews.append({'question_id': qid, 'content': review,
                        'tuple': [s1, s2],
                        'category': q.get('category', 'all')})
    return reviews


def load_contexts(path: str) -> Dict[str, str]:
    """image filename -> '[captions]\\n\\n[category: bbox lines]' context
    string (reference: eval_gpt_review_visual.py:75-84 — cap_str +
    box_str assembly from caps_boxes_coco2014_val_80.jsonl)."""
    out = {}
    with open(path) as f:
        for line in f:
            inst = json.loads(line)
            cap_str = '\n'.join(inst['captions'])
            box_str = '\n'.join(
                f'{i["category"]}: {i["bbox"]}' for i in inst['instances'])
            out[inst['image']] = f'{cap_str}\n\n{box_str}'
    return out


def review_files(question_path: str, answer1_path: str, answer2_path: str,
                 judge: Callable[[str, str], str],
                 context_path: str | None = None,
                 rule_path: str = RULE_PATH,
                 output_path: str | None = None) -> List[dict]:
    """The reference judge-harness protocol over its jsonl assets
    (reference: eval_gpt_review_visual.py:52-124): zip question/answer
    files line-by-line, build the [Context]/[Question]/[{role} 1/2]
    prompt with the per-category rule from rule.json, call the judge,
    parse 'x y' scores.  Questions without an 'image' field (the text
    Vicuna-bench set carried in table/question.jsonl) get an empty
    context and fall back to the 'default' rule.  ``output_path``
    append-resumes: already-reviewed lines are skipped, each new review
    is written immediately (the reference's crash-resume idiom)."""
    with open(rule_path) as f:
        rules = json.load(f)
    contexts = load_contexts(context_path) if context_path else {}
    done = 0
    out_f = None
    reviews: List[dict] = []
    if output_path:
        if os.path.isfile(output_path):
            with open(output_path) as f:
                reviews = [json.loads(line) for line in f]
            done = len(reviews)
        out_f = open(output_path, 'a')
    with open(question_path) as fq, open(answer1_path) as f1, \
            open(answer2_path) as f2:
        for idx, (lq, l1, l2) in enumerate(zip(fq, f1, f2)):
            if idx < done:
                continue
            ques, a1, a2 = json.loads(lq), json.loads(l1), json.loads(l2)
            cat = ques.get('category', 'default')
            rule = rules[cat] if cat in rules else rules['default']
            ctx = contexts.get(ques.get('image', ''), '')
            role = rule['role']
            prompt = (f'[Context]\n{ctx}\n\n'
                      f'[Question]\n{ques["text"]}\n\n'
                      f'[{role} 1]\n{a1["text"]}\n\n[End of {role} 1]\n\n'
                      f'[{role} 2]\n{a2["text"]}\n\n[End of {role} 2]\n\n'
                      f'[System]\n{rule["prompt"]}\n\n')
            review = judge(JUDGE_SYSTEM, prompt)
            s1, s2 = parse_judge_scores(review)
            rec = {'id': idx + 1, 'question_id': ques['question_id'],
                   'answer1_id': a1.get('answer_id', ''),
                   'answer2_id': a2.get('answer_id', ''),
                   'category': cat, 'content': review,
                   'tuple': [s1, s2]}
            reviews.append(rec)
            if out_f:
                out_f.write(json.dumps(rec) + '\n')
                out_f.flush()
    if out_f:
        out_f.close()
    return reviews


def make_judge(spec: str) -> Callable[[str, str], str]:
    """Judge factory for the CLI: 'stub' scores both answers 5 (harness
    drills without an LLM); 'http:<url>' POSTs {'system','prompt'} JSON
    and expects {'text': ...} back — point it at any LLM endpoint (the
    reference hardcodes the OpenAI API; zero-egress environments plug a
    local server here)."""
    if spec == 'stub':
        return lambda system, prompt: '5 5\nstub judge (no LLM attached)'
    if spec.startswith('http'):
        import urllib.request

        def judge(system, prompt, _url=spec):
            req = urllib.request.Request(
                _url, json.dumps({'system': system,
                                  'prompt': prompt}).encode(),
                {'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())['text']
        return judge
    raise ValueError(f'unknown judge spec: {spec!r} (use stub or http:url)')


def summarize_reviews(reviews: List[dict]) -> dict:
    """Relative score summary (reference: summarize_gpt_review.py)."""
    by_cat = {}
    for r in reviews:
        by_cat.setdefault(r['category'], []).append(r['tuple'])
    out = {}
    for cat, pairs in by_cat.items():
        arr = np.asarray([p for p in pairs if p[0] >= 0])
        if len(arr) == 0:
            continue
        out[cat] = {
            'relative_score': float(100 * (arr[:, 1] / arr[:, 0]).mean()),
            'score1': float(arr[:, 0].mean()),
            'score2': float(arr[:, 1].mean()),
            'n': len(arr),
        }
    return out


def main(argv=None):
    """CLI mirror of the reference judge harness
    (reference: eval_gpt_review_visual.py argparse surface +
    summarize_gpt_review.py): review two answer files against the
    carried benchmark assets, then print the per-category summary."""
    import argparse
    p = argparse.ArgumentParser(description='LLaVA-bench judge harness')
    p.add_argument('-q', '--question', default=f'{TABLE}/question.jsonl')
    p.add_argument('-c', '--context', default=None,
                   help='caps_boxes jsonl (visual questions only)')
    p.add_argument('-a', '--answer-list', nargs=2, required=True)
    p.add_argument('-r', '--rule', default=RULE_PATH)
    p.add_argument('-o', '--output', default=None)
    p.add_argument('--judge', default='stub',
                   help="'stub' or 'http:<url>' (see make_judge)")
    args = p.parse_args(argv)
    reviews = review_files(args.question, args.answer_list[0],
                           args.answer_list[1], make_judge(args.judge),
                           context_path=args.context, rule_path=args.rule,
                           output_path=args.output)
    summary = summarize_reviews(reviews)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == '__main__':
    main()
