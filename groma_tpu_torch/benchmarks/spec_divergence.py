"""How far a speculative verify forward's logits sit from sequential
decoding's, sound and with a fault put in, on the int8 served path.

    python3 -m groma_tpu_torch.benchmarks.spec_divergence [--seed 0]

chip_smoke accepts speculative tokens that part from the sequential ones
only at a near-tie: where the verify forward's logits stay within a bound
of the decode step's.  This run measures what that bound must separate, at
full Groma-7B width with random weights from ``--seed`` (``ModelWorker``,
int8 LLM, int8 KV cache of 2112 slots): for each of three requests and a
few positions j of its greedy tokens, the decode step's logits at j (the
forward of token j-1 on the cache of the prompt and tokens 0..j-2) against
the first row of a chunked append of G+1 tokens at the same slot, on a
copy of that cache, with

* ``sound``: the verify as ``eval/speculative.py`` runs it;
* ``rope +1``: the chunk's rope positions one too far;
* ``slot -1``: the chunk written one slot early, over token j-2.

Each line gives the sequential top-2 logit gap, max |verify - decode| and
whether the sequential top-2 tokens hold top-2 values in the verify's
logits.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

from groma_tpu_torch.benchmarks.ab_int8 import PROMPTS, _image

LOOKAHEAD = 4          # chip_smoke's SPEC_LOOKAHEAD
MAX_NEW = 32           # chip_smoke's MAX_NEW_TOKENS
POSITIONS = (1, 6, 13)
FAULTS = (('sound', 0, 0), ('rope +1', 1, 0), ('slot -1', 0, -1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights and images')
    args = ap.parse_args()

    import torch
    from groma_tpu_torch.eval.generate_quant import quant_embed, quant_logits
    from groma_tpu_torch.models.groma import _ordinal
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_forward)
    from groma_tpu_torch.serve.worker import ModelWorker, expand_request
    if not torch.cuda.is_available():
        raise SystemExit('spec_divergence: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    worker = ModelWorker('random', seed=args.seed, quant_type='int8',
                         kv_bits=8, device='cuda')
    gen = worker.generator
    model, qp, llm = gen.model, gen.qp, gen.model.cfg.llm
    dev = qp['norm'].device
    vocab = llm.vocab_size
    one = torch.ones((1, 1), dtype=torch.bool, device=dev)

    def token(toks, i):
        return torch.tensor([[toks[i]]], device=dev)

    @torch.inference_mode()
    def logits_at(request, toks, j, pos_shift, slot_shift):
        images, ids, slot, valid0 = (torch.as_tensor(a, device=dev)
                                     for a in request)
        emb, _, valid, _ = model.prepare_stream(images.float(), ids.long(),
                                                slot.long(), valid0)
        pos = _ordinal(valid).clamp(min=0)
        cache = make_quant_kv_cache(llm, 1, gen.max_len, device=dev)
        quant_llama_forward(qp, llm, emb, valid, pos, cache)
        pos0 = int(pos.max()) + 1
        for i in range(j - 1):
            quant_llama_forward(qp, llm, quant_embed(qp, token(toks, i),
                                                     vocab),
                                one, torch.tensor([[pos0 + i]], device=dev),
                                cache)
        copy = {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone() if torch.is_tensor(v) else v)
                for k, v in cache.items()}
        h, _ = quant_llama_forward(
            qp, llm, quant_embed(qp, token(toks, j - 1), vocab), one,
            torch.tensor([[pos0 + j - 1]], device=dev), cache)
        seq = quant_logits(qp, h)[0, -1].float()
        copy['index'] += slot_shift
        chunk = token(toks, j - 1).repeat(1, LOOKAHEAD + 1)
        h, _ = quant_llama_forward(
            qp, llm, quant_embed(qp, chunk, vocab),
            torch.ones((1, LOOKAHEAD + 1), dtype=torch.bool, device=dev),
            pos0 + j - 1 + pos_shift
            + torch.arange(LOOKAHEAD + 1, device=dev)[None], copy,
            chunked=True)
        return seq, quant_logits(qp, h)[0, 0].float()

    eos = worker.tokenizer.sp.eos
    size = worker.cfg.perceiver.image_size
    for r, prompt in enumerate(PROMPTS):
        t = expand_request(worker.tokenizer, worker.spec, {'prompt': prompt})
        request = (_image(args.seed + 1 + r, size)[None],
                   t['input_ids'][None], t['region_slot'][None],
                   t['valid'][None])
        toks, _ = gen.generate(*request, max_new_tokens=MAX_NEW, eos_id=eos)
        toks = toks[0].tolist()
        for j in (p for p in POSITIONS if p < len(toks)):
            for name, pos_shift, slot_shift in FAULTS:
                seq, ver = logits_at(request, toks, j, pos_shift, slot_shift)
                top = torch.topk(seq, 2)
                second = torch.topk(ver, 2).values[1]
                kept = bool((ver[top.indices] >= second).all())
                print(f'request {r} j={j} {name}: sequential top-2 gap '
                      f'{(top.values[0] - top.values[1]).item():.4e}, '
                      f'|verify - decode| '
                      f'{(ver - seq).abs().max().item():.4e}, sequential '
                      f'top-2 among the verify\'s top-2 values {kept}')


if __name__ == '__main__':
    main()
