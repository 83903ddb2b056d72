"""How far the engine's chunked prefill sits from its one-shot prefill,
sound and with a fault put in, on the int8 serving path.

    python3 -m groma_tpu_torch.benchmarks.chunk_divergence [--seed 0] \
        [--requests 4]

chip_smoke holds the chunked engine (prefill chunks of 192) against the
one-shot engine on JAX's REC engine cell: the first logits within a bound
relative to max |one-shot|, and the logits of every decoded position at
which both streams still agree within an absolute bound.  This run
measures what those bounds must separate, at full Groma-7B width with
random weights from ``--seed`` (int8 LLM, int8 KV, chip_smoke's 640-slot
REC streams and 768-slot caches): for each request, the one-shot prefill
and its greedy tokens, and the chunked prefill as
``BatchEngine._chunked_prefill`` runs it ((1, 192) appends at a device
index into a 768-slot chunk cache, the index then set to the last valid
token + 1) followed by the same tokens teacher-forced, with

* ``sound``: the chunks as the engine appends them;
* ``slot -1``: every chunk after the first written one slot early, over
  the previous chunk's last token;
* ``slot +1``: every chunk after the first written one slot late, so that
  the first decode overwrites the stream's last token;
* ``rope +1``: every chunk after the first at rope positions one too far.

Each line gives max |chunked - one-shot| of the first logits relative to
max |one-shot|, and of the decoded positions' logits (the largest and the
median over positions), then the largest of each over the requests.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

STREAM, CHUNK, NEW, MAX_LEN = 640, 192, 48, 768   # chip_smoke's STACK_*
PROMPT = 'Locate the {} red object on the left of the image.'
ORDINALS = ('first', 'second', 'third', 'fourth', 'fifth', 'sixth',
            'seventh', 'eighth')
FAULTS = (('sound', 0, 0), ('slot -1', -1, 0), ('slot +1', 1, 0),
          ('rope +1', 0, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights and images')
    ap.add_argument('--requests', type=int, default=4,
                    choices=range(1, len(ORDINALS) + 1))
    args = ap.parse_args()

    import numpy as np
    import torch
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.image_pipeline import normalize
    from groma_tpu_torch.eval.generate_quant import quant_embed, quant_logits
    from groma_tpu_torch.models.llama_quant import (make_quant_kv_cache,
                                                    quant_llama_forward)
    from groma_tpu_torch.serve.worker import ModelWorker, expand_request
    if not torch.cuda.is_available():
        raise SystemExit('chunk_divergence: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    worker = ModelWorker('random', seed=args.seed, quant_type='int8',
                         kv_bits=8, device='cuda')
    gen = worker.generator
    model, qp, cfg = gen.model, gen.qp, worker.cfg
    llm, dev = cfg.llm, qp['norm'].device
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=STREAM,
                      image_size=cfg.perceiver.image_size)
    size = cfg.perceiver.image_size
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)

    def decode(cache, pos0, toks):
        """Logits (f32) after each of ``toks``, teacher-forced."""
        out = []
        for i, t in enumerate(toks):
            h, _ = quant_llama_forward(
                qp, llm, quant_embed(qp, torch.tensor([[t]], device=dev),
                                     llm.vocab_size),
                ones, torch.tensor([[pos0 + i]], device=dev), cache)
            out.append(quant_logits(qp, h)[0, -1].float())
        return out

    def chunked(emb, valid, pos, last, slot_shift, rope_shift):
        """The chunked prefill with the fault -> (first logits, cache)."""
        n = last // CHUNK + 1
        pad = n * CHUNK - emb.shape[1]
        emb = torch.nn.functional.pad(emb, (0, 0, 0, max(pad, 0)))
        valid = torch.nn.functional.pad(valid, (0, max(pad, 0)))
        pos = torch.nn.functional.pad(pos, (0, max(pad, 0)))
        # a late chunk's writes end one slot past the engine's chunk cache
        cache = make_quant_kv_cache(
            llm, 1, -(-MAX_LEN // CHUNK) * CHUNK + max(slot_shift, 0),
            device=dev)
        for ci in range(n):
            s = slice(ci * CHUNK, ci * CHUNK + CHUNK)
            late = ci > 0
            cache['index'] = torch.tensor(ci * CHUNK + late * slot_shift,
                                          device=dev)
            h, _ = quant_llama_forward(qp, llm, emb[:, s], valid[:, s],
                                       pos[:, s] + late * rope_shift, cache,
                                       chunked=True)
        local = last - (n - 1) * CHUNK
        first = quant_logits(qp, h[:, local:local + 1])[0, -1].float()
        cache['index'] = last + 1
        return first, cache

    rng = np.random.default_rng(args.seed + 60)
    worst = {name: [0.0, 0.0] for name, _, _ in FAULTS}
    for r in range(args.requests):
        pixels = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        t = expand_request(worker.tokenizer, spec,
                           {'prompt': PROMPT.format(ORDINALS[r])})
        with torch.inference_mode():
            image = torch.as_tensor(normalize(pixels)[None], device=dev)
            ids, slot, valid0 = (torch.as_tensor(t[k][None], device=dev)
                                 for k in ('input_ids', 'region_slot',
                                           'valid'))
            emb, _, valid, _ = model.prepare_stream(image, ids.long(),
                                                    slot.long(), valid0)
            pos = (torch.cumsum(valid.long(), -1) - 1).clamp(min=0)
            last = int(valid[0].nonzero()[-1])
            pos0 = int(pos[0, last]) + 1
            one = make_quant_kv_cache(llm, 1, MAX_LEN, device=dev)
            h, _ = quant_llama_forward(qp, llm, emb, valid, pos, one)
            first = quant_logits(qp, h[:, last:last + 1])[0, -1].float()
            toks = [int(first.argmax())]
            ref = [first]
            for i in range(NEW - 1):
                ref += decode(one, pos0 + i, toks[i:i + 1])
                toks.append(int(ref[-1].argmax()))
            for name, slot_shift, rope_shift in FAULTS:
                got_first, cache = chunked(emb, valid, pos, last, slot_shift,
                                           rope_shift)
                got = decode(cache, pos0, toks[:-1])
                rel = ((got_first - first).abs().max()
                       / first.abs().max()).item()
                diffs = sorted((g - w).abs().max().item()
                               for g, w in zip(got, ref[1:]))
                worst[name] = [max(worst[name][0], rel),
                               max(worst[name][1], diffs[-1])]
                print(f'request {r} {name}: first logits |chunked - '
                      f'one-shot| {rel:.4e} of max|one-shot|; decoded '
                      f'positions 1..{NEW - 1} |chunked - one-shot| max '
                      f'{diffs[-1]:.4e}, median {diffs[len(diffs) // 2]:.4e}')
    for name, (rel, diff) in worst.items():
        print(f'{name}, over {args.requests} requests: first logits '
              f'{rel:.4e} of max|one-shot|, decoded positions {diff:.4e}')


if __name__ == '__main__':
    main()
