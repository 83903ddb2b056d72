"""Interactive grounded chat on one image (counterpart of
``groma_tpu/serve/cli.py``): each line read from stdin is a user turn, the
answer is printed with the boxes its ``<rK>`` tokens name, and the turn
joins the history.  An empty line or the end of input ends the session.

    python -m groma_tpu_torch.serve.cli --model-dir <dir> --image-file img.png
    echo 'Locate the dog.' | python -m groma_tpu_torch.serve.cli \\
        --model-dir tiny --image-file img.png --device cpu

The LLM is the unquantized one through ``Generator``, as in JAX.
``--model-dir tiny`` (or ``random``: the full config) runs random weights
with the stub tokenizer.  It runs on the card; ``--device cpu`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model-dir', required=True,
                    help="checkpoint directory, or 'tiny' / 'random'")
    ap.add_argument('--image-file', required=True)
    ap.add_argument('--tokenizer', default=None)
    ap.add_argument('--max-new-tokens', type=int, default=64,
                    help='at most 64: the cache holds max_seq_len + 64 '
                         'slots')
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    a = ap.parse_args(argv)

    from groma_tpu_torch.checkpoint.loader import load_unquantized
    from groma_tpu_torch.data.conversation import conv_templates
    from groma_tpu_torch.data.datasets.base import (VLDataSpec,
                                                    intro_conversation)
    from groma_tpu_torch.data.image_pipeline import (load_image, normalize,
                                                     resize)
    from groma_tpu_torch.data.tokenization import expand_template
    from groma_tpu_torch.data.tokenizer import StubTokenizer, load_tokenizer
    from groma_tpu_torch.eval.generate import Generator, parse_region_tokens

    model, cfg = load_unquantized(a.model_dir, device=a.device)
    if a.model_dir in ('tiny', 'random'):
        tokenizer = StubTokenizer(cfg.llm.vocab_size, cfg.max_seq_len)
    else:
        tokenizer = load_tokenizer(a.tokenizer or a.model_dir,
                                   cfg.max_seq_len)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    img, _ = resize(load_image(a.image_file), (spec.image_size,) * 2)
    img = normalize(img)
    gen = Generator(model, max_len=cfg.max_seq_len + 64)
    conv = conv_templates['llava']
    history = intro_conversation(conv)

    while True:
        try:
            query = input('USER: ')
        except EOFError:
            break
        if not query.strip():
            break
        messages = history + [(conv.roles[0], query), (conv.roles[1], None)]
        ids = tokenizer.encode(conv.get_prompt(messages))
        t = expand_template(ids, None, tokenizer.sp, spec.num_image_tokens,
                            spec.max_region_num, spec.max_seq_len)
        tokens, vis = gen.generate(
            img[None], t['input_ids'][None], t['region_slot'][None],
            t['valid'][None], max_new_tokens=a.max_new_tokens,
            eos_id=tokenizer.sp.eos)
        text = tokenizer.decode([tok for tok in tokens[0]
                                 if tok != tokenizer.sp.eos])
        ks = parse_region_tokens(tokens, tokenizer.sp.box_idx_start)[0]
        print(f'ASSISTANT: {text}')
        if ks:
            cap = vis['selected_mask'].shape[1]
            boxes = [vis['selected_boxes'][0, k].tolist() for k in ks
                     if k < cap and vis['selected_mask'][0, k]]
            print(f'  grounded boxes (cxcywh): {boxes}')
        messages[-1] = (conv.roles[1], text)
        history = messages


if __name__ == '__main__':
    main()
