"""CLI: write a Groma checkpoint in the reference's HF layout (counterpart
of ``groma_tpu/checkpoint/export_hf.py``).

    python -m groma_tpu_torch.checkpoint.export_hf --ckpt CKPT_DIR \\
        --out groma.safetensors
    python -m groma_tpu_torch.checkpoint.export_hf --ckpt tiny --out DIR

``--ckpt`` is a reference-format checkpoint directory, read by
``checkpoint.loader.load_groma`` (the ViT position table at the deploy
grid), or 'tiny' / 'random' for random weights (seed 0) at the tiny or the
full-width config.  The port's modules carry the reference's
names, so their f32 state dict is the export.  An ``--out`` ending in
``.safetensors`` gets one file; any other path becomes a directory with
``config.json`` (``hf_export.export_config``) and ``model.safetensors``,
which ``load_groma`` reads back.  The JAX package's orbax input is not
ported (the port saves ``checkpoint-N.pt``).  It runs on the CPU: nothing
here computes.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ckpt', required=True,
                    help="checkpoint directory, or 'tiny' / 'random'")
    ap.add_argument('--out', required=True,
                    help='output .safetensors path, or a directory (no '
                         '.safetensors suffix) for config.json + weights')
    args = ap.parse_args(argv)

    import json
    import os

    from groma_tpu_torch.checkpoint.hf_export import (export_config,
                                                      save_safetensors)
    from groma_tpu_torch.checkpoint.loader import (load_groma,
                                                   random_groma_full)
    from groma_tpu_torch.config import GromaConfig, tiny_groma_config

    if args.ckpt in ('tiny', 'random'):
        cfg = tiny_groma_config() if args.ckpt == 'tiny' else GromaConfig()
        model = random_groma_full(cfg)
    else:
        model, cfg = load_groma(args.ckpt, 'cpu', full_precision=True)
    # the modules carry the reference's names: their state dict is the
    # export
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    if not args.out.endswith('.safetensors'):
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'config.json'), 'w') as f:
            json.dump(export_config(cfg), f, indent=1)
        save_safetensors(sd, os.path.join(args.out, 'model.safetensors'))
        print(f'wrote HF checkpoint dir {args.out} '
              f'(config.json + model.safetensors)')
        return sd
    save_safetensors(sd, args.out)
    n = sum(v.size for v in sd.values())
    print(f'wrote {args.out}: {len(sd)} tensors, {n / 1e6:.1f}M params')
    return sd


if __name__ == '__main__':
    main()
