"""VL-stage training entry point, stages 2 and 3 (counterpart of
``groma_tpu/train/train_vl.py``).

    python -m groma_tpu_torch.train.train_vl --llm VICUNA_DIR \\
        --perceiver PERCEIVER_DIR --dataset_config CFG.py --output_dir OUT \\
        --freeze_perceiver True --freeze_llm True ...

The model is composed from ``--llm`` + ``--perceiver`` checkpoint
directories, or loaded whole from ``--model_name_or_path``; the data comes
through the port's copy of the host-side pipeline (datasets, source-grouped
sampler, threaded loader, ``collate_vl``); AdamW on a warmup-cosine
schedule with the freeze switches; gradient accumulation; the step as
CUDA graphs on the card (``train/steps.py``; ``step_mode`` printed once);
checkpoints with
``torch.save`` every ``--save_steps`` updates and automatic resume from the
newest one in ``--output_dir``; at the end, the weights under the
reference's state-dict names (``pytorch_model.bin`` + ``config.json``),
which ``groma_tpu_torch.checkpoint.loader.load_groma`` reads back.

Boolean flags take ``True``/``False`` strings, as the reference's
HfArgumentParser parses them.  ``--gradient_checkpointing`` is accepted and
has no effect, as in the JAX package.  ``--tokenizer stub`` selects the
deterministic word-hash tokenizer of smoke runs.  Training runs on the
card; ``--device cpu`` runs it on the CPU (without a CUDA device, nothing
else starts).

Across processes, as JAX's ``--dp`` / ``--tp`` mesh:

    torchrun --nproc_per_node 8 -m groma_tpu_torch.train.train_vl \
        --dp 2 --tp 2 ...     # 2 replicas of 2 FSDP shards of 2 tp ranks

``parallel/mesh.py``: the LLaMA trunk's linears, embedding tables and
heads cut over tp (JAX's ``_TP_RULES`` / ``_VOCAB_RULES``, each rank
computing on its own heads and columns), then FSDP over the (dp, fsdp)
sub-mesh, fsdp the rest of the ranks, each LLaMA decoder layer and DINOv2
layer a unit; ``--per_device_train_batch_size`` is the GLOBAL batch, as in
JAX, each data rank (dp x fsdp of them; the tp ranks of one share its
rows) taking a contiguous 1/world slice of it; checkpoints hold the whole
state (written by rank 0) and resume at any (dp, fsdp, tp).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

CKPT_RE = re.compile(r'^checkpoint-(\d+)\.pt$')


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ('true', 't', 'yes', 'y', '1'):
        return True
    if s in ('false', 'f', 'no', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got {v!r}')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # model composition
    ap.add_argument('--model_name_or_path', default=None,
                    help='full Groma checkpoint directory')
    ap.add_argument('--llm', default=None, help='vicuna checkpoint dir')
    ap.add_argument('--perceiver', default=None,
                    help='det-pretrained perceiver checkpoint dir')
    ap.add_argument('--tokenizer', default=None)
    ap.add_argument('--nms_thres', type=float, default=0.6)
    ap.add_argument('--box_score_thres', type=float, default=0.15)
    ap.add_argument('--max_region_num', type=int, default=100)
    ap.add_argument('--freeze_perceiver', type=str2bool, default=True)
    ap.add_argument('--freeze_llm', type=str2bool, default=False)
    # training
    ap.add_argument('--dataset_config', required=True)
    ap.add_argument('--output_dir', required=True)
    ap.add_argument('--num_train_epochs', type=float, default=1)
    ap.add_argument('--per_device_train_batch_size', type=int, default=2)
    ap.add_argument('--gradient_accumulation_steps', type=int, default=1)
    ap.add_argument('--learning_rate', type=float, default=1e-4)
    ap.add_argument('--weight_decay', type=float, default=0.0)
    ap.add_argument('--warmup_ratio', type=float, default=0.03)
    ap.add_argument('--model_max_length', type=int, default=2048)
    ap.add_argument('--logging_steps', type=int, default=1)
    ap.add_argument('--save_steps', type=int, default=2500)
    ap.add_argument('--save_total_limit', type=int, default=1)
    ap.add_argument('--gradient_checkpointing', type=str2bool, default=False,
                    help='accepted; no effect yet')
    ap.add_argument('--use_flash_attention', type=str2bool, default=True)
    ap.add_argument('--dataloader_num_workers', type=int, default=8)
    ap.add_argument('--dp', type=int, default=1,
                    help='data-parallel replicas; the other ranks shard')
    ap.add_argument('--tp', type=int, default=1,
                    help='tensor-parallel ranks of each data rank')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to train on the "
                         "CPU)")
    return ap.parse_args(argv)


def compose_model(args, device):
    """-> (GromaModel with f32 master weights on ``device``, cfg): a whole
    checkpoint, or a random model with the LLM and perceiver checkpoints
    loaded into it; the bridge, region encoder and extra head stay random,
    the new-token embeddings start at the mean base embedding."""
    import torch

    from groma_tpu_torch.checkpoint.hf_import import (load_config_json,
                                                      load_state_dict,
                                                      resize_vit_pos_embed)
    from groma_tpu_torch.checkpoint.loader import (hf_groma_config,
                                                   load_groma,
                                                   random_groma_full)

    if args.model_name_or_path:
        return load_groma(args.model_name_or_path, device,
                          full_precision=True)
    if not (args.llm and args.perceiver):
        raise SystemExit('need --model_name_or_path, or --llm and '
                         '--perceiver')
    perc_cfg_d = load_config_json(args.perceiver)
    cfg = hf_groma_config({
        'llm_cfg': load_config_json(args.llm),
        'perceiver_cfg': perc_cfg_d if 'vis_encoder_cfg' in perc_cfg_d
        else {'vis_encoder_cfg': perc_cfg_d.get('vis_encoder_cfg', {}),
              'ddetr_cfg': perc_cfg_d.get('ddetr_cfg', {})},
        'nms_thres': args.nms_thres,
        'box_score_thres': args.box_score_thres,
        'max_region_num': args.max_region_num,
    })
    model = random_groma_full(cfg, seed=args.seed, device=device)
    # both checkpoints carry the reference's names, which the port's
    # modules keep; the ViT position table is resized to the deploy grid
    pc = cfg.perceiver
    perc = resize_vit_pos_embed(load_state_dict(args.perceiver),
                                'vis_encoder.embeddings.position_embeddings',
                                pc.image_size // pc.vit.patch_size)
    sd = {f'llm.{k}': v for k, v in load_state_dict(args.llm).items()}
    sd.update({f'perceiver.{k}': v for k, v in perc.items()})
    own = model.state_dict()
    missing = [k for k in own if k.startswith(('llm.', 'perceiver.'))
               and k not in sd]
    if missing:
        raise ValueError(f'checkpoints lack {missing[:5]} ...')
    with torch.no_grad():
        for k, v in sd.items():
            if k in own:
                own[k].copy_(torch.as_tensor(v))
        emb = model.llm.model.embed_tokens.weight
        model.new_input_embs.weight.copy_(
            emb.mean(0, keepdim=True).expand_as(model.new_input_embs.weight))
    return model, cfg


# ------------------------------------------------------------ checkpoints

def _checkpoints(output_dir: str):
    found = []
    if os.path.isdir(output_dir):
        for name in os.listdir(output_dir):
            m = CKPT_RE.match(name)
            if m:
                found.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(found)


def save_checkpoint(output_dir, step, model, optimizer, cfg, keep: int,
                    generator=None):
    """Model, optimizer and (if given) generator state at ``step``
    (torch.save, written to a temporary name and renamed; kept as it is when
    ``step`` has one already); keeps the newest ``keep``.  Sharded state
    is gathered whole first and rank 0 writes it: every rank calls this."""
    import torch

    from groma_tpu_torch.parallel.mesh import (full_state_dicts,
                                               rank_and_world)
    msd, osd = full_state_dicts(model, optimizer)
    if rank_and_world()[0] != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f'checkpoint-{step}.pt')
    if os.path.exists(path):
        return
    ck = {'step': step, 'model': msd, 'optimizer': osd,
          'config': cfg.to_dict()}
    if generator is not None:
        ck['generator'] = generator.get_state()
    torch.save(ck, path + '.tmp')
    os.replace(path + '.tmp', path)
    for _, old in _checkpoints(output_dir)[:-max(keep, 1)]:
        os.remove(old)


def maybe_resume(output_dir, model, optimizer, generator=None) -> int:
    """Load the newest checkpoint in ``output_dir``, if any -> its step;
    a model and optimizer sharded over any number of ranks take their
    shards of it (every rank calls this)."""
    import torch

    from groma_tpu_torch.parallel.mesh import load_full_state_dicts
    found = _checkpoints(output_dir)
    if not found:
        return 0
    ck = torch.load(found[-1][1], map_location='cpu', weights_only=True)
    load_full_state_dicts(model, optimizer, ck['model'], ck['optimizer'])
    if generator is not None:
        generator.set_state(ck['generator'])
    return ck['step']


def export_weights(output_dir, model, config: dict):
    """The weights under the reference's state-dict names, f32, with
    ``config`` (the reference-format config) as config.json; gathered
    whole where sharded, and written by rank 0 (every rank calls this)."""
    import torch

    from groma_tpu_torch.parallel.mesh import full_model_state, rank_and_world
    sd = full_model_state(model)
    if rank_and_world()[0] != 0:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, 'config.json'), 'w') as f:
        json.dump(config, f, indent=1)
    torch.save({k: v.detach().float().cpu() for k, v in sd.items()},
               os.path.join(output_dir, 'pytorch_model.bin'))


# ------------------------------------------------------------------- main

def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from groma_tpu_torch.checkpoint.hf_export import export_config
    from groma_tpu_torch.checkpoint.loader import resolve_device
    # host-side data pipeline (PIL): imported here, not by the module
    from groma_tpu_torch.data.build import (SourceGroupedBatchSampler,
                                            build_multi_datasets, collate_vl)
    from groma_tpu_torch.data.datasets.base import VLDataSpec
    from groma_tpu_torch.data.loader import DataLoader
    from groma_tpu_torch.data.tokenizer import StubTokenizer, load_tokenizer
    from groma_tpu_torch.parallel.mesh import (RankBatches, init_distributed,
                                               make_mesh, rank_and_world,
                                               shard_model)
    from groma_tpu_torch.train.optimizer import (cosine_schedule,
                                                 freeze_predicate, make_adamw)
    from groma_tpu_torch.train.steps import batch_to, make_vl_train_step
    from groma_tpu_torch.utils.logging import print0

    device = resolve_device(args.device)
    init_distributed(device)
    mesh = make_mesh(dp=args.dp, tp=args.tp, device_type=torch.device(
        device).type)
    _, world = rank_and_world()
    torch.manual_seed(args.seed)
    model, cfg = compose_model(args, device)
    cfg = cfg.replace(max_seq_len=args.model_max_length)
    if args.tokenizer == 'stub':
        tokenizer = StubTokenizer(base_vocab=cfg.llm.vocab_size,
                                  model_max_length=args.model_max_length)
    else:
        tokenizer = load_tokenizer(args.tokenizer or args.llm
                                   or args.model_name_or_path,
                                   model_max_length=args.model_max_length)
    spec = VLDataSpec(num_image_tokens=cfg.num_image_tokens,
                      max_region_num=cfg.max_region_num,
                      max_seq_len=cfg.max_seq_len,
                      image_size=cfg.perceiver.image_size)
    dataset = build_multi_datasets(args.dataset_config, tokenizer=tokenizer,
                                   spec=spec)
    sampler = RankBatches(SourceGroupedBatchSampler(
        dataset, args.per_device_train_batch_size, seed=args.seed),
        *rank_and_world(getattr(mesh, 'data_group', None)))
    loader = DataLoader(dataset, sampler, collate_vl,
                        num_workers=args.dataloader_num_workers)
    accum = args.gradient_accumulation_steps
    steps_per_epoch = max(len(sampler) // accum, 1)
    total_steps = int(steps_per_epoch * args.num_train_epochs)

    if mesh is not None:
        shard_model(model, mesh)
    optimizer = make_adamw(
        model, cosine_schedule(args.learning_rate, total_steps,
                               warmup_ratio=args.warmup_ratio),
        weight_decay=args.weight_decay,
        frozen_pred=freeze_predicate(freeze_perceiver=args.freeze_perceiver,
                                     freeze_llm=args.freeze_llm),
        accum_steps=accum)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    start_step = maybe_resume(args.output_dir, model, optimizer, generator)
    if start_step:
        print0(f'resumed from step {start_step}', flush=True)
    n_train = sum(p.numel() for p in optimizer.params)
    n_all = sum(p.numel() for p in model.parameters())
    print0(f'{n_train} of {n_all} parameters train; {total_steps} steps on '
           f'{device}' + (f' x {world} ranks' if world > 1 else ''),
           flush=True)

    step_fn = make_vl_train_step(model, optimizer,
                                 use_flash=args.use_flash_attention)
    print0(f'step_mode {step_fn.mode}', flush=True)
    micro = start_step * accum
    step = start_step
    t0 = time.time()
    for epoch in range(int(np.ceil(args.num_train_epochs))):
        sampler.set_epoch(epoch)
        for batch in loader:
            step = micro // accum
            if step >= total_steps:
                break
            # host tensors: the step copies them in through pinned memory
            metrics = step_fn(batch_to(batch, 'cpu'), generator)
            micro += 1
            step = micro // accum
            if micro % (args.logging_steps * accum) == 0:
                dt = (time.time() - t0) / args.logging_steps
                print0(f'step {step}/{total_steps} loss '
                       f'{float(metrics["loss"]):.4f} lr {optimizer.lr:.3e} '
                       f'({dt:.2f} s/step)', flush=True)
                t0 = time.time()
            if metrics['updated'] and step % args.save_steps == 0:
                save_checkpoint(args.output_dir, step, model, optimizer,
                                cfg, args.save_total_limit, generator)
        if step >= total_steps:
            break
    save_checkpoint(args.output_dir, total_steps, model, optimizer, cfg,
                    args.save_total_limit, generator)
    export_weights(args.output_dir, model, export_config(cfg))
    print0('training complete', flush=True)


if __name__ == '__main__':
    main()
