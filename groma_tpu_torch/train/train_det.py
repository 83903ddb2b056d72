"""Detection-pretrain entry point, stage 1 (counterpart of
``groma_tpu/train/train_det.py``).

    python -m groma_tpu_torch.train.train_det \\
        --dataset_config groma_tpu_torch/data/configs/det_pretrain.py \\
        --output_dir OUT --vis_encoder DINOV2_DIR

The Perceiver (DINOv2-L + the two-stage DDETR head) at JAX's widths from
the flags, random weights from a seeded ``torch.Generator`` and, with
``--vis_encoder``, DINOv2 from a HF checkpoint directory; AdamW on a
warmup-cosine schedule with 0.1x learning rates on the ViT and the
sampling offsets, the ViT frozen by default; the class-agnostic two-stage
DDETR losses over Hungarian matches; source-grouped batches, each source
supervising its objectness head (``coco``, ``sa1b``; other sources
``coco``); on the card each head's step runs as CUDA graphs
(``train/steps.py``; ``step_mode`` printed once a head).  Checkpoints
(``checkpoint-N.pt``: model and optimizer) every epoch or every
``--save_steps`` steps by ``--save_strategy``, the newest
``--save_total_limit`` kept, and automatic resume from the newest one, at
the batch after the last one it trained on.  At the end the weights under
the reference's names (``pytorch_model.bin`` + the reference's
``perceiver_cfg`` as ``config.json``), which ``eval/run_ddetr --model-dir``
and ``train_vl --perceiver`` read.

Boolean flags take ``True``/``False`` strings.  Training runs on the card;
``--device cpu`` runs it on the CPU.  Across processes
(``torchrun --nproc_per_node N``), as in ``train_vl``: FSDP over a (``--dp``,
the rest) mesh (``parallel/mesh.py``), the ViT's layers as units; the batch
global, each rank a contiguous 1/N slice of it; the losses normalized by
the global box count and clipped by the global gradient norm.  ``--tp``
is accepted as JAX's is: no detector parameter matches a tp rule, so the
Perceiver is replicated over the tp ranks of each data rank, which share
its batch slice, and FSDP shards it over the dp x fsdp data ranks.
"""

from __future__ import annotations

import argparse
import time

from groma_tpu_torch.train.train_vl import (export_weights, maybe_resume,
                                            save_checkpoint, str2bool)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # model
    ap.add_argument('--vis_encoder', default=None,
                    help='HF DINOv2 checkpoint directory (optional)')
    ap.add_argument('--num_queries', type=int, default=300)
    ap.add_argument('--ddetr_hidden_dim', type=int, default=256)
    ap.add_argument('--num_encoder_layers', type=int, default=6)
    ap.add_argument('--num_decoder_layers', type=int, default=6)
    ap.add_argument('--num_feature_levels', type=int, default=1)
    ap.add_argument('--two_stage', type=str2bool, default=True)
    ap.add_argument('--with_box_refine', type=str2bool, default=True)
    ap.add_argument('--num_classes', type=int, default=1)
    # training
    ap.add_argument('--dataset_config', required=True)
    ap.add_argument('--output_dir', required=True)
    ap.add_argument('--num_train_epochs', type=float, default=12)
    ap.add_argument('--per_device_train_batch_size', type=int, default=8)
    ap.add_argument('--learning_rate', type=float, default=2e-4)
    ap.add_argument('--weight_decay', type=float, default=1e-4)
    ap.add_argument('--max_grad_norm', type=float, default=1.0)
    ap.add_argument('--warmup_steps', type=int, default=100)
    ap.add_argument('--logging_steps', type=int, default=100)
    ap.add_argument('--save_strategy', default='epoch',
                    choices=('epoch', 'steps'))
    ap.add_argument('--save_steps', type=int, default=2500)
    ap.add_argument('--save_total_limit', type=int, default=1)
    ap.add_argument('--freeze_vis_encoder', type=str2bool, default=True)
    ap.add_argument('--lr_multiplier', type=float, default=0.1)
    ap.add_argument('--dataloader_num_workers', type=int, default=8)
    ap.add_argument('--dp', type=int, default=1)
    ap.add_argument('--tp', type=int, default=1)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda',
                    help="torch device (default cuda; 'cpu' to train on the "
                         "CPU)")
    return ap.parse_args(argv)


def perceiver_config(args):
    """The Perceiver at JAX's widths: DINOv2-L, the DDETR head from the
    flags."""
    from groma_tpu_torch.config import DDETRConfig, PerceiverConfig, ViTConfig
    return PerceiverConfig(vit=ViTConfig(), ddetr=DDETRConfig(
        d_model=args.ddetr_hidden_dim, num_queries=args.num_queries,
        encoder_layers=args.num_encoder_layers,
        decoder_layers=args.num_decoder_layers,
        num_feature_levels=args.num_feature_levels,
        num_labels=args.num_classes, two_stage=args.two_stage,
        with_box_refine=args.with_box_refine))


def load_vis_encoder(model, path: str):
    """A HF Dinov2Model checkpoint directory into ``model.vis_encoder``,
    the position table resized to the deploy grid."""
    import torch

    from groma_tpu_torch.checkpoint.hf_import import (load_state_dict,
                                                      resize_vit_pos_embed)
    sd = load_state_dict(path)
    prefix = 'vis_encoder.' if any(k.startswith('vis_encoder.')
                                   for k in sd) else ''
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    enc = model.vis_encoder
    sd = resize_vit_pos_embed(sd, 'embeddings.position_embeddings',
                              enc.image_size // enc.cfg.patch_size)
    own = enc.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(f'{path} lacks {missing[:5]} ...')
    enc.load_state_dict({k: torch.as_tensor(sd[k]).to(own[k])
                         for k in own}, strict=True)


# ------------------------------------------------------------------ train

def train(args, cfg, device: str) -> dict:
    """The training loop for the Perceiver at ``cfg``.  Returns {'step',
    'total_steps', 'losses' (each step's loss dict, floats),
    'step_seconds' (host clock, device synchronized), 'model',
    'step_modes' (each head's step mode)}."""
    import numpy as np
    import torch

    from groma_tpu_torch.checkpoint.loader import (perceiver_config_json,
                                                   random_perceiver)
    # host-side data pipeline: imported here, not by the module
    from groma_tpu_torch.data.build import (SourceGroupedBatchSampler,
                                            build_multi_datasets, collate_det)
    from groma_tpu_torch.data.loader import DataLoader
    from groma_tpu_torch.parallel.mesh import (RankBatches,
                                               init_distributed, make_mesh,
                                               rank_and_world, shard_model)
    from groma_tpu_torch.train.optimizer import (cosine_schedule,
                                                 det_lr_mult_rules,
                                                 freeze_predicate, make_adamw)
    from groma_tpu_torch.train.steps import det_batch_to, make_det_train_step
    from groma_tpu_torch.utils.logging import print0

    init_distributed(device)
    mesh = make_mesh(dp=args.dp, tp=args.tp,
                     device_type=torch.device(device).type)
    rank, world = rank_and_world(getattr(mesh, 'data_group', None))
    model = random_perceiver(cfg, seed=args.seed, device=device)
    if args.vis_encoder:
        load_vis_encoder(model, args.vis_encoder)
    if mesh is not None:
        shard_model(model, mesh)
    dataset = build_multi_datasets(args.dataset_config,
                                   image_size=cfg.image_size)
    sampler = SourceGroupedBatchSampler(
        dataset, args.per_device_train_batch_size, seed=args.seed)
    steps_per_epoch = len(sampler)
    total_steps = int(steps_per_epoch * args.num_train_epochs)

    optimizer = make_adamw(
        model, cosine_schedule(args.learning_rate, total_steps,
                               warmup_steps=args.warmup_steps),
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        lr_mult_rules=det_lr_mult_rules(args.lr_multiplier),
        frozen_pred=freeze_predicate(
            freeze_vis_encoder=args.freeze_vis_encoder))
    start_step = maybe_resume(args.output_dir, model, optimizer)
    if start_step:
        print0(f'resumed from step {start_step}', flush=True)
    n_train = sum(p.numel() for p in optimizer.params)
    n_all = sum(p.numel() for p in model.parameters())
    print0(f'{n_train} of {n_all} parameters train; {total_steps} steps of '
           f'{args.per_device_train_batch_size} on {device}'
           + (f' x {world} ranks' if world > 1 else ''), flush=True)

    step_fns = {}
    losses, seconds = [], []
    step = start_step
    t0 = time.time()
    for epoch in range(int(np.ceil(args.num_train_epochs))):
        if step >= total_steps:
            break
        # a resumed run skips the batches its checkpoint trained on
        done = step - epoch * steps_per_epoch
        if done >= steps_per_epoch:
            continue
        sampler.set_epoch(epoch)
        batches = list(RankBatches(list(sampler)[max(done, 0):], rank,
                                   world))
        loader = DataLoader(dataset, batches, collate_det,
                            num_workers=args.dataloader_num_workers)
        for batch in loader:
            if step >= total_steps:
                break
            source = batch.pop('source')
            head = source if source in ('coco', 'sa1b') else 'coco'
            if head not in step_fns:
                # one set of graphs per head, as JAX keeps one program per
                # source
                step_fns[head] = make_det_train_step(model, cfg.ddetr,
                                                     optimizer, head)
                print0(f'step_mode {step_fns[head].mode} ({head})',
                       flush=True)
            ts = time.perf_counter()
            # host tensors: the step copies them in through pinned memory
            metrics = step_fns[head](det_batch_to(batch, 'cpu'))
            metrics.pop('updated')
            # one read of every loss, after the replay
            metrics = dict(zip(metrics, torch.stack(
                list(metrics.values())).tolist()))
            seconds.append(time.perf_counter() - ts)
            losses.append(metrics)
            step += 1
            if step % args.logging_steps == 0:
                print0(f'step {step}/{total_steps} loss '
                       f'{metrics["loss"]:.4f} lr {optimizer.lr:.3e} '
                       f'({(time.time() - t0) / args.logging_steps:.2f} '
                       f's/step)', flush=True)
                t0 = time.time()
            if args.save_strategy == 'steps' and step % args.save_steps == 0:
                save_checkpoint(args.output_dir, step, model, optimizer, cfg,
                                args.save_total_limit)
        if args.save_strategy == 'epoch':
            save_checkpoint(args.output_dir, step, model, optimizer, cfg,
                            args.save_total_limit)
    save_checkpoint(args.output_dir, step, model, optimizer, cfg,
                    args.save_total_limit)
    export_weights(args.output_dir, model, perceiver_config_json(cfg))
    print0(f'done at step {step}', flush=True)
    if device.startswith('cuda'):
        torch.cuda.synchronize()
    return {'step': step, 'total_steps': total_steps, 'losses': losses,
            'step_seconds': seconds, 'model': model,
            'step_modes': {h: f.mode for h, f in step_fns.items()}}


def main(argv=None):
    args = parse_args(argv)
    from groma_tpu_torch.checkpoint.loader import resolve_device
    device = resolve_device(args.device)
    return train(args, perceiver_config(args), device)


if __name__ == '__main__':
    main()
