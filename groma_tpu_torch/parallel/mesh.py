"""Training across processes on ``torch.distributed`` (counterpart of
``groma_tpu/parallel/mesh.py``).

The JAX package lays one ``Mesh`` with axes (dp, fsdp, tp) over its devices
and lets GSPMD insert the collectives; the reference trains with torchrun
and FSDP.  Here:

* launch: ``discover_launch_env`` (a copy: torchrun's RANK / WORLD_SIZE /
  MASTER_ADDR first, then SLURM, then JAX's coordinator variables) and
  ``init_distributed`` (``init_process_group``: NCCL on the card, gloo on
  the CPU; nothing in a single process);
* mesh: ``make_mesh(dp, fsdp, tp)``, a ``DeviceMesh`` with axes ('dp',
  'fsdp'), ``fsdp`` "everything else" as in JAX.  ``tp > 1`` raises:
  tensor parallelism (JAX's ``_TP_RULES`` / ``_VOCAB_RULES``) waits for
  ROADMAP.md §1 item 11b;
* parameters: ``shard_model`` wraps each ``LlamaDecoderLayer`` and each
  DINOv2 layer (the reference's FSDP units, ``scripts/fsdp_config.json``),
  then the root, in PyTorch's FSDP (``fully_shard``) over the mesh:
  replicated over dp and sharded over fsdp, which is HSDP with both above
  1 and plain data parallelism at fsdp 1.  Every parameter is a DTensor;
  gradients are averaged over all dp x fsdp ranks;
* data: JAX's batch is global (its sampler yields the whole batch and the
  mesh splits it over (dp, fsdp)), so ``RankBatches`` hands each rank a
  contiguous 1/world slice of every global batch, and a batch that does
  not divide is refused; a W-rank run reads the batches of a 1-rank one;
* losses: JAX's step is one program over the global batch, so the steps
  (``train/steps.py``) divide by the global token and box counts
  (``all_reduce_sum``), and AdamW clips by the global gradient norm;
* checkpoints: ``full_state_dicts`` gathers the model's and the
  optimizer's state whole (rank 0 writes ``checkpoint-N.pt`` as a single
  process would), and ``load_full_state_dicts`` cuts a whole state back to
  this rank's shards, so a checkpoint resumes on any number of ranks.

JAX's ``constrain`` (a sharding hint, a no-op outside a mesh) has no
counterpart on this path.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional

import torch
import torch.distributed as dist

TP_ITEM = 'ROADMAP.md §1 item 11b'


def discover_launch_env(env) -> Optional[dict]:
    """Launch coordinates from the environment, with the reference's
    precedence: torchrun's env:// (RANK / WORLD_SIZE /
    MASTER_ADDR[:MASTER_PORT]), then SLURM (SLURM_PROCID / SLURM_NTASKS and
    a coordinator host), then COORDINATOR_ADDRESS.  None in a single
    process (no variable set)."""
    if 'RANK' in env and 'WORLD_SIZE' in env:
        addr = env.get('MASTER_ADDR', '127.0.0.1')
        port = env.get('MASTER_PORT', '8476')
        return {'coordinator_address': f'{addr}:{port}',
                'num_processes': int(env['WORLD_SIZE']),
                'process_id': int(env['RANK'])}
    if 'SLURM_PROCID' in env and 'SLURM_NTASKS' in env:
        addr = (env.get('MASTER_ADDR')
                or env.get('SLURM_LAUNCH_NODE_IPADDR'))
        if addr is None and env.get('SLURM_NODELIST'):
            # the allocation's first host name
            addr = re.split(r'[\[,]', env['SLURM_NODELIST'])[0]
        port = env.get('MASTER_PORT', '8476')
        return {'coordinator_address': f'{addr}:{port}',
                'num_processes': int(env['SLURM_NTASKS']),
                'process_id': int(env['SLURM_PROCID'])}
    if 'COORDINATOR_ADDRESS' in env:
        return {'coordinator_address': env['COORDINATOR_ADDRESS'],
                'num_processes': int(env['JAX_NUM_PROCESSES'])
                if 'JAX_NUM_PROCESSES' in env else None,
                'process_id': int(env['JAX_PROCESS_ID'])
                if 'JAX_PROCESS_ID' in env else None}
    return None


def init_distributed(device: str = 'cuda', init_method: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the process group: NCCL for a CUDA ``device``, gloo for the
    CPU.  Explicit arguments win (``init_method`` a ``tcp://`` or
    ``file://`` address); otherwise the coordinates come from
    ``discover_launch_env``.  Returns False, and does nothing, in a single
    process; True once a group is up (also when it already was).  On the
    card each process takes ``cuda:LOCAL_RANK`` (torchrun's; SLURM's
    SLURM_LOCALID) as its current device."""
    if dist.is_initialized():
        return True
    if init_method is None:
        found = discover_launch_env(os.environ)
        if found is None:
            return False
        init_method = f"tcp://{found['coordinator_address']}"
        num_processes = found['num_processes']
        process_id = found['process_id']
    cuda = str(device).startswith('cuda')
    if cuda:
        local = os.environ.get('LOCAL_RANK', os.environ.get('SLURM_LOCALID'))
        torch.cuda.set_device(int(local) if local is not None else 0)
    dist.init_process_group('nccl' if cuda else 'gloo',
                            init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def rank_and_world() -> tuple:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
              device_type: str = 'cuda'):
    """A ``DeviceMesh`` of shape (dp, fsdp) with axes ('dp', 'fsdp') over
    the process group's ranks; ``fsdp`` defaults to world // dp.  None in
    a single process without a group (dp and fsdp must then be 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    if tp != 1:
        raise ValueError(f'--tp {tp}: tensor parallelism is not ported; it '
                         f'waits for {TP_ITEM}')
    _, world = rank_and_world()
    if fsdp is None:
        fsdp = max(world // max(dp, 1), 1)
    if dp < 1 or dp * fsdp != world:
        raise ValueError(f'mesh dp {dp} x fsdp {fsdp} != {world} process(es)'
                         f'{"" if world > 1 else ": launch with torchrun"}')
    if not dist.is_initialized():
        return None
    return init_device_mesh(device_type, (dp, fsdp),
                            mesh_dim_names=('dp', 'fsdp'))


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``fully_shard`` each LLaMA decoder layer and DINOv2 layer of
    ``model``, then ``model`` itself (the other parameters), over
    ``mesh``; in place.  Build the optimizer after this: the parameters
    are replaced by DTensors."""
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:                 # PyTorch before 2.6
        from torch.distributed._composable.fsdp import fully_shard

    from groma_tpu_torch.models.dinov2 import Dinov2Layer
    from groma_tpu_torch.models.llama import LlamaDecoderLayer
    # FSDP shards contiguous parameters only (a loaded transpose is not)
    for p in model.parameters():
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    for m in model.modules():
        if isinstance(m, (LlamaDecoderLayer, Dinov2Layer)):
            fully_shard(m, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


class RankBatches:
    """This rank's contiguous 1/world slice of each global batch of
    ``batches`` (index lists; ``set_epoch`` and ``len`` pass through to a
    sampler)."""

    def __init__(self, batches: Iterable, rank: int, world: int):
        self.batches, self.rank, self.world = batches, rank, world

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch: int):
        self.batches.set_epoch(epoch)

    def __iter__(self):
        for idx in self.batches:
            idx = list(idx)
            if len(idx) % self.world:
                raise ValueError(f'a batch of {len(idx)} does not divide '
                                 f'over {self.world} ranks')
            n = len(idx) // self.world
            yield idx[self.rank * n:(self.rank + 1) * n]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the process group, in place (``t`` itself
    without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t)
    return t


def _dtensor():
    """(DTensor, distribute_tensor) of this PyTorch."""
    try:
        from torch.distributed.tensor import DTensor, distribute_tensor
    except ImportError:                 # PyTorch before 2.5
        from torch.distributed._tensor import DTensor, distribute_tensor
    return DTensor, distribute_tensor


def _full(v):
    DTensor, _ = _dtensor()
    return v.full_tensor() if isinstance(v, DTensor) else v


def full_model_state(model) -> dict:
    """``model.state_dict()`` with every sharded tensor gathered whole; a
    collective: every rank calls it."""
    return {k: _full(v) for k, v in model.state_dict().items()}


def full_state_dicts(model, optimizer) -> tuple:
    """(model state, ``optimizer.state_dict()``) with every sharded
    tensor gathered whole, as a single process holds them; a collective:
    every rank calls it."""
    msd = full_model_state(model)
    osd = optimizer.state_dict()
    opt = osd['opt']
    opt['state'] = {i: {k: _full(v) for k, v in st.items()}
                    for i, st in opt['state'].items()}
    return msd, osd


def _shard_like(ref, full):
    """``full`` as a tensor laid out as ``ref`` (a DTensor: this rank's
    shard of it; a plain tensor: itself, on ref's device)."""
    DTensor, distribute_tensor = _dtensor()
    if isinstance(ref, DTensor):
        return distribute_tensor(full.to(ref.device, ref.dtype),
                                 ref.device_mesh, ref.placements)
    return full.to(ref.device)


@torch.no_grad()
def load_full_state_dicts(model, optimizer, msd: dict, osd: dict):
    """Load whole (unsharded) states, as ``full_state_dicts`` gives them
    or a single process saved them, into a model and optimizer that may be
    sharded; a collective where they are."""
    DTensor, _ = _dtensor()
    own = model.state_dict()
    if own.keys() != msd.keys():
        raise ValueError('checkpoint and model differ in their keys: '
                         f'{sorted(own.keys() ^ msd.keys())[:5]}')
    for k, t in own.items():
        part = _shard_like(t, msd[k])
        (t.to_local() if isinstance(t, DTensor) else t).copy_(
            part.to_local() if isinstance(part, DTensor) else part)
    params = [p for g in optimizer.opt.param_groups for p in g['params']]
    opt = dict(osd['opt'])
    opt['state'] = {i: {k: v if k == 'step' else _shard_like(params[i], v)
                        for k, v in st.items()}
                    for i, st in osd['opt']['state'].items()}
    optimizer.load_state_dict({**osd, 'opt': opt})
