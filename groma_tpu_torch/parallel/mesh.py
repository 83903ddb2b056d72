"""Training and serving across processes on ``torch.distributed``
(counterpart of ``groma_tpu/parallel/mesh.py``).

The JAX package lays one ``Mesh`` with axes (dp, fsdp, tp) over its devices
and lets GSPMD insert the collectives; the reference trains with torchrun
and FSDP.  Here:

* launch: ``discover_launch_env`` (a copy: torchrun's RANK / WORLD_SIZE /
  MASTER_ADDR first, then SLURM, then JAX's coordinator variables) and
  ``init_distributed`` (``init_process_group``: by default NCCL on the
  card and gloo on the CPU, or the ``backend`` asked for; nothing in a
  single process);
* mesh: ``make_mesh(dp, fsdp, tp)``, a ``DeviceMesh`` with axes ('dp',
  'fsdp', 'tp'), tp innermost and ``fsdp`` "everything else", as in JAX.
  It also makes the mesh's two groups: ``mesh.data_group`` (the ranks of
  one tp index, dp x fsdp of them; None, the whole group, at tp = 1) and
  ``mesh.tp_group`` (the tp ranks of one data rank), which
  ``shard_model`` hands to the model.  The steps take their rank and world
  (``rank_and_world``) and their sums (``all_reduce_sum``) over the data
  group: the tp ranks of one data rank see the same rows, as in JAX, whose
  batch is sharded over ('dp', 'fsdp') only;
* layout: ``tp_placement`` is ``param_pspec``'s tp and vocab component
  for one parameter of the port.  JAX's ``_TP_RULES`` and
  ``_VOCAB_RULES`` (copied) run on JAX's path of the parameter
  (``jax_path``: the LLaMA trunk's linears, the embedding tables and the
  heads under the port's names, with or without ``llm.``, and the leaves
  of the quantized tree; no other parameter has a path here, so the
  detector's ``self_attn.q_proj`` stays whole, as JAX's
  ``self_attn_q`` does).  A torch ``Linear.weight`` is flax's kernel
  transposed, so a column-parallel rule cuts dim 0 here.  JAX's
  divisibility fallbacks are kept (a vocab dim that tp does not divide
  stays whole).  One departure: q/k/v/o_proj are cut only at whole heads
  (ROADMAP.md §3): where tp divides the columns but not the heads (GQA
  with fewer KV heads than tp), the projection stays whole on every rank
  and each rank takes its query heads' KV heads from it.  JAX's fsdp
  share of a placement is FSDP's own dim-0 shard here;
* parameters: ``shard_model`` first cuts each tp-placed parameter to this
  rank's slice (``cut_tp``: a plain tensor, recorded in
  ``model.tp_plan``: name -> dim, with the groups in ``model.tp_group``
  and ``model.data_group``, the tp group also set on the LLaMA modules and
  the heads, which then compute on their local heads and columns with
  ``tensor_parallel``'s operators), then wraps each
  ``LlamaDecoderLayer`` and DINOv2 layer (the reference's FSDP units,
  ``scripts/fsdp_config.json``), then the root, in PyTorch's FSDP
  (``fully_shard``) over the ('dp', 'fsdp') sub-mesh: replicated over dp
  and sharded over fsdp, which is HSDP with both above 1 and plain data
  parallelism at fsdp 1.  Gradients are averaged over the data group.  At
  tp = 1 every parameter becomes a DTensor, on one rank too; at tp > 1 a
  data group of one rank shards nothing and the parameters stay plain.
  A served model whose data ranks are replicas is cut by ``cut_tp``
  alone, and its quantized tree by ``cut_quant_tree`` (the compute cut,
  not JAX's storage placement: fused columns per part, an int4 MLP at
  whole scale blocks);
* data: JAX's batch is global (its sampler yields the whole batch and the
  mesh splits it over (dp, fsdp)), so ``RankBatches`` hands each data rank
  a contiguous 1/world slice of every global batch, and a batch that does
  not divide is refused; a W-rank run reads the batches of a 1-rank one;
* losses: JAX's step is one program over the global batch, so the steps
  (``train/steps.py``) divide by the global token and box counts
  (``all_reduce_sum``), and AdamW clips by the global gradient norm;
* checkpoints: ``full_state_dicts`` gathers the model's and the
  optimizer's state whole, FSDP's shards and then tp's (rank 0 writes
  ``checkpoint-N.pt`` as a single process would), and
  ``load_full_state_dicts`` cuts a whole state back to this rank's tp
  slice and FSDP shard, so a checkpoint resumes at any (dp, fsdp, tp).

JAX's ``constrain`` (a sharding hint, a no-op outside a mesh) has no
counterpart on this path.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from groma_tpu_torch.ops.quant4 import INT4_BLOCK

# Megatron-style tensor-parallel rules for the LLM, on JAX's parameter
# paths (copied from the JAX package).  Column-parallel kernels shard the
# output dim, row-parallel the input dim (flax's (in, out) layout).  The
# second group covers the weight-only-quantized tree (fused qkv / gate_up
# and per-column scales).
TP_RULES = [
    (r'(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel$', 1),
    (r'(o_proj|down_proj)/kernel$', 0),
    (r'(qkv_proj|gate_up_proj)/q$', 1),
    (r'(qkv_proj|gate_up_proj)/scale$', 0),
    (r'(o_proj|down_proj)/q$', 0),
    (r'lm_head/q$', 1),
    (r'lm_head/scale$', 0),
]
# vocab-dim parameters: that one dim over the combined (tp, fsdp) axes
VOCAB_RULES = [
    (r'(^|/)lm_head/kernel$', 1),
    (r'(^|/)extra_lm_head/kernel$', 1),
    (r'(^|/)embed_tokens$', 0),
    (r'(^|/)new_input_embs$', 0),
]
# the port's departure: attention projections are cut at whole heads only
_HEAD_PATHS = re.compile(r'(q_proj|k_proj|v_proj|o_proj)/kernel$')
_LLAMA_NAME = re.compile(
    r'^(?:llm\.)?model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+_proj)\.weight$')
_QUANT_NAME = re.compile(r'^(?:llm\.)?layers\.(\d+)\.(\w+_proj)\.(q|scale)$')
_FIXED_NAMES = {
    'model.embed_tokens.weight': 'embed_tokens',
    'llm.model.embed_tokens.weight': 'embed_tokens',
    'embed_tokens': 'embed_tokens',
    'lm_head.weight': 'lm_head/kernel',
    'llm.lm_head.weight': 'lm_head/kernel',
    'lm_head.q': 'lm_head/q',
    'lm_head.scale': 'lm_head/scale',
    'new_input_embs.weight': 'new_input_embs',
    'extra_lm_head.weight': 'extra_lm_head/kernel',
}


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
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group: ``backend``, or by default NCCL for a CUDA
    ``device`` and gloo for the CPU (gloo on the card carries the tp
    operators, which are all-reduces, between ranks that share one card).
    Explicit arguments win (``init_method`` a ``tcp://`` or ``file://``
    address); otherwise the coordinates come from
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
    dist.init_process_group(backend or ('nccl' if cuda else 'gloo'),
                            init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def grouped() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world(group=None) -> tuple:
    """(rank, size) in ``group`` (None: the whole process group); (0, 1)
    without a process group."""
    if grouped():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
              device_type: str = 'cuda'):
    """A ``DeviceMesh`` of shape (dp, fsdp, tp) with axes ('dp', 'fsdp',
    'tp') over the process group's ranks, tp innermost (rank = data rank
    x tp + tp rank); ``fsdp`` defaults to world // (dp x tp).  Its
    ``data_group`` and ``tp_group`` are this rank's (see the module
    docstring).  None in a single process without a group (dp, fsdp and
    tp must then be 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    _, world = rank_and_world()
    if fsdp is None:
        fsdp = max(world // max(dp * tp, 1), 1)
    if dp < 1 or tp < 1 or dp * fsdp * tp != world:
        raise ValueError(f'mesh dp {dp} x fsdp {fsdp} x tp {tp} != {world} '
                         f'process(es)'
                         f'{"" if world > 1 else ": launch with torchrun"}')
    if not dist.is_initialized():
        return None
    mesh = init_device_mesh(device_type, (dp, fsdp, tp),
                            mesh_dim_names=('dp', 'fsdp', 'tp'))
    mesh.data_group = mesh.tp_group = None
    if tp > 1:
        # every rank makes every group, in one order
        rank, data = dist.get_rank(), dp * fsdp
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(data)])
            if rank % tp == t:
                mesh.data_group = g
        for d in range(data):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if rank // tp == d:
                mesh.tp_group = g
    return mesh


def jax_path(name: str) -> Optional[str]:
    """JAX's parameter path (the part the rules read) of one port
    parameter of the LLaMA trunk, its tables and heads, or of a leaf of
    the quantized tree (``layers.N.qkv_proj.q``, ``lm_head.scale`` ...);
    None for every other parameter."""
    m = _LLAMA_NAME.match(name)
    if m:
        layer, block, proj = m.groups()
        return (f'layers_{layer}/self_attn/{proj}/kernel'
                if block == 'self_attn' else f'layers_{layer}/{proj}/kernel')
    m = _QUANT_NAME.match(name)
    if m:
        return f'layers_{m.group(1)}/{m.group(2)}/{m.group(3)}'
    return _FIXED_NAMES.get(name)


def tp_placement(name: str, shape, tp: int,
                 head_dim: Optional[int] = None) -> Optional[int]:
    """The dim of the port's parameter ``name`` (of ``shape``) that tensor
    parallelism cuts over ``tp`` ranks, or None where it stays whole:
    JAX's ``param_pspec`` tp / vocab component on ``jax_path(name)``, the
    dim moved to the port's layout (a kernel's transposed).  With
    ``head_dim``, q/k/v/o_proj are cut at whole heads only."""
    path = jax_path(name)
    if tp <= 1 or path is None:
        return None

    def port_dim(d):
        return len(shape) - 1 - d if path.endswith('/kernel') else d
    for pat, d in VOCAB_RULES:
        if re.search(pat, path) and len(shape) > d:
            d = port_dim(d)
            # JAX drops fsdp first, then tp
            return d if shape[d] % tp == 0 else None
    for pat, d in TP_RULES:
        if re.search(pat, path) and len(shape) > d:
            d = port_dim(d)
            if shape[d] % tp:
                continue
            if head_dim and _HEAD_PATHS.search(path) \
                    and (shape[d] // head_dim) % tp:
                return None
            return d
    return None


def cut_tp(model: torch.nn.Module, group) -> dict:
    """Cut every tp-placed parameter of ``model`` to this rank's slice of
    ``group``, in place, and hand ``group`` to ``model`` and to the
    modules that compute on slices -> the plan (name -> dim), also kept
    as ``model.tp_plan``.  ``shard_model`` calls it; a served model whose
    data ranks are replicas (FSDP gathers parameters around ``forward``
    alone, which serving does not call) is cut by this alone.  Whatever
    it cuts, ``model.tp_group`` is set, so that the optimizer averages the
    gradients its tp ranks each compute whole (the detector's: all)."""
    from groma_tpu_torch.models.llama import LlamaAttention
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    head_dim = next((m.cfg.hidden_size // m.cfg.num_heads
                     for m in model.modules()
                     if isinstance(m, LlamaAttention)), None)
    plan = {}
    for name, p in model.named_parameters():
        d = tp_placement(name, tuple(p.shape), tp, head_dim)
        if d is None:
            continue
        n = p.shape[d] // tp
        p.data = p.data.narrow(d, rank * n, n).contiguous()
        plan[name] = d
    for m in model.modules():
        if hasattr(m, 'tp_group'):
            m.tp_group = group
    model.tp_group = group
    model.tp_plan = plan
    return plan


def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    """A packed int4 leaf (K/2, N) -> its (K, N) stored nibbles (q + 8):
    row k < K/2 is byte k's low nibble, row K/2 + k its high one."""
    return torch.cat([packed & 0xF, packed >> 4], dim=0)


def _pack(nibbles: torch.Tensor) -> torch.Tensor:
    """(K, N) nibbles -> the packed (K/2, N) bytes of a K-row leaf."""
    kh = nibbles.shape[0] // 2
    return (nibbles[:kh] | (nibbles[kh:] << 4)).contiguous()


def _quant_cols(leaf: dict, ranges) -> dict:
    """A quantized leaf's columns ``ranges`` ((start, stop) pairs), side
    by side in order: ``q`` on dim 1, a scale on its last dim (int8's
    (N,), int4's (K/256, N))."""
    def take(t, dim):
        return torch.cat([t.narrow(dim, a, b - a) for a, b in ranges],
                         dim).contiguous()
    out = {'q': take(leaf['q'], 1)}
    if 'scale' in leaf:
        out['scale'] = take(leaf['scale'], leaf['scale'].dim() - 1)
    return out


def _quant_rows(leaf: dict, k0: int, k1: int) -> dict:
    """A quantized leaf's rows [k0, k1) as a leaf of k1 - k0 rows, with
    the whole leaf's values and scales: int8 and bf16 rows sliced (the
    per-column int8 scale whole); int4 rows unpacked from both nibble
    halves and packed again as a (k1 - k0)-row leaf, with their 256-row
    blocks' scales (k0 and k1 on block boundaries)."""
    q = leaf['q']
    if q.dtype != torch.uint8:
        return {**leaf, 'q': q[k0:k1].contiguous()}
    if k0 % INT4_BLOCK or k1 % INT4_BLOCK:
        raise ValueError(f'int4 rows [{k0}, {k1}) are not whole '
                         f'{INT4_BLOCK}-row scale blocks')
    return {'q': _pack(_nibbles(q)[k0:k1]),
            'scale': leaf['scale'][k0 // INT4_BLOCK:
                                   k1 // INT4_BLOCK].contiguous()}


def mlp_share(intermediate: int, tp: int, rank: int, int4: bool) -> tuple:
    """The MLP intermediate's rows [start, stop) that ``rank`` of ``tp``
    computes: an even cut, or for an int4 ``down_proj`` whole 256-row
    scale blocks, rank r taking blocks [floor(nb r / tp), floor(nb (r + 1)
    / tp)) of the nb (7B's 43 at tp = 2: 21 and 22 blocks)."""
    if int4:
        nb = intermediate // INT4_BLOCK
        a, b = nb * rank // tp, nb * (rank + 1) // tp
        if a == b:
            raise ValueError(f'{nb} int4 scale blocks of the MLP leave tp '
                             f'rank {rank} of {tp} none')
        return a * INT4_BLOCK, b * INT4_BLOCK
    if intermediate % tp:
        raise ValueError(f'an intermediate of {intermediate} does not divide '
                         f'over tp {tp}')
    n = intermediate // tp
    return rank * n, (rank + 1) * n


def cut_quant_tree(qp: dict, cfg, group) -> dict:
    """This rank's tree of a whole quantized LLaMA tree
    (``quantize_llama_params``, which every rank builds from the whole
    weights: a row-parallel leaf's per-column int8 scale is a maximum over
    the whole K) -> a new tree; free the whole one after.

    Rank r of ``group`` keeps, per layer: ``qkv_proj``'s columns [its
    query heads | its KV heads of k | of v] (heads whole; where tp does
    not divide the KV heads, k and v whole), ``o_proj``'s rows of its
    query heads, ``gate_up_proj``'s columns [its gate share | its up
    share] and ``down_proj``'s rows of that share (``mlp_share``: even for
    int8, whole scale blocks for int4, whose rows are packed again as a
    tree of their own, with the whole tree's values and scales); the head
    ``lm_head`` cut on its padded vocabulary columns where tp divides
    them.  ``embed_tokens``, ``new_input_embs``, ``extra_lm_head`` and the
    norms stay whole.  The tree records the cut under ``'tp'`` (the
    group, rank and size, the local query and KV heads, the first of
    each, the MLP share, the whole padded vocabulary or None where the
    head stays whole), which ``models.llama_quant`` reads."""
    if 'tp' in qp:
        raise ValueError('the tree is already cut')
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    hd = cfg.hidden_size // cfg.num_heads
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if nh % tp:
        raise ValueError(f'{nh} query heads do not divide over tp {tp}')
    nq = nh // tp
    kv_cut = nkv % tp == 0
    nkv_l = nkv // tp if kv_cut else nkv
    kv0 = r * nkv_l if kv_cut else 0
    q0, k0 = r * nq * hd, kv0 * hd
    qkv = [(q0, q0 + nq * hd),
           (nh * hd + k0, nh * hd + k0 + nkv_l * hd),
           ((nh + nkv) * hd + k0, (nh + nkv) * hd + k0 + nkv_l * hd)]
    first = qp['layers'][0] if qp['layers'] else {}
    if first and first['o_proj']['q'].dtype == torch.uint8 \
            and (nq * hd) % INT4_BLOCK:
        raise ValueError(
            f'an int4 o_proj at tp {tp} gives a rank {nq * hd} rows, not '
            f'whole {INT4_BLOCK}-row scale blocks: ROADMAP.md §1 item 11h')
    inter = cfg.intermediate_size
    m0, m1 = mlp_share(inter, tp, r, bool(first) and
                       first['down_proj']['q'].dtype == torch.uint8)
    layers = []
    for lp in qp['layers']:
        layers.append({
            **lp,
            'qkv_proj': _quant_cols(lp['qkv_proj'], qkv),
            'o_proj': _quant_rows(lp['o_proj'], q0, q0 + nq * hd),
            'gate_up_proj': _quant_cols(lp['gate_up_proj'],
                                        [(m0, m1), (inter + m0, inter + m1)]),
            'down_proj': _quant_rows(lp['down_proj'], m0, m1)})
    out = {**qp, 'layers': layers}
    vocab = None
    if 'lm_head' in qp and qp['lm_head']['q'].shape[1] % tp == 0:
        vocab = qp['lm_head']['q'].shape[1]
        n = vocab // tp
        out['lm_head'] = _quant_cols(qp['lm_head'], [(r * n, (r + 1) * n)])
    out['tp'] = {'group': group, 'rank': r, 'size': tp, 'heads': nq,
                 'kv_heads': nkv_l, 'q_first': r * nq, 'kv_first': kv0,
                 'mlp': (m0, m1), 'vocab': vocab}
    return out


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut ``model``'s tp-placed parameters to this rank's slices (mesh
    axis 'tp' above 1, ``cut_tp``), then ``fully_shard`` each LLaMA
    decoder layer and DINOv2 layer, then ``model`` itself (the other
    parameters), over the ('dp', 'fsdp') sub-mesh; in place.  Build the
    optimizer after this: the parameters are replaced (FSDP's are
    DTensors)."""
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:                 # PyTorch before 2.6
        from torch.distributed._composable.fsdp import fully_shard

    from groma_tpu_torch.models.dinov2 import Dinov2Layer
    from groma_tpu_torch.models.llama import LlamaDecoderLayer
    tp = mesh.size(mesh.mesh_dim_names.index('tp'))
    model.data_group = mesh.data_group
    if tp > 1:
        cut_tp(model, mesh.tp_group)
    data = mesh['dp', 'fsdp']
    if tp > 1 and data.size() == 1:
        return model                    # one data rank: nothing to shard
    # FSDP shards contiguous parameters only (a loaded transpose is not)
    for p in model.parameters():
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    for m in model.modules():
        if isinstance(m, (LlamaDecoderLayer, Dinov2Layer)):
            fully_shard(m, mesh=data)
    fully_shard(model, mesh=data)
    return model


class RankBatches:
    """This rank's contiguous 1/world slice of each global batch of
    ``batches`` (index lists; ``set_epoch`` and ``len`` pass through to a
    sampler).  Under tp, ``rank`` and ``world`` are the data group's."""

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


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (None: the whole process group), in
    place (``t`` itself without a process group)."""
    if grouped():
        dist.all_reduce(t, group=group)
    return t


def _dtensor():
    """(DTensor, distribute_tensor) of this PyTorch."""
    try:
        from torch.distributed.tensor import DTensor, distribute_tensor
    except ImportError:                 # PyTorch before 2.5
        from torch.distributed._tensor import DTensor, distribute_tensor
    return DTensor, distribute_tensor


def _full(v, dim: Optional[int] = None, group=None):
    """A state tensor whole: FSDP's shards gathered, then (``dim`` not
    None) the tp slices along ``dim`` (zero-padded and summed over
    ``group``: exact)."""
    DTensor, _ = _dtensor()
    v = v.full_tensor() if isinstance(v, DTensor) else v
    if dim is None:
        return v
    r, tp = dist.get_rank(group), dist.get_world_size(group)
    n = v.shape[dim]
    shape = list(v.shape)
    shape[dim] = n * tp
    whole = v.new_zeros(shape)
    whole.narrow(dim, r * n, n).copy_(v)
    dist.all_reduce(whole, group=group)
    return whole


def _plan(model) -> dict:
    return getattr(model, 'tp_plan', {})


def full_model_state(model) -> dict:
    """``model.state_dict()`` with every sharded tensor gathered whole; a
    collective: every rank calls it."""
    plan, group = _plan(model), getattr(model, 'tp_group', None)
    return {k: _full(v, plan.get(k), group)
            for k, v in model.state_dict().items()}


def full_grads(model) -> dict:
    """Each parameter's gradient gathered whole (FSDP's shards, then tp's
    slices), by name, for the parameters that have one; a collective:
    every rank calls it."""
    plan, group = _plan(model), getattr(model, 'tp_group', None)
    return {k: _full(p.grad, plan.get(k), group)
            for k, p in model.named_parameters() if p.grad is not None}


def full_state_dicts(model, optimizer) -> tuple:
    """(model state, ``optimizer.state_dict()``) with every sharded
    tensor gathered whole, as a single process holds them; a collective:
    every rank calls it."""
    plan, group = _plan(model), getattr(model, 'tp_group', None)
    msd = full_model_state(model)
    osd = optimizer.state_dict()
    opt = osd['opt']
    names = optimizer.names
    opt['state'] = {i: {k: v if k == 'step' else
                        _full(v, plan.get(names[i]), group)
                        for k, v in st.items()}
                    for i, st in opt['state'].items()}
    return msd, osd


def _shard_like(ref, full, dim: Optional[int] = None, group=None):
    """``full`` as a tensor laid out as ``ref``: its tp slice along
    ``dim`` (if not None), then (``ref`` a DTensor) this rank's FSDP shard
    of that; on ref's device."""
    DTensor, distribute_tensor = _dtensor()
    if dim is not None:
        n = full.shape[dim] // dist.get_world_size(group)
        full = full.narrow(dim, dist.get_rank(group) * n, n)
    if isinstance(ref, DTensor):
        return distribute_tensor(full.to(ref.device, ref.dtype).contiguous(),
                                 ref.device_mesh, ref.placements)
    return full.to(ref.device)


@torch.no_grad()
def load_full_state_dicts(model, optimizer, msd: dict, osd: dict):
    """Load whole (unsharded) states, as ``full_state_dicts`` gives them
    or a single process saved them, into a model and optimizer that may be
    sharded; a collective where they are."""
    DTensor, _ = _dtensor()
    plan, group = _plan(model), getattr(model, 'tp_group', None)
    own = model.state_dict()
    if own.keys() != msd.keys():
        raise ValueError('checkpoint and model differ in their keys: '
                         f'{sorted(own.keys() ^ msd.keys())[:5]}')
    for k, t in own.items():
        part = _shard_like(t, msd[k], plan.get(k), group)
        (t.to_local() if isinstance(t, DTensor) else t).copy_(
            part.to_local() if isinstance(part, DTensor) else part)
    params = [p for g in optimizer.opt.param_groups for p in g['params']]
    names = optimizer.names
    opt = dict(osd['opt'])
    opt['state'] = {i: {k: v if k == 'step' else
                        _shard_like(params[i], v, plan.get(names[i]), group)
                        for k, v in st.items()}
                    for i, st in osd['opt']['state'].items()}
    optimizer.load_state_dict({**osd, 'opt': opt})
