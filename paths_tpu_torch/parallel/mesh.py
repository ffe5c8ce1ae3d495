"""The port's `data` and `(data, model)` meshes (counterpart of
`paths_tpu.parallel.mesh`).

JAX lays a `data` axis over devices, replicates the parameters and lets XLA
insert the collectives. PyTorch has no partitioner, so the axis takes one of
two forms here, and both split a padded batch into contiguous blocks of
rows, as `NamedSharding(P("data"))` lays rows out:

* `Mesh` (`make_mesh`): devices of this process. The serving session and
  preprocessing keep one replica of their model per device and run each
  block on its own device, as JAX's inference paths run in one process.
* `ProcessMesh` (`mesh_from_config`): the process group, one process per
  card (`torchrun`, `runtime.maybe_init_distributed`). Training and
  `cli.evaluate` run on it: each data index collates and runs its block of
  every padded global batch, the gradients meet in one all-reduce over the
  world, and every rank applies the same clip and AdamW step, so the
  replicas stay equal to the bit.

`mesh_shape` [dp, sp>1] adds sequence parallelism, the `model` axis of
`make_mesh_2d`, innermost: rank r sits at data index r // sp and sequence
index r % sp, and the sp ranks of one data index form a sequence group
(`dist.new_group`) that shares one block of slides. Each rank of a group
collates only its block of every level-0 bag (`models/batch.py`), runs the
per-patch work on it, and meets the group in the aggregator's attention
(`parallel/seq_attention.py`) and in the top-K; the levels >= 1 run whole
and alike on every rank of the group.

Gradients under sequence parallelism. Every collective of the forward is an
autograd Function whose backward is its exact adjoint (all-gather and
reduce-scatter, the broadcast from sequence index 0 and the reduce to it,
the all-reduce that assembles the kept rows and the all-reduce of their
gradients), and every rank of a group scales the loss it differentiates by
1 / sp. The sum over the world of the ranks' gradients (`all_reduce_grads`)
is then the gradient of the global loss: work replicated in a group counts
sp times 1 / sp, and each level-0 block counts its own rows once. Logged
losses are not scaled.

In the bf16 configuration the sums round where JAX's partitioned program
rounds: a weight's bf16 partial gradients are summed in f32 and the sum is
rounded to bf16 once (`all_reduce_grads`' `narrow`), and the sequence
group's sums of bf16 tensors run in f32 (`parallel/seq_attention.py`).
"""
from __future__ import annotations

import copy
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from paths_tpu_torch.data.dataset import pad_batch_indices  # noqa: F401


class Mesh:
    """A 1-D `data` axis over devices of this process. A device may appear
    more than once (shards that share a card)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}


class ProcessMesh:
    """The process group as a `data` axis, and with `seq` > 1 a (data x
    model) grid: this process is `rank` of `size`, at data index rank // seq
    and sequence index rank % seq, and `seq_group` is the group of its data
    index. Without a group it is one process, rank 0 of 1."""

    def __init__(self, rank: int = 0, size: int = 1, seq: int = 1,
                 seq_group=None):
        if size % seq:
            raise ValueError(f"{size} process(es) do not split into "
                             f"sequence groups of {seq}")
        self.rank, self.size, self.seq = rank, size, seq
        self.seq_group = seq_group

    @classmethod
    def current(cls) -> "ProcessMesh":
        if dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size())
        return cls()

    @property
    def data_index(self) -> int:
        return self.rank // self.seq

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq

    @property
    def shape(self) -> dict:
        if self.seq > 1:
            return {"data": self.size // self.seq, "model": self.seq}
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This data index's contiguous block of an n-row padded batch (n is
        a multiple of the data axis)."""
        share = n // data_axis_size(self)
        return slice(self.data_index * share, (self.data_index + 1) * share)


def make_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A data mesh over the first `n_data` of `devices` (default: every CUDA
    device of this host, and all of them when `n_data` is None)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_data is None else n_data
    if not 1 <= n <= len(devices):
        raise ValueError(f"a data mesh of {n} shard(s) over "
                         f"{len(devices)} device(s): {devices}")
    return Mesh(devices[:n])


def device_mesh(n_data: int, device="cuda") -> Mesh:
    """The mesh of a CLI's `--data-parallel N` / `--data-shards N` with its
    `--device`: an unindexed "cuda" means the host's first N cards; a named
    device (`cuda:0`, `cpu`) holds all N shards."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh(n_data)
    return make_mesh(n_data, [device] * n_data)


def place_replicas(module: torch.nn.Module, devices: Sequence) -> list:
    """`module` on each of `devices`, in order: moved to the first, copied
    to every other distinct device; shards that share a device share its
    replica."""
    placed: dict = {}
    for d in map(torch.device, devices):
        if d not in placed:
            placed[d] = (copy.deepcopy(module) if placed else module).to(d)
    return [placed[torch.device(d)] for d in devices]


def _seq_group(size: int, sp: int, rank: int):
    """This rank's sequence group: every rank creates every group, in data
    index order (`dist.new_group` is collective over the world)."""
    groups = [dist.new_group(list(range(d * sp, (d + 1) * sp)))
              for d in range(size // sp)]
    return groups[rank // sp]


def mesh_from_config(config) -> ProcessMesh:
    """The training mesh of `config.mesh_shape` over the process group:

    * None / []     -> every process of the group (one without torchrun)
    * [dp], [dp, 1] -> dp must be the group's size
    * [dp, sp>1]    -> dp * sp must be the group's size; rank r at data
      index r // sp, sequence index r % sp
    """
    ms = list(getattr(config, "mesh_shape", None) or [])
    mesh = ProcessMesh.current()
    sp = ms[1] if len(ms) > 1 else 1
    want = ms[0] * sp if ms else mesh.size
    if want != mesh.size:
        raise ValueError(
            f"mesh_shape={ms}: the mesh is the process group, which has "
            f"{mesh.size} process(es); launch {want} with `torchrun "
            f"--nproc-per-node {want}`")
    if sp > 1:
        mesh = ProcessMesh(mesh.rank, mesh.size, sp,
                           _seq_group(mesh.size, sp, mesh.rank))
    return mesh


def data_axis_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("data", 1))


def seq_axis_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def world_size(mesh) -> int:
    """Processes of a `ProcessMesh` (1 for None)."""
    return 1 if mesh is None else mesh.size


def _each_dtype(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


@torch.no_grad()
def replicate(mesh, model: torch.nn.Module, optimizer=None) -> None:
    """Broadcast rank 0's parameters, buffers and optimizer state to every
    rank, in place: after `load_state`, every replica starts from rank 0's
    bits. One broadcast per dtype, over a flat copy on the model's device
    (NCCL takes no host tensor; AdamW keeps its step counts there)."""
    if world_size(mesh) == 1:
        return
    params = list(model.parameters())
    tensors = params + list(model.buffers())
    if optimizer is not None:
        for p in params:
            state = optimizer.state.get(p, {})
            tensors += [state[k] for k in sorted(state)
                        if torch.is_tensor(state[k])]
    device = params[0].device
    for group in _each_dtype(tensors):
        flat = torch.cat([t.reshape(-1).to(device) for t in group])
        dist.broadcast(flat, src=0)
        off = 0
        for t in group:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def all_reduce_grads(mesh, params: Iterable[torch.nn.Parameter],
                     narrow: Iterable[torch.nn.Parameter] = (),
                     dtype: Optional[torch.dtype] = None) -> None:
    """Sum every gradient over the ranks, in place, with one all-reduce per
    dtype over a flat buffer. Each rank's loss is already divided by the
    global batch's weight (`ops.losses`), so the sum is the gradient of the
    global loss (under sequence parallelism, with each rank's loss scaled
    by 1 / sp: module docstring). Data-parallel ranks run the same graph, so
    the same parameters hold gradients on every rank; the ranks of a
    sequence group do not (only sequence index 0 holds level 0's special
    token), so there a parameter that holds a gradient on any rank gets a
    zero one where it has none.

    `narrow` (`models.recursive.narrow_params`): parameters whose gradient
    on a rank is a value of the compute type `dtype` (bf16), which the sum
    then takes to that type with one rounding: where JAX's partitioned
    program sums the ranks' bf16 partial products (in f32 on XLA's CPU and
    GPU backends) and converts the sum to bf16 before the f32 parameter's
    convert, so a rank's f32 sum alone would keep up to half a bf16 ulp
    that JAX's gradient does not have."""
    if world_size(mesh) == 1:
        return
    params = list(params)
    if seq_axis_size(mesh) > 1:
        held = torch.tensor([p.grad is not None for p in params],
                            dtype=torch.int32, device=params[0].device)
        dist.all_reduce(held, op=dist.ReduceOp.MAX)
        for p, h in zip(params, held.tolist()):
            if h and p.grad is None:
                p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params if p.grad is not None]
    for group in _each_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        off = 0
        for g in group:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()
    for p in narrow:
        if p.grad is not None:
            p.grad.copy_(p.grad.to(dtype))


def gather_objects(mesh, obj) -> list:
    """`obj` of every rank, in rank order (host objects: gloo's all-gather
    takes no CUDA tensor)."""
    if world_size(mesh) == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh) -> None:
    if world_size(mesh) > 1:
        dist.barrier()
