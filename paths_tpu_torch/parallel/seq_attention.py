"""Sequence-parallel masked flash attention over a process group
(counterpart of `paths_tpu.parallel.seq_attention`).

The aggregator's sequence is cut into sp contiguous blocks of m rows, one per
rank of a sequence group (`parallel/mesh.py`, `models/batch.py`): q, k and v
are a rank's (B, H, m, D) block and `lengths` (B,) the GLOBAL valid-key
counts, the same on every rank (the sequence is compacted valid-first, so
the valid keys are one prefix). Two schedules, each a `torch.autograd.
Function` over the group, on the flash kernels #1-#3
(`kernels/flash_attention.py`):

* gathered-KV (`seq_sharded_flash_attention`): all-gather K and V, then #1
  over the rank's query block at (Nq, Nk) = (m, sp m). Backward: #2 / #3 at
  that shape, then a reduce-scatter (sum) of dK and dV.
* ring (`ring_flash_attention`): sp steps of #1 on the K/V block held, which
  came from rank src = (index - i) mod sp and is masked to its slice of the
  global prefix, blk_len = clip(lengths - src m, 0, m); the partials fold
  into an (out, lse) carry with `_combine` in JAX's order, and the blocks
  rotate to the next rank. Backward: sp steps of #2 / #3 on each block with
  the GLOBAL out and lse, the dQ sum and the dK / dV accumulators rotating
  with their blocks until they are home. The fold is f64 for f32 inputs
  and JAX's (an f32 carry, bf16 accumulators) for bf16 (`_fold_dtype`).

The collectives of the forward and their adjoints (also the broadcast, the
sum and the gathers that the model and the hierarchy use) are `SeqSharding`
methods; their sums take bf16 in f32 and round once, as XLA sums a bf16
all-reduce. They run over the group's backend: NCCL when each rank has its own
card; gloo on the CPU and when the ranks share one card. gloo takes CUDA
tensors in its collectives, but its send and receive abort the process on
one (torch 2.11), so the ring's exchange alone crosses through page-locked
host buffers there (`SeqSharding.transport`). The kernels run on the card
all the same; on the CPU the wrappers run their plain versions, so each
schedule's plain version is the same schedule.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from paths_tpu_torch.kernels.flash_attention import (
    BLOCK_K,
    masked_flash_attention_bwd,
    masked_flash_attention_fwd,
)

IMPLS = ("gathered", "ring")


class SeqSharding:
    """A sequence group and the schedule of its attention ("gathered"
    all-gathers K/V on every rank: O(N) memory, one collective; "ring"
    rotates K/V blocks: O(N / sp) memory, sp - 1 exchanges). `group` is a
    `torch.distributed` group (None: the whole world)."""

    def __init__(self, group=None, impl: str = "gathered"):
        if impl not in IMPLS:
            raise ValueError(f"seq_attention {impl!r}: one of {IMPLS}")
        self.group, self.impl = group, impl
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.ranks = [dist.get_global_rank(group, i) if group is not None
                      else i for i in range(self.size)]
        self.backend = str(dist.get_backend(group))

    @classmethod
    def from_mesh(cls, mesh, impl: str = "gathered") -> "SeqSharding | None":
        """The sequence group of a `ProcessMesh`, None without one."""
        if mesh is None or getattr(mesh, "seq", 1) <= 1:
            return None
        return cls(mesh.seq_group, impl)

    def transport(self, device) -> str:
        """How the ring's blocks on `device` cross between the ranks."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, the ring's exchange through page-locked host buffers"
        return self.backend

    def attend(self, q, k, v, lengths, block_k: int = BLOCK_K):
        fn = (ring_flash_attention if self.impl == "ring"
              else seq_sharded_flash_attention)
        return fn(self, q, k, v, lengths, block_k=block_k)

    # ---------------------------------------------------------- collectives

    def _collective(self, fn, out: torch.Tensor, inp: torch.Tensor) -> None:
        """fn(out, inp, group=...); `out` is written in place."""
        with warnings.catch_warnings(), torch.no_grad():
            # torch 2.13 names the *_tensor collectives deprecated
            warnings.simplefilter("ignore", FutureWarning)
            fn(out, inp, group=self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's blocks of x concatenated along `dim`, in rank order
        (no gradient: `all_gather` is the differentiable one)."""
        x = x.detach().movedim(dim, 0).contiguous()
        out = x.new_empty((self.size * x.shape[0],) + x.shape[1:])
        self._collective(dist.all_gather_into_tensor, out, x)
        return out.movedim(0, dim).contiguous()

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along `dim` of the sum of x over the group (the
        adjoint of `gather`; a narrow type summed as `sum_` sums it)."""
        y = _summand(x).movedim(dim, 0).contiguous()
        out = y.new_empty((y.shape[0] // self.size,) + y.shape[1:])
        self._collective(dist.reduce_scatter_tensor, out, y)
        return out.to(x.dtype).movedim(0, dim).contiguous()

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group, in place. A float type narrower than f32
        (bf16) is summed in f32 and rounded once, as XLA's CPU and GPU
        backends sum a bf16 all-reduce (gloo would round after every add:
        at sp 4 a third of a sum's elements then differ)."""
        y = _summand(x)
        dist.all_reduce(y, group=self.group)
        return x.copy_(y) if y is not x else x

    def broadcast_(self, x: torch.Tensor) -> torch.Tensor:
        """Sequence index 0's x on every rank, in place."""
        dist.broadcast(x, src=self.ranks[0], group=self.group)
        return x

    def reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group into sequence index 0's x, in place (the
        adjoint of `broadcast_`; a narrow type summed as `sum_` sums it);
        other ranks' x is left undefined."""
        y = _summand(x)
        dist.reduce(y, dst=self.ranks[0], group=self.group)
        return x.copy_(y) if y is not x else x

    def rotate(self, *xs: torch.Tensor) -> list:
        """Each of xs sent to the next rank of the ring, index + 1 mod sp;
        returns what the previous rank sent, in one batch of exchanges."""
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        # gloo's send and receive refuse CUDA tensors: through host memory
        staged = self.backend == "gloo" and xs[0].is_cuda
        send = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
                if staged else x.contiguous() for x in xs]
        recv = [torch.empty(x.shape, dtype=x.dtype, pin_memory=staged,
                            device="cpu" if staged else x.device)
                for x in xs]
        ops = [dist.P2POp(dist.isend, t, nxt, group=self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, group=self.group) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            return [r.to(x.device) for r, x in zip(recv, xs)]
        return recv

    # ------------------------------------------------- differentiable forms

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """`gather` with the reduce-scatter as its backward."""
        return _AllGather.apply(x, self, dim)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """Sequence index 0's x on every rank; backward: the gradients
        summed into index 0's (the other ranks' x get zero)."""
        return _FromFirst.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group; backward: the gradients summed alike."""
        return _Sum.apply(x, self)

    def dropout_shard(self):
        """The `nn.core.dropout` shard of a tensor whose rows are this
        rank's block of the group's."""
        return (self.index, self.size)


def _summand(x: torch.Tensor) -> torch.Tensor:
    """x as a collective sums it: a float type narrower than f32 in f32."""
    if x.is_floating_point() and x.dtype.itemsize < 4:
        return x.float()
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding, dim):
        ctx.sharding, ctx.dim = sharding, dim
        return sharding.gather(x.detach(), dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.sharding.scatter_sum(g, ctx.dim), None, None


class _FromFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        return sharding.broadcast_(x.detach().clone())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s = ctx.sharding
        g = s.reduce_(g.contiguous().clone())
        return (g if s.index == 0 else torch.zeros_like(g)), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        return sharding.sum_(x.detach().clone())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.sharding.sum_(g.contiguous().clone()), None


# ------------------------------------------------------------- gathered-KV

class _GatheredAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, sharding, block_k):
        k_full = sharding.gather(k.detach(), 2)
        v_full = sharding.gather(v.detach(), 2)
        out, lse = masked_flash_attention_fwd(q.detach().contiguous(), k_full,
                                              v_full, lengths, block_k)
        ctx.sharding = sharding
        ctx.save_for_backward(q, k_full, v_full, lengths, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k_full, v_full, lengths, out, lse = ctx.saved_tensors
        dq, dk, dv = masked_flash_attention_bwd(
            q.detach().contiguous(), k_full, v_full, lengths, out.detach(),
            lse, dout.contiguous())
        s = ctx.sharding
        return dq, s.scatter_sum(dk, 2), s.scatter_sum(dv, 2), None, None, None


def seq_sharded_flash_attention(sharding: SeqSharding, q, k, v, lengths, *,
                                block_k: int = BLOCK_K) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + key-prefix mask) v over the group's
    sequence: q/k/v this rank's (B, H, m, D) block, `lengths` (B,) int32 the
    global valid-key counts. Returns this rank's block of the context, q's
    shape and type."""
    return _GatheredAttention.apply(q, k, v, lengths, sharding, block_k)


# -------------------------------------------------------------------- ring

def _fold_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the ring folds its partials in: f64 for f32 inputs, so that
    the fold adds no rounding of its own to the kernels' (an f32 fold put
    the flagship's ring step at the edge of its bar against one process),
    and for bf16 JAX's types (an f32 carry, bf16 gradient accumulators)."""
    return torch.float64 if dtype == torch.float32 else dtype


def _combine(o1, lse1, o2, lse2):
    """Fold two attention partials over disjoint key sets into one: out =
    the average of the outs weighted by exp(lse), lse = logaddexp. An empty
    partial carries lse about NEG_INF and weighs nothing. In the carry's
    type, lse1's: f32 at least (JAX's ring keeps an f32 carry), f64 for f32
    and f64 inputs (`_fold_dtype`)."""
    lse2 = lse2.to(lse1.dtype)
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    den = torch.clamp_min(w1 + w2, 1e-30)
    out = (o1.to(lse1.dtype) * (w1 / den)[..., None]
           + o2.to(lse1.dtype) * (w2 / den)[..., None])
    return out, m + torch.log(den)


def _block_lengths(lengths, src: int, m: int) -> torch.Tensor:
    """Valid keys of block `src`: its slice of the global prefix."""
    return (lengths - src * m).clamp(0, m).to(torch.int32).contiguous()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, sharding, block_k):
        q, k, v = (t.detach().contiguous() for t in (q, k, v))
        idx, sp, m = sharding.index, sharding.size, k.shape[2]
        b, h, nq, _ = q.shape
        acc = torch.promote_types(_fold_dtype(q.dtype), torch.float32)
        out = torch.zeros(q.shape, dtype=acc, device=q.device)
        lse = torch.full((b, h, nq), float("-inf"), dtype=acc,
                         device=q.device)
        k_cur, v_cur = k, v
        for i in range(sp):
            src = (idx - i) % sp
            o_i, lse_i = masked_flash_attention_fwd(
                q, k_cur, v_cur, _block_lengths(lengths, src, m), block_k)
            out, lse = _combine(out, lse, o_i, lse_i)
            if i != sp - 1:
                k_cur, v_cur = sharding.rotate(k_cur, v_cur)
        out = out.to(q.dtype)
        lse = lse.to(torch.promote_types(q.dtype, torch.float32)).contiguous()
        ctx.sharding = sharding
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        s = ctx.sharding
        idx, sp, m = s.index, s.size, k.shape[2]
        out, dout = out.detach(), dout.contiguous()
        fold = _fold_dtype(q.dtype)
        dq = torch.zeros_like(q, dtype=fold)
        dk_cur = torch.zeros_like(k, dtype=fold)
        dv_cur = torch.zeros_like(v, dtype=fold)
        k_cur, v_cur = k, v
        for i in range(sp):
            src = (idx - i) % sp
            dq_i, dk_i, dv_i = masked_flash_attention_bwd(
                q, k_cur, v_cur, _block_lengths(lengths, src, m), out, lse,
                dout)
            dq = dq + dq_i
            if i != sp - 1:
                dk_cur, dv_cur, k_cur, v_cur = s.rotate(
                    dk_cur + dk_i, dv_cur + dv_i, k_cur, v_cur)
            else:
                dk_cur, dv_cur = s.rotate(dk_cur + dk_i, dv_cur + dv_i)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None,
                None, None)


def ring_flash_attention(sharding: SeqSharding, q, k, v, lengths, *,
                         block_k: int = BLOCK_K) -> torch.Tensor:
    """The ring schedule: the contract of `seq_sharded_flash_attention` with
    O(N / sp) memory a rank instead of O(N)."""
    return _RingAttention.apply(q, k, v, lengths, sharding, block_k)

