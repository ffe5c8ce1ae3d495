"""The port's sequence-parallel attention on the CPU: both schedules
(`parallel/seq_attention.py`) over gloo ranks started with torchrun's
environment (`tests/helpers_torch_dp.py`), against the JAX package's
`seq_sharded_flash_attention` and `ring_flash_attention` on the suite's
virtual CPU devices (Pallas in interpret mode, as `tests/test_seq_attention.py`
runs them).

On the CPU the kernel wrappers run their plain versions, so each schedule's
plain version is checked here; the card runs the same schedules on #1-#3
(`tests/test_torch_cuda.py -k seq`, `chip_smoke.py`'s [seq-attn]). The bars
are the JAX tests': outputs on valid query rows 2e-5, gradients 3e-5, the
ring in bf16 5e-2 from the f32 reference with its bf16 type kept. Both
world sizes launch together, each rank and group with its own timeout.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from helpers_torch_dp import launch
from paths_tpu.parallel.seq_attention import (
    ring_flash_attention,
    seq_sharded_flash_attention,
)
from test_seq_attention import _case, _mesh, _shard, reference_attention

from paths_tpu_torch.parallel import seq_attention as tsa

SPS = (2, 4)
IMPLS = {"gathered": seq_sharded_flash_attention, "ring": ring_flash_attention}
FWD_ATOL, GRAD_ATOL, BF16_ATOL = 2e-5, 3e-5, 5e-2


def _block(sp: int) -> int:
    """The key and query block of both packages: one rank's whole block of
    the 64 rows (fewer interpreted grid steps than JAX's tests' 8)."""
    return 64 // sp


def _jax(sp: int, q, k, v, lengths, w):
    """Each JAX schedule on `_mesh(sp)`: the output and the gradients of
    sum(out * w) from one `jax.vjp`, and the ring's bf16 output."""
    mesh = _mesh(sp)
    qs, ks, vs = (_shard(mesh, x) for x in (q, k, v))
    blocks = dict(block_q=_block(sp), block_k=_block(sp))
    got = {}
    fa.INTERPRET = True
    try:
        for impl, fn in IMPLS.items():
            def run(q, k, v, w, fn=fn):
                out, vjp = jax.vjp(
                    lambda q, k, v: fn(mesh, q, k, v, lengths, **blocks),
                    q, k, v)
                return out, vjp(w)

            out, grads = jax.jit(run)(qs, ks, vs, w)
            got[f"{impl}_out"] = np.asarray(out)
            for name, g in zip("qkv", grads):
                got[f"{impl}_d{name}"] = np.asarray(g)
        bf = [_shard(mesh, x.astype(jnp.bfloat16)) for x in (q, k, v)]

        def ring_bf16(q, k, v, w):
            out, vjp = jax.vjp(lambda q, k, v: ring_flash_attention(
                mesh, q, k, v, lengths, **blocks), q, k, v)
            return out, vjp(w.astype(jnp.bfloat16))

        out, grads = jax.jit(ring_bf16)(*bf, w)
        got["ring_bf16_dtype"] = out.dtype
        got["ring_bf16_out"] = np.asarray(out.astype(jnp.float32))
        for name, g in zip("qkv", grads):
            got[f"ring_bf16_d{name}"] = np.asarray(g.astype(jnp.float32))
    finally:
        fa.INTERPRET = False
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's case (n 64, lengths [64, 45]) through every port rank at sp 2
    and 4 (started first, in a thread) and through JAX meanwhile."""
    tmp = str(tmp_path_factory.mktemp("torch_seq_attn"))
    q, k, v, lengths = _case(seed=3)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    valid = (np.arange(q.shape[2])[None] < np.asarray(lengths)[:, None])
    w = np.where(valid[:, None, :, None], w, 0.0).astype(np.float32)
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
             lengths=np.asarray(lengths), w=w)
    job = lambda sp: [{"kind": "seq_attn", "name": "attn", "dir": tmp,  # noqa: E731
                       "inputs": inputs, "block_k": _block(sp)}]
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.update(zip(SPS, launch(
        *[(sp, job(sp), os.path.join(tmp, f"out{sp}")) for sp in SPS]))))
    thread.start()
    want = {sp: _jax(sp, q, k, v, lengths, _shard(_mesh(sp), jnp.asarray(w)))
            for sp in SPS}
    thread.join()
    got = {}
    for sp in SPS:
        assert len(ranks.get(sp, [])) == sp, "the ranks did not finish"
        blocks = []
        for r in range(sp):
            with np.load(os.path.join(tmp, f"out{sp}", f"attn_rank{r}.npz")) as f:
                blocks.append(dict(f))
        got[sp] = {key: np.concatenate([b[key] for b in blocks], axis=2)
                   for key in blocks[0]}
        got[sp]["ring_bf16_dtype"] = ranks[sp][0]["attn"]["bf16_dtype"]
    return {"lengths": np.asarray(lengths), "valid": valid, "got": got,
            "want": want, "ref": np.asarray(reference_attention(q, k, v,
                                                                  lengths))}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("sp", SPS)
def test_forward_matches_jax(runs, sp, impl):
    """The assembled output blocks against JAX's schedule on its valid query
    rows (padded rows attend too but are sliced off by the model)."""
    got, want = runs["got"][sp][f"{impl}_out"], runs["want"][sp][f"{impl}_out"]
    for bi, ln in enumerate(runs["lengths"]):
        np.testing.assert_allclose(got[bi, :, :ln], want[bi, :, :ln],
                                   atol=FWD_ATOL, err_msg=f"batch {bi}")


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("sp", SPS)
def test_gradients_match_jax(runs, sp, impl):
    """dq, dk, dv of sum(out * w) (w zero on padded query rows): the
    all-gather's reduce-scatter, and the ring's rotating accumulators."""
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(runs["got"][sp][f"{impl}_{name}"],
                                   runs["want"][sp][f"{impl}_{name}"],
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("sp", SPS)
def test_ring_fold_rounds_once(runs, sp):
    """The f32 ring folds its steps' partials in f64 (`_fold_dtype`): its
    output is the exact combination of the kernels' partial outputs by
    their lse, rounded to f32 once, and its dq the exact sum of the steps'
    dq, rounded once, both to the bit (an f32 fold rounds at every term: at
    the flagship's widths that put the ring step at the edge of its bar
    against one process on the card)."""
    got = runs["got"][sp]
    o = got["ring_part_o"].astype(np.float64)      # (B, H, N, steps, D)
    lse = got["ring_part_lse"].astype(np.float64)  # (B, H, N, steps)
    top = lse.max(axis=3, keepdims=True)
    weight = np.exp(lse - top)
    exact = (o * (weight / weight.sum(axis=3, keepdims=True))[..., None]).sum(3)
    np.testing.assert_array_equal(got["ring_out"], exact.astype(np.float32))
    dq = got["ring_part_dq"].astype(np.float64).sum(axis=3)
    np.testing.assert_array_equal(got["ring_dq"], dq.astype(np.float32))


@pytest.mark.parametrize("sp", SPS)
def test_ring_bfloat16(runs, sp):
    """bf16 inputs: the f32 (out, lse) carry keeps the output finite and
    close to the f32 reference, and the output type is bf16, as JAX's."""
    got = runs["got"][sp]
    assert got["ring_bf16_dtype"] == "torch.bfloat16"
    assert runs["want"][sp]["ring_bf16_dtype"] == jnp.bfloat16
    assert np.all(np.isfinite(got["ring_bf16_out"]))
    for bi, ln in enumerate(runs["lengths"]):
        for out in (got["ring_bf16_out"], runs["want"][sp]["ring_bf16_out"]):
            np.testing.assert_allclose(out[bi, :, :ln],
                                       runs["ref"][bi, :, :ln],
                                       atol=BF16_ATOL)


@pytest.mark.parametrize("sp", SPS)
def test_ring_bfloat16_gradients_match_jax(runs, sp):
    """bf16 inputs: the ring's dq, dk, dv against JAX's bf16 ring (both
    round P against each block's running max and keep bf16 accumulators):
    within 2 bf16 ulps (4u, u = 2^-8) of each gradient's largest."""
    for name in ("dq", "dk", "dv"):
        got = runs["got"][sp][f"ring_bf16_{name}"]
        want = runs["want"][sp][f"ring_bf16_{name}"]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 4 * 2.0 ** -8, f"{name}: {err:.3g} of its largest"


def test_combine_matches_jax():
    """`_combine` folds partials as JAX's does, an empty partial (lse at the
    kernels' NEG_INF) and the ring's -inf start included, without NaN."""
    from paths_tpu.parallel.seq_attention import _combine as j_combine

    rng = np.random.default_rng(0)
    o1, o2 = (rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
              for _ in range(2))
    lse1 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    lse2 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    lse2[0] = -1e30
    lse1[1, 0] = -np.inf
    got = tsa._combine(*(torch.from_numpy(a) for a in (o1, lse1, o2, lse2)))
    want = j_combine(*(jnp.asarray(a) for a in (o1, lse1, o2, lse2)))
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
