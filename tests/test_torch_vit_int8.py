"""The port's int8 ViT block path against the JAX package on the CPU: the
weight quantiser, the plain versions of kernels #8 (int8 attention block), #9
(int8 GELU MLP block) and #10 (int8 packed-SwiGLU MLP block) against the
Pallas kernels in interpret mode and against `int8_block_reference`, the
`int8` route of `vit_apply`, the converters, the registry and the CLI. Inputs
come from numpy with a seed and go through both packages.

Tolerance. f32, atol 2e-5 on O(1) activations, the JAX tests' own bar: both
sides do the same integer arithmetic and differ in f32 summation order.
Quantisation is discontinuous: where the two LayerNorms (f32 in JAX, f64
rounded to f32 in the port) or the two hidden activations differ by an ulp at
a rounding boundary, one int8 code differs and the whole output row moves by
about a quantum times a weight (1e-3..1e-2), and the rows that share its
image by about 1/N of that through the attention. At these sizes (a thousand
codes per case, one in 1e5 near a boundary) that is rare but possible, so a
case may have `FLIP_ROWS` rows outside the bar, none of them by more than
`FLIP_ATOL`; the count of rows outside and of differing LayerNorm codes is
printed (`pytest -s` shows it).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoders import SPECS, _tree_leaves as _leaves, small_specs
from paths_tpu.encoders import vit as jvit
from paths_tpu.kernels import vit_fused as jvf
from paths_tpu.kernels import vit_int8 as jvi
from paths_tpu_torch import convert
from paths_tpu_torch.encoders import registry as tregistry
from paths_tpu_torch.encoders import vit as tvit
from paths_tpu_torch.kernels import vit_int8 as tvi

ATOL = 2e-5
FLIP_ROWS = 2
FLIP_ATOL = 5e-2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jvi, "INTERPRET", True)
    monkeypatch.setattr(jvf, "INTERPRET", True)


def _close(got, want, what):
    """Rows of (.., D) arrays within ATOL, but for FLIP_ROWS flipped rows."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    rows = err.reshape(-1, err.shape[-1]).max(-1)
    outside = int((rows > ATOL).sum())
    print(f"{what}: max err {rows.max():.3g}, rows outside {ATOL}: {outside} "
          f"of {rows.size}")
    assert outside <= FLIP_ROWS and rows.max() <= FLIP_ATOL, \
        (what, outside, float(rows.max()))


def _block(d, hidden, packed, seed, ls=True):
    """One block's f32 parameters in the JAX layout, all of them random."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    blk = {"norm1": {"scale": 1.0 + 0.1 * f(d), "bias": 0.1 * f(d)},
           "attn": {"qkv_w": f(d, 3 * d, scale=d ** -0.5), "qkv_b": 0.1 * f(3 * d),
                    "proj_w": f(d, d, scale=d ** -0.5), "proj_b": 0.1 * f(d)},
           "norm2": {"scale": 1.0 + 0.1 * f(d), "bias": 0.1 * f(d)},
           "mlp": {"fc1_w": f(d, packed * hidden, scale=d ** -0.5),
                   "fc1_b": 0.1 * f(packed * hidden),
                   "fc2_w": f(hidden, d, scale=hidden ** -0.5),
                   "fc2_b": 0.1 * f(d)}}
    if ls:
        blk["ls1"], blk["ls2"] = 1.0 + 0.1 * f(d), 1.0 + 0.1 * f(d)
    return blk


def _jax_quantized(blk):
    """The JAX package's quantised block of f32 numpy block `blk`."""
    q = jvi.quantize_vit_blocks({"blocks": [blk]})["blocks"][0]
    as_jnp = lambda n: ({k: as_jnp(v) for k, v in n.items()}
                        if isinstance(n, dict) else jnp.asarray(n))
    return as_jnp(q)


def _torch_quantized(blk):
    """The port's quantised block: matrices transposed to (out, in) first."""
    t = lambda a: torch.from_numpy(np.asarray(a))
    out = {}
    for key, val in blk.items():
        if not isinstance(val, dict):
            out[key] = t(val)
            continue
        out[key] = {k: (tvi.quantize_weight(t(v).T.contiguous())
                        if k.endswith("_w") else t(v)) for k, v in val.items()}
    return out


def _ln_code_flips(blk, x, norm):
    """How many int8 codes of the quantised LayerNorm output differ between
    the two packages on x (rows, D)."""
    jq, _ = jvi._quant_rows(jvf._layernorm(jnp.asarray(x), blk[norm]["scale"],
                                           blk[norm]["bias"]))
    tq, _ = tvi._quant_rows(tvi._ln64(torch.from_numpy(x),
                                      torch.from_numpy(blk[norm]["scale"]),
                                      torch.from_numpy(blk[norm]["bias"])))
    return int((np.asarray(jq, np.int32) != tq.numpy().astype(np.int32)).sum())


# ------------------------------------------------------------ the quantiser

@pytest.mark.parametrize("shape", [(16, 24), (3, 32, 64)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 3] = 0.0                                   # a zero output channel
    want = jvi.quantize_weight(w)                     # (.., in, out)
    got = tvi.quantize_weight(torch.from_numpy(w).transpose(-1, -2).contiguous())
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert np.array_equal(got["q"].numpy(), np.swapaxes(want["q"], -1, -2))
    assert got["s"].numpy().tobytes() == np.asarray(want["s"]).tobytes()
    assert (got["s"][..., 3] == 1.0).all() and not got["q"][..., 3, :].any()


def test_quantize_vit_blocks_drops_float_matrices():
    _, tspec = jvit.ViTSpec, tvit.ViTSpec
    model = tvit.vit_init(0, tspec(img_size=32, patch_size=8, embed_dim=32,
                                   depth=2, num_heads=2, mlp_ratio=2.0))
    floats = sum(p.numel() * p.element_size() for p in model.parameters())
    want = tvi.quantize_weight(model.blocks[1].fc1.weight)
    assert not model.quantized
    assert tvi.quantize_vit_blocks(model) is model and model.quantized
    blk = model.blocks[1]
    assert blk.fc1.weight is None and "weight" not in dict(blk.fc1.named_parameters())
    assert torch.equal(blk.fc1.weight_q, want["q"])
    assert torch.equal(blk.fc1.weight_s, want["s"])
    kept = sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
    block_floats = 2 * 4 * (32 * 96 + 32 * 32 + 2 * 32 * 64)
    assert kept == floats - block_floats + block_floats // 4 + 2 * 4 * (
        96 + 32 + 64 + 32)
    assert "weight_q" in dict(model.blocks[0].qkv.named_buffers())
    tvi.quantize_vit_blocks(model)                    # a second call is a no-op
    assert torch.equal(blk.fc1.weight_q, want["q"])


# ------------------------------------------- plain versions vs Pallas kernels

def _x(b, n, d, seed):
    return np.random.default_rng(seed).normal(size=(b, n, d)).astype(np.float32)


@pytest.mark.parametrize("ls", [True, False])
@pytest.mark.parametrize("n,heads", [(17, 2), (16, 1)])
def test_attn_i8_plain_matches_pallas(ls, n, heads):
    blk = _block(64, 128, 1, seed=n, ls=ls)
    x = _x(3, n, 64, seed=1)
    jb, tb = _jax_quantized(blk), _torch_quantized(blk)
    want = np.asarray(jvi.fused_attn_block_i8(
        jnp.asarray(x), jb["norm1"]["scale"], jb["norm1"]["bias"],
        jb["attn"]["qkv_w"], jb["attn"]["proj_w"], jb["attn"]["qkv_b"],
        jb["attn"]["proj_b"], jb.get("ls1"), num_heads=heads))
    got = tvi.fused_attn_block_i8(
        torch.from_numpy(x), tb["norm1"]["scale"], tb["norm1"]["bias"],
        tb["attn"]["qkv_w"], tb["attn"]["proj_w"], tb["attn"]["qkv_b"],
        tb["attn"]["proj_b"], tb.get("ls1"), num_heads=heads)
    assert got.dtype == torch.float32 and got.shape == x.shape
    flips = _ln_code_flips(blk, x.reshape(-1, 64), "norm1")
    _close(got.numpy(), want, f"attn_i8 ({flips} LayerNorm codes differ)")


@pytest.mark.parametrize("exact_gelu", [True, False])
@pytest.mark.parametrize("num_chunks", [1, 2])
def test_mlp_i8_plain_matches_pallas(exact_gelu, num_chunks):
    blk = _block(32, 128, 1, seed=3)
    x = _x(2, 16, 32, seed=4)
    jb, tb = _jax_quantized(blk), _torch_quantized(blk)
    want = np.asarray(jvi.fused_mlp_block_i8(
        jnp.asarray(x), jb["norm2"]["scale"], jb["norm2"]["bias"],
        jb["mlp"]["fc1_w"], jb["mlp"]["fc1_b"], jb["mlp"]["fc2_w"],
        jb["mlp"]["fc2_b"], jb["ls2"], exact_gelu=exact_gelu,
        num_chunks=num_chunks))
    got = tvi.fused_mlp_block_i8(
        torch.from_numpy(x), tb["norm2"]["scale"], tb["norm2"]["bias"],
        tb["mlp"]["fc1_w"], tb["mlp"]["fc1_b"], tb["mlp"]["fc2_w"],
        tb["mlp"]["fc2_b"], tb["ls2"], exact_gelu=exact_gelu,
        num_chunks=num_chunks)
    flips = _ln_code_flips(blk, x.reshape(-1, 32), "norm2")
    _close(got.numpy(), want, f"mlp_i8 ({flips} LayerNorm codes differ)")


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_swiglu_i8_plain_matches_pallas(num_chunks):
    blk = _block(32, 128, 2, seed=5)
    x = _x(2, 16, 32, seed=6)
    jb, tb = _jax_quantized(blk), _torch_quantized(blk)
    want = np.asarray(jvi.fused_swiglu_mlp_block_i8(
        jnp.asarray(x), jb["norm2"]["scale"], jb["norm2"]["bias"],
        jb["mlp"]["fc1_w"], jb["mlp"]["fc1_b"], jb["mlp"]["fc2_w"],
        jb["mlp"]["fc2_b"], jb["ls2"], num_chunks=num_chunks))
    got = tvi.fused_swiglu_mlp_block_i8(
        torch.from_numpy(x), tb["norm2"]["scale"], tb["norm2"]["bias"],
        tb["mlp"]["fc1_w"], tb["mlp"]["fc1_b"], tb["mlp"]["fc2_w"],
        tb["mlp"]["fc2_b"], tb["ls2"], num_chunks=num_chunks)
    flips = _ln_code_flips(blk, x.reshape(-1, 32), "norm2")
    _close(got.numpy(), want, f"swiglu_i8 ({flips} LayerNorm codes differ)")


def test_num_chunks_changes_the_numbers():
    """The hidden activation's row scale is taken per chunk: 1 and 2 chunks
    are different functions, far apart next to the bar."""
    blk = _torch_quantized(_block(32, 128, 1, seed=3))
    x = torch.from_numpy(_x(2, 16, 32, seed=4))
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"], None)
    one = tvi.fused_mlp_block_i8(*args, num_chunks=1)
    two = tvi.fused_mlp_block_i8(*args, num_chunks=2)
    assert (one - two).abs().max() > 100 * ATOL
    with pytest.raises(ValueError, match="must divide"):
        tvi.fused_mlp_block_i8(*args, num_chunks=3)


@pytest.mark.parametrize("case", ["gelu", "gelu_2chunks", "tanh", "swiglu",
                                  "swiglu_2chunks", "no_layerscale"])
def test_block_reference_matches_jax_reference(case):
    """The port's whole-block plain version against JAX's
    `int8_block_reference` (f32 attention, no Pallas)."""
    swiglu = case.startswith("swiglu")
    chunks = 2 if case.endswith("2chunks") else 1
    blk = _block(32, 128, 2 if swiglu else 1, seed=7,
                 ls=case != "no_layerscale")
    x = _x(2, 16, 32, seed=8)
    kw = dict(num_heads=2, swiglu=swiglu, exact_gelu=case != "tanh",
              num_chunks=chunks)
    want = np.asarray(jvi.int8_block_reference(_jax_quantized(blk),
                                               jnp.asarray(x), **kw))
    got = tvi.int8_block_reference(_torch_quantized(blk), torch.from_numpy(x),
                                   **kw)
    flips = _ln_code_flips(blk, x.reshape(-1, 32), "norm1")
    _close(got.numpy(), want, f"block {case} ({flips} LayerNorm codes differ)")


def test_bf16_plain_version_rounds_where_the_kernel_does():
    """bf16 x: qkv and P are rounded to bf16, the context and both
    quantisations stay f32. Against the Pallas kernel in bf16 the bar is 2
    bf16 ulps of the largest output."""
    blk = _block(64, 128, 1, seed=9)
    x = torch.from_numpy(_x(2, 17, 64, seed=10)).bfloat16()
    jb, tb = _jax_quantized(blk), _torch_quantized(blk)
    want = np.asarray(jvi.fused_attn_block_i8(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jb["norm1"]["scale"],
        jb["norm1"]["bias"], jb["attn"]["qkv_w"], jb["attn"]["proj_w"],
        jb["attn"]["qkv_b"], jb["attn"]["proj_b"], jb["ls1"],
        num_heads=1).astype(jnp.float32))
    got = tvi.fused_attn_block_i8(
        x, tb["norm1"]["scale"], tb["norm1"]["bias"], tb["attn"]["qkv_w"],
        tb["attn"]["proj_w"], tb["attn"]["qkv_b"], tb["attn"]["proj_b"],
        tb["ls1"], num_heads=1)
    assert got.dtype == torch.bfloat16
    tol = 2 * 2.0 ** -8 * float(np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() <= tol


# ------------------------- the staged decomposition of kernels #8 and #10
# The CUDA wrappers of #8 and #10 run a fixed sequence of launches through
# device-memory scratch; their pieces' plain versions, chained in that order,
# with those scratch layouts and (for #10) row slabs, must give the whole
# block's plain version to the bit: every piece does the same integer and f32
# operations on the same values, whatever the rows around it.

def _chain_case(b, n, d, hidden, packed, dtype, seed):
    blk = _torch_quantized(_block(d, hidden, packed, seed=seed))
    x = torch.from_numpy(_x(b, n, d, seed=seed + 1)).to(dtype)
    return blk, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads", [(17, 2), (50, 2), (33, 1)])
def test_attn_i8_chain_is_the_plain_version(dtype, n, heads):
    blk, x = _chain_case(3, n, 64 * heads, 128, 1, dtype, seed=n)
    args = (x, blk["norm1"]["scale"], blk["norm1"]["bias"], blk["attn"]["qkv_w"],
            blk["attn"]["proj_w"], blk["attn"]["qkv_b"], blk["attn"]["proj_b"],
            blk["ls1"])
    want = tvi.fused_attn_block_i8_reference(*args, num_heads=heads)
    got = tvi.attn_i8_chain(*args, num_heads=heads)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_chunks,slab_rows", [
    (1, 64), (2, 64),
    # chunks of 64 columns: each ends inside a 128-column slab of the GEMM
    (8, 64),
    (2, tvi.MLP_SLAB_ROWS)], ids=["1chunk", "2chunks", "64col-chunks", "one-slab"])
def test_swiglu_i8_chain_is_the_plain_version(dtype, num_chunks, slab_rows):
    # 150 rows: slabs of 64 rows end at 64 and 128, the last holds 22
    blk, x = _chain_case(3, 50, 64, 512, 2, dtype, seed=11)
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"],
            blk["ls2"])
    want = tvi.fused_swiglu_mlp_block_i8_reference(*args, num_chunks=num_chunks)
    got = tvi.swiglu_i8_chain(*args, num_chunks=num_chunks, slab_rows=slab_rows)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact_gelu,num_chunks,slab_rows", [
    (True, 1, 64), (True, 2, 64), (False, 1, 64),
    # chunks of 64 columns: each ends inside a 128-column slab of the GEMM
    (True, 8, 64),
    (True, 2, tvi.MLP_SLAB_ROWS)],
    ids=["1chunk", "2chunks", "tanh", "64col-chunks", "one-slab"])
def test_mlp_i8_chain_is_the_plain_version(dtype, exact_gelu, num_chunks,
                                           slab_rows):
    """Kernel #9's pieces chained as its wrapper launches them, in its row
    slabs (150 rows: slabs of 64 end at 64 and 128, the last holds 22)."""
    blk, x = _chain_case(3, 50, 64, 512, 1, dtype, seed=14)
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"],
            blk["ls2"])
    kw = dict(exact_gelu=exact_gelu, num_chunks=num_chunks)
    want = tvi.fused_mlp_block_i8_reference(*args, **kw)
    got = tvi.mlp_i8_chain(*args, **kw, slab_rows=slab_rows)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.fixture
def _one_thread():
    """One CPU thread: PyTorch's vectorised and scalar exp may differ in the
    last bit, and how it cuts a large elementwise op between threads decides
    which elements take which; on one thread the cut is by rows alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_swiglu_i8_chain_crosses_the_wrappers_slab(_one_thread, num_chunks):
    """The wrapper's own slab size, at a row count that is no multiple of it."""
    rows = tvi.MLP_SLAB_ROWS + 104
    blk, x = _chain_case(2, rows // 2, 64, 128, 2, torch.float32, seed=12)
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"], None)
    want = tvi.fused_swiglu_mlp_block_i8_reference(*args, num_chunks=num_chunks)
    got = tvi.swiglu_i8_chain(*args, num_chunks=num_chunks)
    assert torch.equal(got, want)


def test_chain_pieces_keep_the_scratch_layouts():
    """The pieces' shapes and types are the wrappers' scratch: codes (M, D)
    int8, one f32 scale per row (and chunk), the f32 context, and the byte
    counts the wrappers document."""
    blk, x = _chain_case(2, 9, 128, 256, 2, torch.bfloat16, seed=13)
    rows = x.reshape(18, 128)
    codes, scales = tvi.ln_quant_rows_reference(rows, blk["norm1"]["scale"],
                                                blk["norm1"]["bias"])
    assert codes.dtype == torch.int8 and codes.shape == (18, 128)
    assert scales.dtype == torch.float32 and scales.shape == (18,)
    qkv = tvi.qkv_i8_reference(codes, scales, blk["attn"]["qkv_w"],
                               blk["attn"]["qkv_b"], x.dtype)
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (18, 384)
    ctx = tvi.attention_ctx_reference(qkv.view(2, 9, 384), 2)
    assert ctx.dtype == torch.float32 and ctx.shape == (2, 9, 128)
    h = tvi.swiglu_fc1_i8_reference(codes, scales, blk["mlp"]["fc1_w"],
                                    blk["mlp"]["fc1_b"])
    hq, hs = tvi.quant_rows_reference(h, 64)
    assert h.dtype == torch.float32 and h.shape == (18, 256)
    assert hq.dtype == torch.int8 and hs.shape == (18, 4)
    assert hq.abs().max() <= 127 and (hq.abs().amax(-1) >= 126).all()
    assert tvi.attn_i8_scratch_bytes(2, 9, 128, torch.bfloat16) == \
        18 * 128 + 4 * 18 + 2 * 18 * 384 + 4 * 18 * 128
    assert tvi.mlp_i8_scratch_bytes(2, 9, 128, 256, 4) == \
        18 * 128 + 4 * 18 + 5 * 18 * 256 + 4 * 18 * 4
    assert tvi.mlp_i8_scratch_bytes(2, 5000, 128, 256, 1) == \
        10000 * 128 + 4 * 10000 + 4 * tvi.MLP_SLAB_ROWS * 256 + 10000 * 256 + \
        4 * 10000


# ----------------------------------------------- the route, the converters

@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("shape", sorted(SPECS))
def test_vit_apply_int8_matches_jax(shape, stacked):
    """The int8 route on a quantised JAX tree carried over by `vit_from_jax`
    (list or stacked) against JAX's int8 route: features are O(1), two blocks
    deep; the bar is the whole-forward bar of the other routes (1e-4) unless
    a code flipped (FLIP_ATOL)."""
    jspec, tspec = small_specs(**SPECS[shape])
    params = jvit.vit_init(3, jspec)
    if stacked:
        params = jvit.stack_vit_blocks(params)
    qparams = jvi.quantize_vit_blocks(params)
    model = convert.vit_from_jax(qparams, tspec)
    assert model.quantized
    imgs = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_apply(qparams, jnp.asarray(imgs),
                                     compute_dtype=jnp.float32,
                                     attn_impl="int8"))
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.float32, "int8")
    assert got.dtype == torch.float32 and got.shape == (3, tspec.out_dim)
    err = np.abs(got.numpy() - want).max(-1)
    print(f"int8 route {shape}: per-image max err {err}")
    assert (err > 1e-4).sum() <= 1 and err.max() <= FLIP_ATOL

    # and back: the quantised tree crosses the converters unchanged
    back = dict(_leaves(convert.vit_to_jax(model)))
    src = qparams if not stacked else jvi.quantize_vit_blocks(
        jvit.vit_init(3, jspec))
    for key, arr in _leaves(src):
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key
    assert sorted(back) == sorted(k for k, _ in _leaves(src))


@pytest.mark.parametrize("swiglu", [False, True])
def test_int8_route_close_to_the_f32_route(swiglu):
    """The quantisation error itself, as the JAX tests bound it: int8
    features within 2e-2 of the largest f32 feature, cosine above 0.999."""
    kw = SPECS["swiglu_registers"] if swiglu else SPECS["layerscale"]
    _, tspec = small_specs(**kw)
    model = tvit.vit_init(7, tspec)
    imgs = torch.from_numpy(np.random.default_rng(8).uniform(
        size=(2, 32, 32, 3)).astype(np.float32))
    ref = tvit.vit_apply(model, imgs, torch.float32, "xla").numpy()
    got = tvit.vit_apply(tvi.quantize_vit_blocks(model), imgs, torch.float32,
                         "int8").numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > 0.999


def test_int8_requires_quantized_params():
    _, tspec = small_specs()
    imgs = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="quantized"):
        tvit.vit_apply(tvit.vit_init(0, tspec), imgs, block_impl="int8")


@pytest.mark.parametrize("impl", ["xla", "fused", "fused1", "flash"])
def test_non_int8_rejects_quantized_params(impl):
    _, tspec = small_specs()
    model = tvi.quantize_vit_blocks(tvit.vit_init(0, tspec))
    with pytest.raises(ValueError, match="int8-quantized"):
        tvit.vit_apply(model, torch.zeros(1, 32, 32, 3), block_impl=impl)


ZOO = ["uni", "virchow2", "kaiko-vits16", "kaiko-vits8", "kaiko-vitb16",
       "kaiko-vitb8", "kaiko-vitl14"]


@pytest.mark.parametrize("impl", ["int8", "fused1"])
@pytest.mark.parametrize("name", ZOO)
def test_from_name_routes_on_the_cpu(monkeypatch, name, impl):
    """Every ViT of the zoo at full width, one block deep, through
    `from_name` on a requested CPU: finite features of the right shape, close
    to the plain route's."""
    shallow = {k: (dataclasses.replace(spec, depth=1), tspec)
               for k, (spec, tspec) in tregistry._VIT_SPECS.items()}
    monkeypatch.setattr(tregistry, "_VIT_SPECS", shallow)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 224, 224, 3), np.uint8))
    kw = dict(compute_dtype=torch.float32, device="cpu", seed=0)
    encode, dim, _ = tregistry.from_name(name, block_impl=impl, **kw)
    ref, _, _ = tregistry.from_name(name, block_impl="xla", **kw)
    out, want = encode(imgs), ref(imgs)
    assert out.shape == (1, dim) and torch.isfinite(out).all()
    bar = 5e-2 if impl == "int8" else 1e-4
    assert (out - want).abs().max() / want.abs().max() < bar


def test_cli_int8_matches_jax_cli(tmp_path):
    """Both CLIs with `--block-impl int8` on one small slide with
    kaiko-vits16 from the same seed (bit-identical float weights, so
    bit-identical int8 weights). Both compute in bf16, where the two
    frameworks' activations differ by bf16 roundings (2^-8), far more than a
    code's rounding interval, so codes differ freely through 12 blocks: the
    two runs differ by about the quantisation error itself, which the JAX
    tests bound by 5e-2 for this encoder. Measured here: 2.9e-2 of the
    feature norm."""
    from test_torch_preprocess import JStore, TStore, make_fake_slide

    from paths_tpu.cli.preprocess import main as jmain
    from paths_tpu_torch.cli.preprocess import main as tmain

    img, _ = make_fake_slide(rows=448, cols=448)
    d = tmp_path / "slides"
    d.mkdir()
    np.save(str(d / "s1.npy"), img)
    argv = ["-m", "kaiko-vits16", "-d", str(d), "-b", "4", "-p", "224", "-ms",
            "10.0", "--default-power", "10.0", "--ext", ".npy", "--block-impl",
            "int8"]
    jmain(argv + ["-o", str(tmp_path / "jax")])
    stats = tmain(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    assert stats["h2d_bytes"] > 0
    want = np.asarray(JStore(str(tmp_path / "jax")).load("s1", 10.0))
    got = np.asarray(TStore(str(tmp_path / "torch")).load("s1", 10.0))
    assert got.shape == want.shape == (2, 2, 384)
    cells = np.abs(want).sum(-1) > 0
    assert cells.any() and np.array_equal(cells, np.abs(got).sum(-1) > 0)
    rel = (np.linalg.norm(got - want, axis=-1)[cells]
           / np.linalg.norm(want, axis=-1)[cells])
    print(f"int8 CLIs: |diff|/|feature| per tissue cell {rel}")
    assert rel.max() < 5e-2


def test_cpu_calls_launch_nothing():
    before = (tvi.fused_attn_block_i8.launches, tvi.fused_mlp_block_i8.launches,
              tvi.fused_swiglu_mlp_block_i8.launches)
    blk = _torch_quantized(_block(32, 128, 1, seed=0))
    tvi.int8_block_reference(blk, torch.from_numpy(_x(1, 4, 32, 0)), num_heads=2)
    tvi.fused_mlp_block_i8(
        torch.from_numpy(_x(1, 4, 32, 0)), blk["norm2"]["scale"],
        blk["norm2"]["bias"], blk["mlp"]["fc1_w"], blk["mlp"]["fc1_b"],
        blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"], None)
    assert before == (tvi.fused_attn_block_i8.launches,
                      tvi.fused_mlp_block_i8.launches,
                      tvi.fused_swiglu_mlp_block_i8.launches)


class _FakeCuda:
    """Stands in for a CUDA tensor in the wrappers' checks, which run before
    anything touches the card."""

    def __init__(self, t, device="cuda:0"):
        self._t = t
        self.device = torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_wrapper_refuses_unquantized_and_misshapen_weights():
    x = _FakeCuda(torch.zeros(2, 5, 64))
    good = {"q": _FakeCuda(torch.zeros(192, 64, dtype=torch.int8)),
            "s": _FakeCuda(torch.ones(192))}
    tvi._check_quantized(x, "qkv_wq", good, (192, 64))
    with pytest.raises(TypeError, match="quantized weight"):
        tvi._check_quantized(x, "qkv_wq", torch.zeros(192, 64), (192, 64))
    with pytest.raises(ValueError, match="is on"):
        tvi._check_quantized(x, "qkv_wq", tvi.quantize_weight(
            torch.ones(192, 64)), (192, 64))
    with pytest.raises(TypeError, match="int8 codes"):
        tvi._check_quantized(x, "qkv_wq", dict(good, q=_FakeCuda(
            torch.zeros(192, 64))), (192, 64))
    with pytest.raises(ValueError, match="layout"):
        tvi._check_quantized(x, "qkv_wq", good, (64, 192))


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_mlp_i8_chain_crosses_the_wrappers_slab(_one_thread, num_chunks):
    """Kernel #9's chain at the wrapper's own slab size, at a row count that
    is no multiple of it."""
    rows = tvi.MLP_SLAB_ROWS + 104
    blk, x = _chain_case(2, rows // 2, 64, 128, 1, torch.float32, seed=15)
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], blk["mlp"]["fc1_w"],
            blk["mlp"]["fc1_b"], blk["mlp"]["fc2_w"], blk["mlp"]["fc2_b"], None)
    want = tvi.fused_mlp_block_i8_reference(*args, num_chunks=num_chunks)
    got = tvi.mlp_i8_chain(*args, num_chunks=num_chunks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("packed", [1, 2], ids=["gelu", "swiglu"])
def test_mlp_i8_scratch_is_what_the_gelu_pieces_take(packed):
    """Kernel #9's scratch (and #10's, whose fc1 has 2H rows) is the pieces'
    tensors: LN codes and scales, one slab of the f32 hidden activation, the
    hidden codes and their per-chunk scales."""
    b, n, d, hidden, chunks = 2, 9, 128, 256, 4
    blk, x = _chain_case(b, n, d, hidden, packed, torch.float32, seed=16)
    rows = x.reshape(b * n, d)
    codes, scales = tvi.ln_quant_rows_reference(rows, blk["norm2"]["scale"],
                                                blk["norm2"]["bias"])
    if packed == 1:
        h = tvi.gelu_fc1_i8_reference(codes, scales, blk["mlp"]["fc1_w"],
                                      blk["mlp"]["fc1_b"])
    else:
        h = tvi.swiglu_fc1_i8_reference(codes, scales, blk["mlp"]["fc1_w"],
                                        blk["mlp"]["fc1_b"])
    hq, hs = tvi.quant_rows_reference(h, hidden // chunks)
    assert h.dtype == torch.float32 and h.shape == (b * n, hidden)
    nbytes = sum(t.numel() * t.element_size() for t in (codes, scales, h, hq, hs))
    assert tvi.mlp_i8_scratch_bytes(b, n, d, hidden, chunks) == nbytes
    assert tvi.mlp_i8_scratch_bytes(b, n, d, hidden, chunks, slab_rows=8) == \
        nbytes - 4 * (b * n - 8) * hidden
