"""Int8 fused ViT encoder-block kernels: the hand-written CUDA kernels, their
plain PyTorch versions and the weight quantiser (forward only: the patch
encoders are frozen).

Replaces the TPU kernels of `paths_tpu/kernels/vit_int8.py`:
`fused_attn_block_i8` (body `_attn_kernel_i8`), `fused_mlp_block_i8`
(`_mlp_kernel_i8`) and `fused_swiglu_mlp_block_i8` (`_swiglu_kernel_i8`). The
CUDA source is `paths_tpu_torch/csrc/vit_int8.cu`, built for sm_90a by
`kernels.build` and called through ctypes; what bounds each kernel on the card
and how its design answers that is noted at the top of the source.

The block's four projections (qkv, attention out, fc1, fc2) multiply int8
activations with int8 weights into int32 and rescale in f32; the attention
itself, GELU and SiLU stay in the compute dtype / f32:

  * weights: symmetric int8 per output channel, quantised once
    (`quantize_weight`, `quantize_vit_blocks`). A weight is a dict
    `{"q": int8 (out, in), "s": f32 (out,)}`: `nn.Linear`'s layout, one scale
    per row;
  * activations: symmetric int8 per token (row), `s = max|y| * (1/127)`
    (`s = 1` for a row of zeros), `q = clip(round_half_even(y / s), -127,
    127)`, taken from the f32 LayerNorm output, from each row of the f32
    context, and from the hidden activation. The hidden activation's row scale
    is the abs-max over one of `num_chunks` spans of the hidden columns, so
    `num_chunks` changes the numbers (it is the TPU kernels' hidden-chunk grid
    axis); the encoder calls with 1.

The entries keep the JAX argument order. x is (B, N, D) in the compute dtype
(f32 or bf16); LayerNorm scale/bias, biases and LayerScale may be any float
dtype; `ls=None` means no LayerScale. The TPU tuning knob `group` has no
counterpart.

Kernels and plain versions compute the same arithmetic: integer products are
exact (the plain versions multiply the codes in f64), every f32 operation of a
rescale is rounded on its own, GELU is the rational erf of the TPU kernels
(Abramowitz-Stegun 7.1.26, not `erf`: a 1e-7 difference could move a code),
and the LayerNorm before a quantisation is evaluated in f64 and rounded to f32
once, so that a different summation order does not move a code.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor goes to the
plain versions. The kernels take head_dim 64, D a multiple of 64, hidden /
num_chunks a multiple of 64, and any number of tokens (#8's attention streams
K and V in key tiles, so the patch-8 Kaiko models' 785 tokens run as the
others do).

Kernels #8, #9 and #10 are fixed sequences of launches on the current
stream, through scratch that the wrapper allocates (`attn_i8_scratch_bytes`,
`mlp_i8_scratch_bytes`); the plain versions of those pieces
(`ln_quant_rows_reference`, `quant_rows_reference`, `qkv_i8_reference`,
`attention_ctx_reference`, `residual_i8_reference`, `gelu_fc1_i8_reference`,
`swiglu_fc1_i8_reference`) chained as the wrappers chain the launches give
the whole block's plain version to the bit (`attn_i8_chain`, `mlp_i8_chain`,
`swiglu_i8_chain`):

  * #8: LN-quant (codes (B N, D) int8 and a scale per row) -> qkv s8 GEMM
    (+ bias, rounded to the compute dtype, (B, N, 3D)) -> attention (context
    f32, unrounded, (B, N, D)) -> quantise the context per row (into the same
    codes and scales) -> out-projection s8 GEMM (+ bias, LayerScale,
    residual);
  * #9 and #10: LN-quant over all rows, then per slab of `MLP_SLAB_ROWS` rows
    the fc1 s8 GEMM (GELU for #9, gated SwiGLU over the packed weight for
    #10; hidden (slab, H) f32) -> quantise the hidden activation per row and
    chunk (into codes (B N, H) int8 and scales (B N, num_chunks)); then one
    fc2 s8 GEMM over all rows (the chunks' sums added in f32, + bias,
    LayerScale, residual). The slab bounds the f32 hidden scratch, which is
    what the int8 route saves memory for.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from paths_tpu_torch.kernels import build
from paths_tpu_torch.kernels.vit_fused import (
    ACTS,
    DTYPES,
    HEAD_DIM,
    LN_EPS,
    _check_x,
    _vector,
)

_INV_127 = 1.0 / 127.0
# Rows of one slab of kernels #9 and #10: their f32 hidden activation goes
# through device memory a slab at a time (113 MB at a hidden width of 6912,
# 67 MB at UNI's 4096).
MLP_SLAB_ROWS = 4096


# --------------------------------------------------------------- quantising

def _round(t: torch.Tensor) -> torch.Tensor:
    """Round half to even, as the kernels' `rintf`."""
    return torch.round(t)


def _quant_rows(y: torch.Tensor):
    """f32 (..., d) -> (codes as f64 (..., d), f32 scales (..., 1)):
    symmetric per row, abs-max; a row of zeros gets scale 1."""
    s = y.abs().amax(-1, keepdim=True) * _INV_127
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(_round(y / s), -127.0, 127.0).double(), s


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric int8 per output channel of a (..., out, in) matrix (leading
    axes pass through): `{"q": int8 (..., out, in), "s": f32 (..., out)}`."""
    w32 = w.detach().float()
    s = w32.abs().amax(-1, keepdim=True) * _INV_127
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(w32 / s), -127.0, 127.0).to(torch.int8)
    return {"q": q.contiguous(), "s": s[..., 0].contiguous()}


_LINEARS = ("qkv", "proj", "fc1", "fc2")


def quantize_vit_blocks(model):
    """Quantise the four projections of every block of a ViT in place and
    return it: each `nn.Linear` gets the buffers `weight_q` (int8) and
    `weight_s` (f32) and gives up its float `weight` (that is where the memory
    goes); norms, biases, LayerScale and embeddings stay f32."""
    for blk in model.blocks:
        if is_quantized(blk):
            continue
        for name in _LINEARS:
            lin = getattr(blk, name)
            set_quantized(lin, quantize_weight(lin.weight))
    return model


def set_quantized(lin: torch.nn.Linear, wq: dict) -> None:
    """Make `lin` hold the quantised weight `wq` in place of its float one."""
    lin.weight = None
    lin.register_buffer("weight_q", wq["q"].to(torch.int8).contiguous())
    lin.register_buffer("weight_s", wq["s"].float().contiguous())


def is_quantized(blk) -> bool:
    return blk.qkv.weight is None


def quantized_weights(blk) -> dict:
    """The four quantised matrices of a block, by projection name."""
    return {name: {"q": getattr(blk, name).weight_q,
                   "s": getattr(blk, name).weight_s} for name in _LINEARS}


# ------------------------------------------------------------ plain versions

def _ln64(x, scale, bias):
    """LayerNorm (eps 1e-6) in f64, rounded to f32 once."""
    x64 = x.double()
    mu = x64.mean(-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(-1, keepdim=True)
    y = (x64 - mu) * (1.0 / torch.sqrt(var + LN_EPS))
    return (y * scale.double() + bias.double()).float()


def _qmatmul(y, wq, bias):
    """quant(y) wq^T rescaled: float(acc) * row scale * channel scale + bias,
    the integer sum exact (f64 holds it)."""
    yq, ys = _quant_rows(y)
    acc = (yq @ wq["q"].double().T).float()
    return acc * ys * wq["s"].float() + bias.float()


def _erf(x):
    """Abramowitz-Stegun 7.1.26, operation by operation as the kernels."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-(ax * ax)))


def _gelu(h, exact: bool):
    if exact:
        return 0.5 * h * (1.0 + _erf(h * (1.0 / math.sqrt(2.0))))
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                  * (h + 0.044715 * (h * h * h))))
    return h * cdf


def _fc2_chunks(h, fc2_wq, num_chunks: int):
    """sum over chunks of quant(h chunk) fc2^T * row scale * channel scale."""
    hidden = h.shape[-1]
    if num_chunks < 1 or hidden % num_chunks:
        raise ValueError(f"num_chunks={num_chunks} must divide {hidden}")
    hc = hidden // num_chunks
    w2 = fc2_wq["q"].double()
    out = torch.zeros(*h.shape[:-1], w2.shape[0], dtype=torch.float32,
                      device=h.device)
    for c in range(num_chunks):
        hq, hs = _quant_rows(h[..., c * hc:(c + 1) * hc])
        f2 = (hq @ w2[:, c * hc:(c + 1) * hc].T).float()
        out = out + f2 * hs * fc2_wq["s"].float()
    return out


def _residual(x, branch, ls):
    if ls is not None:
        branch = branch * ls.float()
    return (x.float() + branch).to(x.dtype)


def fused_attn_block_i8_reference(x, norm_scale, norm_bias, qkv_wq, proj_wq,
                                  qkv_b, proj_b, ls=None, *, num_heads: int):
    """Plain version of kernel #8: f64-evaluated LN -> int8 qkv -> per-head
    softmax attention in the compute dtype (division deferred past P V, the
    context kept f32) -> int8 out projection -> LayerScale -> residual."""
    cd = x.dtype
    b, n, d = x.shape
    hd = d // num_heads
    y = _ln64(x, norm_scale, norm_bias)
    qkv = _qmatmul(y, qkv_wq, qkv_b).to(cd)
    q, k, v = qkv.view(b, n, 3, num_heads, hd).float().unbind(2)  # (B,N,H,hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)                                   # (B,H,N,1)
    c = torch.einsum("bhqk,bkhd->bhqd", p.to(cd).float(), v)
    ctx = (c / l).permute(0, 2, 1, 3).reshape(b, n, d)            # f32
    return _residual(x, _qmatmul(ctx, proj_wq, proj_b), ls)


def fused_mlp_block_i8_reference(x, norm_scale, norm_bias, fc1_wq, fc1_b,
                                 fc2_wq, fc2_b, ls=None, *,
                                 exact_gelu: bool = True, num_chunks: int = 1):
    """Plain version of kernel #9: f64-evaluated LN -> int8 fc1 -> GELU
    (rational erf, or tanh) -> hidden quantised per row and chunk -> int8 fc2
    -> LayerScale -> residual."""
    y = _ln64(x, norm_scale, norm_bias)
    h = _gelu(_qmatmul(y, fc1_wq, fc1_b), exact_gelu)
    out = _fc2_chunks(h, fc2_wq, num_chunks) + fc2_b.float()
    return _residual(x, out, ls)


def fused_swiglu_mlp_block_i8_reference(x, norm_scale, norm_bias, fc1_wq,
                                        fc1_b, fc2_wq, fc2_b, ls=None, *,
                                        num_chunks: int = 1):
    """Plain version of kernel #10: as #9 with the packed fc1 (gate rows
    first) and gate * sigmoid(gate) * value."""
    y = _ln64(x, norm_scale, norm_bias)
    gate, val = _qmatmul(y, fc1_wq, fc1_b).chunk(2, dim=-1)
    h = (gate * (1.0 / (1.0 + torch.exp(-gate)))) * val
    out = _fc2_chunks(h, fc2_wq, num_chunks) + fc2_b.float()
    return _residual(x, out, ls)


def int8_block_reference(blk: dict, x, *, num_heads: int, swiglu: bool = False,
                         exact_gelu: bool = True, num_chunks: int = 1):
    """One whole int8 block through the plain versions. `blk` has the JAX
    package's block layout with the port's matrices: `norm1`/`norm2`
    `{"scale", "bias"}`, `attn` `{"qkv_w", "qkv_b", "proj_w", "proj_b"}`,
    `mlp` `{"fc1_w", "fc1_b", "fc2_w", "fc2_b"}` (weights `{"q", "s"}`),
    optional `ls1`/`ls2`."""
    at, ml = blk["attn"], blk["mlp"]
    x = fused_attn_block_i8_reference(
        x, blk["norm1"]["scale"], blk["norm1"]["bias"], at["qkv_w"],
        at["proj_w"], at["qkv_b"], at["proj_b"], blk.get("ls1"),
        num_heads=num_heads)
    args = (x, blk["norm2"]["scale"], blk["norm2"]["bias"], ml["fc1_w"],
            ml["fc1_b"], ml["fc2_w"], ml["fc2_b"], blk.get("ls2"))
    if swiglu:
        return fused_swiglu_mlp_block_i8_reference(*args, num_chunks=num_chunks)
    return fused_mlp_block_i8_reference(*args, exact_gelu=exact_gelu,
                                        num_chunks=num_chunks)


# A check of a kernel against its plain version has to allow for a code that
# lands on the other side of a rounding boundary (the context and the hidden
# activation are f32 sums, taken in another order). These give the most that
# one such code moves an output: one step of the block's last quantisation
# times the largest dequantised weight and LayerScale.

def _code_step(act_max: float, wq: dict, ls) -> float:
    w_max = (wq["q"].float().abs().amax(-1) * wq["s"]).max().item()
    return act_max / 127.0 * w_max * (1.0 if ls is None
                                      else ls.float().abs().max().item())


def attn_output_quantum(x, norm_scale, norm_bias, qkv_wq, proj_wq, qkv_b,
                        proj_b=None, ls=None, **_) -> float:
    """Most that one context code moves an output of the int8 attention
    block: the context is a convex mix of value rows, so |v| bounds it."""
    d = x.shape[-1]
    v = _qmatmul(_ln64(x, norm_scale, norm_bias),
                 {"q": qkv_wq["q"][2 * d:], "s": qkv_wq["s"][2 * d:]},
                 qkv_b[2 * d:])
    return _code_step(v.abs().max().item(), proj_wq, ls)


def mlp_output_quantum(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq,
                       fc2_b=None, ls=None, *, swiglu: bool = False,
                       exact_gelu: bool = True, **_) -> float:
    """Most that one hidden code moves an output of an int8 MLP block."""
    h = _qmatmul(_ln64(x, norm_scale, norm_bias), fc1_wq, fc1_b)
    if swiglu:
        gate, val = h.chunk(2, dim=-1)
        h = (gate * (1.0 / (1.0 + torch.exp(-gate)))) * val
    else:
        h = _gelu(h, exact_gelu)
    return _code_step(h.abs().max().item(), fc2_wq, ls)


# ---------------------------------- plain versions of #8's, #9's and #10's pieces
# The wrappers of kernels #8-#10 run these steps as launches, through the
# scratch layouts named here; chained in the same order (`attn_i8_chain`,
# `mlp_i8_chain`, `swiglu_i8_chain`) they repeat the plain versions above to
# the bit.

def ln_quant_rows_reference(x, scale, bias):
    """LN-quant: codes (M, D) int8 and row scales (M,) f32 of the
    f64-evaluated LayerNorm of the rows of x (M, D)."""
    yq, ys = _quant_rows(_ln64(x, scale, bias))
    return yq.to(torch.int8), ys[:, 0]


def quant_rows_reference(y, span: int):
    """Codes (M, D) int8 of the f32 rows y (M, D), quantised per row over each
    span of `span` columns, and their scales (M, D // span) f32."""
    m, d = y.shape
    yq, ys = _quant_rows(y.view(m, d // span, span))
    return yq.to(torch.int8).view(m, d), ys[..., 0]


def _dequant(codes, scales, wq):
    """float(codes wq^T) * row scale * channel scale; the integer sum exact."""
    acc = (codes.double() @ wq["q"].double().T).float()
    return acc * scales[:, None] * wq["s"].float()


def qkv_i8_reference(codes, scales, wq, bias, dtype):
    """The qkv GEMM with its epilogue: the dequantised product + bias,
    rounded to `dtype`."""
    return (_dequant(codes, scales, wq) + bias.float()).to(dtype)


def gelu_fc1_i8_reference(codes, scales, wq, bias, exact_gelu: bool = True):
    """The fc1 GEMM of kernel #9 with its epilogue: the GELU (rational erf,
    or tanh) of the dequantised product + bias, in f32, (M, H)."""
    return _gelu(_dequant(codes, scales, wq) + bias.float(), exact_gelu)


def swiglu_fc1_i8_reference(codes, scales, wq, bias):
    """The gated fc1 GEMM over the packed (2H, D) weight, gate rows first:
    gate * sigmoid(gate) * value in f32, (M, H)."""
    gate, val = (_dequant(codes, scales, wq) + bias.float()).chunk(2, dim=-1)
    return (gate * (1.0 / (1.0 + torch.exp(-gate)))) * val


def residual_i8_reference(codes, scales, wq, bias, resid, ls):
    """The out-projection or fc2 GEMM with its epilogue: resid + (sum + bias)
    ls. `scales` (M, chunks): with one chunk, sum is the dequantised product;
    with more, the products of the chunks of K / chunks columns, each with its
    own row scale, added in f32 one chunk after the other onto zeros."""
    chunks = scales.shape[1]
    if chunks == 1:
        total = _dequant(codes, scales[:, 0], wq)
    else:
        span = codes.shape[1] // chunks
        total = torch.zeros(codes.shape[0], wq["q"].shape[0],
                            dtype=torch.float32, device=codes.device)
        for c in range(chunks):
            cols = slice(c * span, (c + 1) * span)
            total = total + _dequant(codes[:, cols], scales[:, c],
                                     {"q": wq["q"][:, cols], "s": wq["s"]})
    return _residual(resid, total + bias.float(), ls)


def attention_ctx_reference(qkv, num_heads: int):
    """The attention piece: per-head softmax attention of the (B, N, 3D) qkv
    scratch in its dtype, P rounded to it, the division deferred past P V and
    the context (B, N, D) left in f32."""
    cd = qkv.dtype
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    q, k, v = qkv.view(b, n, 3, num_heads, hd).float().unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    c = torch.einsum("bhqk,bkhd->bhqd", p.to(cd).float(), v)
    return (c / l).permute(0, 2, 1, 3).reshape(b, n, d)


def attn_i8_chain(x, norm_scale, norm_bias, qkv_wq, proj_wq, qkv_b, proj_b,
                  ls=None, *, num_heads: int):
    """Kernel #8's five launches through the plain versions of their pieces,
    in the wrapper's order and scratch layouts."""
    b, n, d = x.shape
    rows = x.reshape(b * n, d)
    codes, scales = ln_quant_rows_reference(rows, norm_scale, norm_bias)
    qkv = qkv_i8_reference(codes, scales, qkv_wq, qkv_b, x.dtype)
    ctx = attention_ctx_reference(qkv.view(b, n, 3 * d), num_heads)
    codes, scales = quant_rows_reference(ctx.reshape(b * n, d), d)
    return residual_i8_reference(codes, scales, proj_wq, proj_b, rows,
                                 ls).view(b, n, d)


def _mlp_i8_chain(x, norm_scale, norm_bias, fc2_wq, fc2_b, ls, fc1,
                  num_chunks: int, slab_rows: int):
    """The launches of kernel #9 or #10 through the plain versions of their
    pieces, with `fc1(codes, scales)` the fc1 GEMM of one row slab."""
    b, n, d = x.shape
    hidden = fc2_wq["q"].shape[1]
    rows = x.reshape(b * n, d)
    codes, scales = ln_quant_rows_reference(rows, norm_scale, norm_bias)
    hq = torch.empty(b * n, hidden, dtype=torch.int8, device=x.device)
    hs = torch.empty(b * n, num_chunks, dtype=torch.float32, device=x.device)
    for r0 in range(0, b * n, slab_rows):
        r1 = min(b * n, r0 + slab_rows)
        h = fc1(codes[r0:r1], scales[r0:r1])
        hq[r0:r1], hs[r0:r1] = quant_rows_reference(h, hidden // num_chunks)
    return residual_i8_reference(hq, hs, fc2_wq, fc2_b, rows, ls).view(b, n, d)


def mlp_i8_chain(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b,
                 ls=None, *, exact_gelu: bool = True, num_chunks: int = 1,
                 slab_rows: int = MLP_SLAB_ROWS):
    """Kernel #9's launches through the plain versions of their pieces, in
    the wrapper's order, scratch layouts and row slabs."""
    return _mlp_i8_chain(
        x, norm_scale, norm_bias, fc2_wq, fc2_b, ls,
        lambda c, s: gelu_fc1_i8_reference(c, s, fc1_wq, fc1_b, exact_gelu),
        num_chunks, slab_rows)


def swiglu_i8_chain(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b,
                    ls=None, *, num_chunks: int = 1,
                    slab_rows: int = MLP_SLAB_ROWS):
    """Kernel #10's launches through the plain versions of their pieces, in
    the wrapper's order, scratch layouts and row slabs."""
    return _mlp_i8_chain(
        x, norm_scale, norm_bias, fc2_wq, fc2_b, ls,
        lambda c, s: swiglu_fc1_i8_reference(c, s, fc1_wq, fc1_b),
        num_chunks, slab_rows)


def attn_i8_scratch_bytes(b: int, n: int, d: int, dtype) -> int:
    """Device memory kernel #8's wrapper allocates besides its output: codes
    (B N, D) int8 and row scales (B N,) f32 (the LayerNorm's, then the
    context's), qkv (B, N, 3D) in the compute dtype and the context
    (B, N, D) f32."""
    m = b * n
    itemsize = torch.empty((), dtype=dtype).element_size()
    return m * d + 4 * m + 3 * m * d * itemsize + 4 * m * d


def mlp_i8_scratch_bytes(b: int, n: int, d: int, hidden: int,
                         num_chunks: int, slab_rows: int = MLP_SLAB_ROWS) -> int:
    """Device memory the wrapper of kernel #9 or #10 allocates besides its
    output: codes (B N, D) int8 and row scales (B N,) f32 of the LayerNorm,
    the hidden activation of one row slab (slab, H) f32, and the hidden codes
    (B N, H) int8 with their scales (B N, num_chunks) f32. H is the hidden
    width, half the packed fc1's rows for #10."""
    m = b * n
    return m * d + 4 * m + 4 * min(m, slab_rows) * hidden + m * hidden + \
        4 * m * num_chunks


# ------------------------------------------------------------------ binding

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "paths_vit_attn_block_i8": ([_P] * 15 + [_I] * 5 + [_P], ctypes.c_int),
    "paths_vit_mlp_block_i8": ([_P] * 16 + [_I] * 7 + [_P], ctypes.c_int),
    "paths_vit_swiglu_mlp_block_i8": ([_P] * 16 + [_I] * 6 + [_P], ctypes.c_int),
    "paths_cuda_error_string": ([_I], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    return build.load_with_signatures("vit_int8", _SIGNATURES)


def _check_quantized(x, name: str, wq, shape) -> None:
    if not (isinstance(wq, dict) and {"q", "s"} <= set(wq)):
        raise TypeError(f"{name} must be a quantized weight {{'q', 's'}} "
                        "(kernels.vit_int8.quantize_weight makes one)")
    q, s = wq["q"], wq["s"]
    if q.device != x.device or s.device != x.device:
        raise ValueError(f"{name} is on {q.device}, x on {x.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name} is {q.dtype} with {s.dtype} scales: want "
                        "int8 codes and float32 scales")
    if tuple(q.shape) != tuple(shape) or tuple(s.shape) != (shape[0],):
        raise ValueError(f"{name} {tuple(q.shape)} with scales "
                         f"{tuple(s.shape)}, want {tuple(shape)} ((out, in) "
                         f"layout) and ({shape[0]},)")
    for t in (q, s):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a "
                             "16-byte boundary")


# ----------------------------------------------------------------- wrappers

def fused_attn_block_i8(x, norm_scale, norm_bias, qkv_wq, proj_wq, qkv_b,
                        proj_b, ls=None, *, num_heads: int) -> torch.Tensor:
    """Kernel #8; see the module docstring. Each call adds one to
    `fused_attn_block_i8.launches` (one call runs LN-quant, the qkv GEMM, the
    attention, the context's quantisation and the out-projection GEMM on the
    same stream)."""
    if x.device.type == "cpu":
        return fused_attn_block_i8_reference(
            x, norm_scale, norm_bias, qkv_wq, proj_wq, qkv_b, proj_b, ls,
            num_heads=num_heads)
    _check_x(x)
    b, n, d = x.shape
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads {num_heads} must divide D {d}")
    if d // num_heads != HEAD_DIM:
        raise ValueError(f"head_dim {d // num_heads} not supported (the "
                         f"kernel takes {HEAD_DIM})")
    _check_quantized(x, "qkv_wq", qkv_wq, (3 * d, d))
    _check_quantized(x, "proj_wq", proj_wq, (d, d))
    ns, nb, qb, pb, lsv = [_vector(x, name, v, length) for name, v, length in (
        ("norm_scale", norm_scale, d), ("norm_bias", norm_bias, d),
        ("qkv_b", qkv_b, 3 * d), ("proj_b", proj_b, d), ("ls", ls, d))]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # the scratch of `attn_i8_scratch_bytes`
    codes = torch.empty((b * n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty(b * n, dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    build.launch(_library(), "paths_vit_attn_block_i8", x, x.data_ptr(),
                 ns.data_ptr(), nb.data_ptr(), qkv_wq["q"].data_ptr(),
                 qkv_wq["s"].data_ptr(), qb.data_ptr(), proj_wq["q"].data_ptr(),
                 proj_wq["s"].data_ptr(), pb.data_ptr(), lsv.data_ptr(),
                 codes.data_ptr(), scales.data_ptr(), qkv.data_ptr(),
                 ctx.data_ptr(), out.data_ptr(), b, n, d, num_heads,
                 DTYPES[x.dtype])
    fused_attn_block_i8.launches += 1
    return out


def _check_mlp(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls,
               packed: int, num_chunks: int):
    """The MLP wrappers' checks; returns the hidden width and the f32
    vectors (norm scale, norm bias, fc1 bias, fc2 bias, LayerScale)."""
    _check_x(x)
    d = x.shape[2]
    if not (isinstance(fc2_wq, dict) and "q" in fc2_wq
            and fc2_wq["q"].dim() == 2):
        raise TypeError("fc2_wq must be a quantized weight {'q', 's'} "
                        "(kernels.vit_int8.quantize_weight makes one)")
    hidden = fc2_wq["q"].shape[1]
    if num_chunks < 1 or hidden % num_chunks:
        raise ValueError(f"num_chunks={num_chunks} must divide {hidden}")
    if (hidden // num_chunks) % 64:
        raise ValueError(f"hidden width {hidden} over num_chunks "
                         f"{num_chunks} must be a multiple of 64")
    _check_quantized(x, "fc1_wq", fc1_wq, (packed * hidden, d))
    _check_quantized(x, "fc2_wq", fc2_wq, (d, hidden))
    return hidden, [_vector(x, name, v, length) for name, v, length in (
        ("norm_scale", norm_scale, d), ("norm_bias", norm_bias, d),
        ("fc1_b", fc1_b, packed * hidden), ("fc2_b", fc2_b, d), ("ls", ls, d))]


def _mlp_scratch(x, hidden: int, num_chunks: int):
    """The scratch of `mlp_i8_scratch_bytes`: codes, scales, one slab of the
    f32 hidden activation, hidden codes, hidden scales."""
    m = x.shape[0] * x.shape[1]
    return (torch.empty((m, x.shape[2]), dtype=torch.int8, device=x.device),
            torch.empty(m, dtype=torch.float32, device=x.device),
            torch.empty((min(m, MLP_SLAB_ROWS), hidden), dtype=torch.float32,
                        device=x.device),
            torch.empty((m, hidden), dtype=torch.int8, device=x.device),
            torch.empty((m, num_chunks), dtype=torch.float32, device=x.device))


def fused_mlp_block_i8(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b,
                       ls=None, *, exact_gelu: bool = True,
                       num_chunks: int = 1) -> torch.Tensor:
    """Kernel #9; see the module docstring. Each call adds one to
    `fused_mlp_block_i8.launches` (one call runs LN-quant, per row slab the
    fc1 GEMM and the hidden activation's quantisation, and the fc2 GEMM, on
    the same stream)."""
    if x.device.type == "cpu":
        return fused_mlp_block_i8_reference(
            x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls,
            exact_gelu=exact_gelu, num_chunks=num_chunks)
    hidden, (ns, nb, b1, b2, lsv) = _check_mlp(
        x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls, 1,
        num_chunks)
    b, n, d = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scratch = _mlp_scratch(x, hidden, num_chunks)
    build.launch(_library(), "paths_vit_mlp_block_i8", x, x.data_ptr(),
                 ns.data_ptr(), nb.data_ptr(), fc1_wq["q"].data_ptr(),
                 fc1_wq["s"].data_ptr(), b1.data_ptr(), fc2_wq["q"].data_ptr(),
                 fc2_wq["s"].data_ptr(), b2.data_ptr(), lsv.data_ptr(),
                 *(t.data_ptr() for t in scratch), out.data_ptr(), b * n, d,
                 hidden, ACTS["gelu" if exact_gelu else "gelu_tanh"],
                 num_chunks, MLP_SLAB_ROWS, DTYPES[x.dtype])
    fused_mlp_block_i8.launches += 1
    return out


def fused_swiglu_mlp_block_i8(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq,
                              fc2_b, ls=None, *,
                              num_chunks: int = 1) -> torch.Tensor:
    """Kernel #10; see the module docstring. Each call adds one to
    `fused_swiglu_mlp_block_i8.launches` (one call runs LN-quant, per row
    slab the gated fc1 GEMM and the hidden activation's quantisation, and
    the fc2 GEMM, on the same stream)."""
    if x.device.type == "cpu":
        return fused_swiglu_mlp_block_i8_reference(
            x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls,
            num_chunks=num_chunks)
    hidden, (ns, nb, b1, b2, lsv) = _check_mlp(
        x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls, 2,
        num_chunks)
    b, n, d = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scratch = _mlp_scratch(x, hidden, num_chunks)
    build.launch(_library(), "paths_vit_swiglu_mlp_block_i8", x, x.data_ptr(),
                 ns.data_ptr(), nb.data_ptr(), fc1_wq["q"].data_ptr(),
                 fc1_wq["s"].data_ptr(), b1.data_ptr(), fc2_wq["q"].data_ptr(),
                 fc2_wq["s"].data_ptr(), b2.data_ptr(), lsv.data_ptr(),
                 *(t.data_ptr() for t in scratch), out.data_ptr(), b * n, d,
                 hidden, num_chunks, MLP_SLAB_ROWS, DTYPES[x.dtype])
    fused_swiglu_mlp_block_i8.launches += 1
    return out


fused_attn_block_i8.launches = 0
fused_mlp_block_i8.launches = 0
fused_swiglu_mlp_block_i8.launches = 0
