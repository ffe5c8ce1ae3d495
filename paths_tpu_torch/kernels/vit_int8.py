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
num_chunks a multiple of 64, and as many tokens as let the scores of 16 query
rows against all keys fit a block's shared memory (over 2000): one head's K
and V stay in shared memory where they fit (about 300 tokens in f32, 510 in bf16
at the encoders' widths) and otherwise go to a device-memory scratch that the
attention wrapper allocates, so the patch-8 Kaiko models (785 tokens) run.
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


# ------------------------------------------------------------------ binding

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "paths_vit_attn_block_i8": ([_P] * 13 + [_I] * 5 + [_P], ctypes.c_int),
    "paths_vit_mlp_block_i8": ([_P] * 11 + [_I] * 6 + [_P], ctypes.c_int),
    "paths_vit_attn_i8_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "paths_vit_attn_i8_kv_bytes": ([_I] * 5, ctypes.c_longlong),
    "paths_vit_mlp_i8_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "paths_vit_max_smem_bytes": ([], ctypes.c_longlong),
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


def _check_smem(need: int, what: str) -> None:
    limit = _library().paths_vit_max_smem_bytes()
    if need > limit:
        raise ValueError(f"{what} needs {need} bytes of shared memory, a "
                         f"block has {limit}")


# ----------------------------------------------------------------- wrappers

def fused_attn_block_i8(x, norm_scale, norm_bias, qkv_wq, proj_wq, qkv_b,
                        proj_b, ls=None, *, num_heads: int) -> torch.Tensor:
    """Kernel #8; see the module docstring. Each launch adds one to
    `fused_attn_block_i8.launches` (one launch runs the per-head attention
    kernel and the out-projection kernel on the same stream)."""
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
    lib = _library()
    dt = DTYPES[x.dtype]
    _check_smem(lib.paths_vit_attn_i8_smem_bytes(n, d, dt),
                f"the scores of 16 rows against {n} keys in {x.dtype}")
    # per-head contexts in f32, read by the projection; K and V of every
    # (image, head) where they do not fit shared memory
    ctx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    kv_bytes = lib.paths_vit_attn_i8_kv_bytes(b, n, d, num_heads, dt)
    kv = torch.empty(kv_bytes, dtype=torch.uint8, device=x.device) \
        if kv_bytes else None
    build.launch(lib, "paths_vit_attn_block_i8", x, x.data_ptr(), ns.data_ptr(),
                 nb.data_ptr(), qkv_wq["q"].data_ptr(), qkv_wq["s"].data_ptr(),
                 qb.data_ptr(), proj_wq["q"].data_ptr(),
                 proj_wq["s"].data_ptr(), pb.data_ptr(), lsv.data_ptr(),
                 ctx.data_ptr(), None if kv is None else kv.data_ptr(),
                 out.data_ptr(), b, n, d, num_heads, dt)
    fused_attn_block_i8.launches += 1
    return out


def _mlp_i8(counter, x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b,
            ls, act: str, num_chunks: int) -> torch.Tensor:
    _check_x(x)
    b, n, d = x.shape
    packed = 2 if act == "swiglu" else 1
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
    ns, nb, b1, b2, lsv = [_vector(x, name, v, length) for name, v, length in (
        ("norm_scale", norm_scale, d), ("norm_bias", norm_bias, d),
        ("fc1_b", fc1_b, packed * hidden), ("fc2_b", fc2_b, d), ("ls", ls, d))]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    _check_smem(lib.paths_vit_mlp_i8_smem_bytes(d, num_chunks),
                f"the accumulators for D {d} with num_chunks {num_chunks}")
    build.launch(lib, "paths_vit_mlp_block_i8", x, x.data_ptr(), ns.data_ptr(),
                 nb.data_ptr(), fc1_wq["q"].data_ptr(), fc1_wq["s"].data_ptr(),
                 b1.data_ptr(), fc2_wq["q"].data_ptr(), fc2_wq["s"].data_ptr(),
                 b2.data_ptr(), lsv.data_ptr(), out.data_ptr(), b * n, d,
                 hidden, ACTS[act], num_chunks, DTYPES[x.dtype])
    counter.launches += 1
    return out


def fused_mlp_block_i8(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b,
                       ls=None, *, exact_gelu: bool = True,
                       num_chunks: int = 1) -> torch.Tensor:
    """Kernel #9; see the module docstring. Each launch adds one to
    `fused_mlp_block_i8.launches`."""
    if x.device.type == "cpu":
        return fused_mlp_block_i8_reference(
            x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls,
            exact_gelu=exact_gelu, num_chunks=num_chunks)
    return _mlp_i8(fused_mlp_block_i8, x, norm_scale, norm_bias, fc1_wq,
                   fc1_b, fc2_wq, fc2_b, ls,
                   "gelu" if exact_gelu else "gelu_tanh", num_chunks)


def fused_swiglu_mlp_block_i8(x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq,
                              fc2_b, ls=None, *,
                              num_chunks: int = 1) -> torch.Tensor:
    """Kernel #10; see the module docstring. Each launch adds one to
    `fused_swiglu_mlp_block_i8.launches`."""
    if x.device.type == "cpu":
        return fused_swiglu_mlp_block_i8_reference(
            x, norm_scale, norm_bias, fc1_wq, fc1_b, fc2_wq, fc2_b, ls,
            num_chunks=num_chunks)
    return _mlp_i8(fused_swiglu_mlp_block_i8, x, norm_scale, norm_bias,
                   fc1_wq, fc1_b, fc2_wq, fc2_b, ls, "swiglu", num_chunks)


fused_attn_block_i8.launches = 0
fused_mlp_block_i8.launches = 0
fused_swiglu_mlp_block_i8.launches = 0
