"""Vision Transformer patch encoders (counterpart of
`paths_tpu.encoders.vit`).

Covers the encoder zoo's architectures: UNI (timm ViT-L/16 with LayerScale),
Virchow2 and the Kaiko DINO ViTs. `VIRCHOW2` is the published model
(paige-ai/Virchow2: timm `vit_huge_patch14_224`, 224 px, width 1280, 32
blocks of 16 heads of 80, LayerScale, 4 register tokens, 261 tokens, timm's
packed SwiGLU `GluMlp`: fc1 1280 -> 6832 = 2 x 3416, gate half first, fc2
3416 -> 1280; cls token joined with the mean of the patch tokens, 2560 out),
whose 3416-wide branches the port holds zero-padded to 3456. All follow
timm's `VisionTransformer` graph: patch embedding, prepended class
(+ register) tokens, learned position embedding, pre-norm
blocks (attention -> LayerScale -> residual; MLP -> LayerScale -> residual),
final LayerNorm. The encoders are frozen: parameters do not require grad and
the forward is inference only.

`vit_apply` runs a block through one of five routes (`block_impl`):
  "xla"    plain `torch` ops, rounding to the compute dtype where the JAX
           package's plain route does;
  "fused"  the hand-written block kernels of `kernels.vit_fused` (attention
           block, then the GELU or packed-SwiGLU MLP block);
  "flash"  the plain block with its attention through the masked
           flash-attention forward kernel of `kernels.flash_attention`;
  "fused1" the whole block in one launch (`kernels.vit_fused.fused_block`); a
           SwiGLU spec takes the "fused" pair instead, as in the JAX package;
  "int8"   the int8 block kernels of `kernels.vit_int8` (int8 projections,
           attention in the compute dtype); the model's block matrices must
           have been quantised (`kernels.vit_int8.quantize_vit_blocks`;
           `encoders.registry.from_name(block_impl="int8")` does it).
On a card, "fused" and "fused1" take head_dim 64 and 80 (Virchow2); "int8"
(#8) and "flash" (#1) take head_dim 64 only and refuse Virchow2's 80.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paths_tpu_torch.kernels import flash_attention, vit_fused, vit_int8

LN_EPS = 1e-6
BLOCK_IMPLS = ("xla", "fused", "fused1", "flash", "int8")


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layer_scale: bool = False          # timm LayerScale (UNI: init 1e-5)
    swiglu: bool = False               # Virchow2: SwiGLUPacked + SiLU
    num_reg_tokens: int = 0            # Virchow2: 4 register tokens
    pool: str = "token"                # token | token+mean (Virchow2 concat)
    gelu: str = "exact"                # "exact" (erf, as timm) or "tanh"
    # timm's packed `GluMlp` (Virchow2): the width of each SwiGLU branch, so
    # fc1 has 2 x glu_width rows and fc2 glu_width columns, with
    # 2 x glu_width = embed_dim x mlp_ratio. 0: the JAX package's SwiGLU,
    # whose branches are each int(embed_dim x mlp_ratio) wide.
    glu_width: int = 0

    def __post_init__(self):
        if self.glu_width and not (
                self.swiglu
                and 2 * self.glu_width == round(self.embed_dim * self.mlp_ratio)):
            raise ValueError(
                f"glu_width {self.glu_width} needs swiglu and 2 x glu_width = "
                f"embed_dim x mlp_ratio ({self.embed_dim * self.mlp_ratio})")

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        """The MLP's hidden width as published: a SwiGLU branch's width
        (fc2's input), GELU's fc1 output."""
        return self.glu_width or int(self.embed_dim * self.mlp_ratio)

    @property
    def mlp_hidden_padded(self) -> int:
        """Hidden width stored in the weights: a SwiGLU branch rounds up to
        a multiple of 128 (Virchow2's 3416 -> 3456; the JAX package's
        6832 -> 6912), so the fused kernel #6 takes it. Zero padding is
        exact: silu(0) * 0 = 0 and zero fc2 columns contribute nothing."""
        if self.swiglu:
            return -(-self.mlp_hidden // 128) * 128
        return self.mlp_hidden

    @property
    def out_dim(self) -> int:
        return self.embed_dim * (2 if self.pool == "token+mean" else 1)


# canonical specs of the zoo
UNI = ViTSpec(embed_dim=1024, depth=24, num_heads=16, layer_scale=True)
VIRCHOW2 = ViTSpec(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                   mlp_ratio=5.3375, layer_scale=True, swiglu=True,
                   glu_width=3416, num_reg_tokens=4, pool="token+mean")
assert (VIRCHOW2.head_dim, VIRCHOW2.mlp_hidden, VIRCHOW2.mlp_hidden_padded,
        VIRCHOW2.num_patches + 1 + VIRCHOW2.num_reg_tokens,
        VIRCHOW2.out_dim) == (80, 3416, 3456, 261, 2560)
KAIKO_VITS16 = ViTSpec(embed_dim=384, depth=12, num_heads=6)
KAIKO_VITS8 = ViTSpec(patch_size=8, embed_dim=384, depth=12, num_heads=6)
KAIKO_VITB16 = ViTSpec(embed_dim=768, depth=12, num_heads=12)
KAIKO_VITB8 = ViTSpec(patch_size=8, embed_dim=768, depth=12, num_heads=12)
KAIKO_VITL14 = ViTSpec(patch_size=14, embed_dim=1024, depth=24, num_heads=16)


class ViTBlock(nn.Module):
    """One pre-norm block's weights. `fc1` is (2H, D) packed, gate rows
    first, when the spec is SwiGLU."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        d, h = spec.embed_dim, spec.mlp_hidden_padded
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, 2 * h if spec.swiglu else h)
        self.fc2 = nn.Linear(h, d)
        if spec.layer_scale:
            self.ls1 = nn.Parameter(torch.ones(d))
            self.ls2 = nn.Parameter(torch.ones(d))
        else:
            self.ls1 = self.ls2 = None


class ViT(nn.Module):
    """The weights of a ViT encoder, frozen. `pos_embed` may have
    num_patches, num_patches + 1 or num_patches + 1 + registers rows (timm's
    three layouts); `vit_apply` infers the layout from the row count."""

    def __init__(self, spec: ViTSpec, pos_embed_rows: int | None = None):
        super().__init__()
        self.spec = spec
        d, p = spec.embed_dim, spec.patch_size
        n_prefix = 1 + spec.num_reg_tokens
        rows = spec.num_patches + n_prefix if pos_embed_rows is None \
            else pos_embed_rows
        # the conv patch embedding as a product over flattened (P, P, 3)
        self.patch_embed = nn.Linear(p * p * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(d))
        self.reg_tokens = (nn.Parameter(torch.zeros(spec.num_reg_tokens, d))
                           if spec.num_reg_tokens else None)
        self.pos_embed = nn.Parameter(torch.zeros(rows, d))
        self.blocks = nn.ModuleList(ViTBlock(spec) for _ in range(spec.depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.requires_grad_(False)
        self._cast: Dict[torch.dtype, List[dict]] = {}

    @property
    def quantized(self) -> bool:
        """Whether the blocks hold int8 matrices (`vit_int8.quantize_vit_blocks`)
        in place of the float ones."""
        return len(self.blocks) > 0 and vit_int8.is_quantized(self.blocks[0])

    def matrices(self, dtype: torch.dtype) -> List[dict]:
        """Per block, the four weight matrices in `dtype` (the compute
        dtype), contiguous: cast once and kept, so a forward does not recast
        the weights (they are frozen). Moving the model drops the copies. A
        quantised model gives its int8 matrices, `{"q", "s"}` each, whatever
        the dtype."""
        if self.quantized:
            return [vit_int8.quantized_weights(b) for b in self.blocks]
        if dtype not in self._cast:
            self._cast = {dtype: [
                {"qkv": b.qkv.weight.to(dtype).contiguous(),
                 "proj": b.proj.weight.to(dtype).contiguous(),
                 "fc1": b.fc1.weight.to(dtype).contiguous(),
                 "fc2": b.fc2.weight.to(dtype).contiguous()}
                for b in self.blocks]}
        return self._cast[dtype]

    def _apply(self, fn, *args, **kwargs):   # .to() / .cuda(): drop the copies
        self._cast = {}
        return super()._apply(fn, *args, **kwargs)


def vit_init(seed: int, spec: ViTSpec) -> ViT:
    """A randomly initialised ViT on the CPU, from host-side numpy: the same
    generator, drawn in the same order and snapped to the bf16 grid as in the
    JAX package's `vit_init`, so one seed gives bit-identical weights in both
    packages. Random encoders serve shape tests and throughput runs; real
    runs load converted timm weights (`encoders.convert_vit`)."""
    rng = np.random.default_rng(int(seed))

    def trunc_normal(shape, std=0.02) -> torch.Tensor:
        vals = np.clip(rng.normal(0.0, std, shape), -2 * std, 2 * std)
        return torch.from_numpy(vals.astype(np.float32)).bfloat16().float()

    d, p = spec.embed_dim, spec.patch_size
    h = spec.mlp_hidden_padded
    model = ViT(spec)
    with torch.no_grad():
        # drawn in the JAX layouts ((in, out), conv kernel (P, P, 3, D)) and
        # transposed into nn.Linear's (out, in)
        model.patch_embed.weight.copy_(
            trunc_normal((p, p, 3, d)).reshape(p * p * 3, d).T)
        model.patch_embed.bias.zero_()
        model.cls_token.copy_(trunc_normal((d,), 1e-6))
        model.pos_embed.copy_(trunc_normal(tuple(model.pos_embed.shape)))
        if spec.num_reg_tokens:
            model.reg_tokens.copy_(trunc_normal((spec.num_reg_tokens, d), 1e-6))
        for blk in model.blocks:
            blk.qkv.weight.copy_(trunc_normal((d, 3 * d)).T)
            blk.proj.weight.copy_(trunc_normal((d, d)).T)
            blk.fc1.weight.copy_(
                trunc_normal((d, 2 * h if spec.swiglu else h)).T)
            blk.fc2.weight.copy_(trunc_normal((h, d)).T)
            for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2):
                lin.bias.zero_()
            if spec.layer_scale:
                blk.ls1.fill_(1e-5)
                blk.ls2.fill_(1e-5)
            if spec.glu_width:
                _zero_glu_padding(blk, spec)
    return model


def _zero_glu_padding(blk: ViTBlock, spec: ViTSpec) -> None:
    """Zero the rows of fc1 and the columns of fc2 past each SwiGLU branch's
    published width (`spec.mlp_hidden`), so the padded block computes the
    published one. The JAX package's `vit_init` draws them, so specs without
    `glu_width` keep them drawn, bit-equal to it."""
    h, hp = spec.mlp_hidden, spec.mlp_hidden_padded
    with torch.no_grad():
        for lo in (h, hp + h):
            blk.fc1.weight[lo: lo + hp - h].zero_()
            blk.fc1.bias[lo: lo + hp - h].zero_()
        blk.fc2.weight[:, h:].zero_()


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32, rounded to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight.float(),
                        norm.bias.float(), LN_EPS).to(x.dtype)


def _linear(x, w, bias):
    """x w^T rounded to the compute dtype, then the bias in that dtype."""
    return F.linear(x, w) + bias.to(x.dtype)


def _attn(blk: ViTBlock, w: dict, x: torch.Tensor, num_heads: int,
          impl: str) -> torch.Tensor:
    b, n, d = x.shape
    cd = x.dtype
    qkv = _linear(x, w["qkv"], blk.qkv.bias).view(b, n, 3, num_heads,
                                                  d // num_heads)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))      # (B, H, N, hd)
    if impl == "flash":
        lengths = torch.full((b,), n, dtype=torch.int32, device=x.device)
        # JAX's key block on this route (`paths_tpu/encoders/vit.py`), which
        # places the rounding of P in bf16
        o, _ = flash_attention.masked_flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), lengths,
            min(256, 128 * -(-n // 128)))
    else:
        scale = 1.0 / math.sqrt(d // num_heads)
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        o = (torch.softmax(logits, dim=-1).to(cd).float() @ v.float()).to(cd)
    o = o.transpose(1, 2).reshape(b, n, d)
    return _linear(o, w["proj"], blk.proj.bias)


def _mlp(blk: ViTBlock, w: dict, x: torch.Tensor, spec: ViTSpec) -> torch.Tensor:
    h = _linear(x, w["fc1"], blk.fc1.bias)
    if spec.swiglu:
        gate, val = h.chunk(2, dim=-1)
        h = F.silu(gate) * val
    else:
        h = F.gelu(h, approximate="tanh" if spec.gelu == "tanh" else "none")
    return _linear(h, w["fc2"], blk.fc2.bias)


def _block(blk: ViTBlock, w: dict, x: torch.Tensor, spec: ViTSpec,
           impl: str) -> torch.Tensor:
    if impl != "int8" and vit_int8.is_quantized(blk):
        raise ValueError(
            f"block_impl={impl!r} got int8-quantized params — use "
            "block_impl='int8', or load unquantized params for this impl")
    if impl == "int8":
        if not vit_int8.is_quantized(blk):
            raise ValueError(
                "block_impl='int8' needs quantized params — run "
                "kernels.vit_int8.quantize_vit_blocks(model) first "
                "(encoders.from_name(block_impl='int8') does)")
        x = vit_int8.fused_attn_block_i8(
            x, blk.norm1.weight, blk.norm1.bias, w["qkv"], w["proj"],
            blk.qkv.bias, blk.proj.bias, blk.ls1, num_heads=spec.num_heads)
        if spec.swiglu:
            return vit_int8.fused_swiglu_mlp_block_i8(
                x, blk.norm2.weight, blk.norm2.bias, w["fc1"], blk.fc1.bias,
                w["fc2"], blk.fc2.bias, blk.ls2)
        return vit_int8.fused_mlp_block_i8(
            x, blk.norm2.weight, blk.norm2.bias, w["fc1"], blk.fc1.bias,
            w["fc2"], blk.fc2.bias, blk.ls2, exact_gelu=(spec.gelu == "exact"))
    if impl == "fused1" and not spec.swiglu:
        tree = {"norm1": {"scale": blk.norm1.weight, "bias": blk.norm1.bias},
                "attn": {"qkv_w": w["qkv"], "qkv_b": blk.qkv.bias,
                         "proj_w": w["proj"], "proj_b": blk.proj.bias},
                "norm2": {"scale": blk.norm2.weight, "bias": blk.norm2.bias},
                "mlp": {"fc1_w": w["fc1"], "fc1_b": blk.fc1.bias,
                        "fc2_w": w["fc2"], "fc2_b": blk.fc2.bias}}
        if spec.layer_scale:
            tree["ls1"], tree["ls2"] = blk.ls1, blk.ls2
        return vit_fused.fused_block(x, tree, num_heads=spec.num_heads,
                                     exact_gelu=(spec.gelu == "exact"))
    if impl == "fused1":
        impl = "fused"       # SwiGLU keeps the two-kernel fused route
    if impl == "fused":
        x = vit_fused.fused_attn_block(
            x, blk.norm1.weight, blk.norm1.bias, w["qkv"], blk.qkv.bias,
            w["proj"], blk.proj.bias, blk.ls1, num_heads=spec.num_heads)
        if spec.swiglu:
            return vit_fused.fused_swiglu_mlp_block(
                x, blk.norm2.weight, blk.norm2.bias, w["fc1"], blk.fc1.bias,
                w["fc2"], blk.fc2.bias, blk.ls2)
        return vit_fused.fused_mlp_block(
            x, blk.norm2.weight, blk.norm2.bias, w["fc1"], blk.fc1.bias,
            w["fc2"], blk.fc2.bias, blk.ls2, exact_gelu=(spec.gelu == "exact"))
    a = _attn(blk, w, _ln(blk.norm1, x), spec.num_heads, impl)
    if spec.layer_scale:
        a = a * blk.ls1.to(x.dtype)
    x = x + a
    m = _mlp(blk, w, _ln(blk.norm2, x), spec)
    if spec.layer_scale:
        m = m * blk.ls2.to(x.dtype)
    return x + m


def check_block_impl(impl: str) -> None:
    if impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl={impl!r}: want one of {BLOCK_IMPLS}")


def vit_apply(model: ViT, images: torch.Tensor,
              compute_dtype: torch.dtype = torch.bfloat16,
              block_impl: str = "xla") -> torch.Tensor:
    """Encode images -> features, without gradients.

    :param images: (B, H, W, 3) float, already resized and normalised
        (`encoders.transforms.apply_transform`), on the model's device
    :return: (B, out_dim) float32: the class token, or for Virchow2 the class
        token joined with the mean of the patch tokens (registers dropped)
    """
    check_block_impl(block_impl)
    spec = model.spec
    cd = compute_dtype
    b, hh, ww, _ = images.shape
    p = spec.patch_size
    if hh % p or ww % p:
        raise ValueError(f"image {hh}x{ww} is not a multiple of patch {p}")
    if (hh // p) * (ww // p) != spec.num_patches:
        raise ValueError(f"got {(hh // p) * (ww // p)} patches, spec expects "
                         f"{spec.num_patches}; resize inputs to the spec's "
                         "img_size")
    with torch.no_grad():
        # patch embedding as reshape + product (equals the conv)
        x = images.reshape(b, hh // p, p, ww // p, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, spec.num_patches, p * p * 3).to(cd)
        x = _linear(x, model.patch_embed.weight.to(cd), model.patch_embed.bias)

        d = spec.embed_dim
        n_prefix = 1 + spec.num_reg_tokens
        cls = model.cls_token.to(cd).expand(b, 1, d)
        reg = (model.reg_tokens.to(cd).expand(b, spec.num_reg_tokens, d)
               if spec.num_reg_tokens else None)
        prefix = [cls, reg] if reg is not None else [cls]
        pe = model.pos_embed.to(cd)[None]
        npatch = spec.num_patches
        if pe.shape[1] == npatch:                      # patches only (DINOv2)
            x = torch.cat(prefix + [x + pe], dim=1)
        elif pe.shape[1] == npatch + 1:                # cls + patches
            x = torch.cat([cls, x], dim=1) + pe
            if reg is not None:
                x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
        elif pe.shape[1] == npatch + n_prefix:         # every token
            x = torch.cat(prefix + [x], dim=1) + pe
        else:
            raise ValueError(f"pos_embed has {pe.shape[1]} rows for "
                             f"{npatch} patches and {n_prefix} prefix tokens")
        x = x.contiguous()

        for blk, w in zip(model.blocks, model.matrices(cd)):
            x = _block(blk, w, x, spec, block_impl)

        x = _ln(model.norm, x)
        cls_out = x[:, 0].float()
        if spec.pool == "token+mean":
            patch_mean = x[:, n_prefix:].float().mean(dim=1)
            # the mean is taken in the compute dtype's values, as in JAX
            patch_mean = patch_mean.to(cd).float()
            return torch.cat([cls_out, patch_mean], dim=-1)
        return cls_out
