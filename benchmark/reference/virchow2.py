"""Plain reference of Virchow2 preprocessing: the published encoder's
forward (paige-ai/Virchow2, Zimmermann et al., arXiv:2408.00738). The
tissue plan, the patches' pixels and the input transform are
`reference.uni`'s: Virchow2's transform is UNI's (bicubic resize to 224,
ImageNet mean and std).

The ViT is timm's `vit_huge_patch14_224` with Virchow2's settings:
`init_values` 1e-5 (LayerScale), `reg_tokens` 4, `mlp_ratio` 5.3375 with
`mlp_layer` `SwiGLUPacked` and `act_layer` SiLU, `global_pool` "". So:
patch embedding (a 14 x 14 convolution, as a product), the class token and
4 register tokens before the 256 patch tokens, a learned position embedding
over all 261, 32 pre-norm blocks of width 1280 (LayerNorm, 16 heads of 80,
LayerScale; LayerNorm, `GluMlp`: fc1 1280 -> 6832, SiLU of its first half
times its second half, fc2 3416 -> 1280, LayerScale), the final LayerNorm,
and the class token joined with the mean of the patch tokens (tokens 5 to
260): 2560 features. It runs in float32 with TF32 off, or in any type it is
given.

It imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.uni import fp8


def num_tokens(dims: dict) -> int:
    """Class token, registers and patches."""
    return (dims["img_size"] // dims["patch_size"]) ** 2 + 1 + dims["reg_tokens"]


def vit_specs(dims: dict) -> Dict[str, tuple]:
    """name -> (shape, init): every tensor of the published state dict,
    named and shaped as timm saves it (Linear weights (out, in), the patch
    embedding (D, 3, P, P)); inits as `reference.uni.vit_specs`."""
    d, p, depth = dims["embed_dim"], dims["patch_size"], dims["depth"]
    h, r = dims["glu_width"], dims["reg_tokens"]
    specs = {"patch_embed.proj.weight": ((d, 3, p, p), "trunc"),
             "patch_embed.proj.bias": ((d,), "bias"),
             "cls_token": ((1, 1, d), "trunc"),
             "reg_token": ((1, r, d), "trunc"),
             "pos_embed": ((1, num_tokens(dims), d), "trunc"),
             "norm.weight": ((d,), "scale"), "norm.bias": ((d,), "bias")}
    for i in range(depth):
        b = f"blocks.{i}"
        specs.update({
            f"{b}.norm1.weight": ((d,), "scale"), f"{b}.norm1.bias": ((d,), "bias"),
            f"{b}.attn.qkv.weight": ((3 * d, d), "trunc"),
            f"{b}.attn.qkv.bias": ((3 * d,), "bias"),
            f"{b}.attn.proj.weight": ((d, d), "trunc"),
            f"{b}.attn.proj.bias": ((d,), "bias"),
            f"{b}.ls1.gamma": ((d,), "layerscale"),
            f"{b}.norm2.weight": ((d,), "scale"), f"{b}.norm2.bias": ((d,), "bias"),
            f"{b}.mlp.fc1.weight": ((2 * h, d), "trunc"),
            f"{b}.mlp.fc1.bias": ((2 * h,), "bias"),
            f"{b}.mlp.fc2.weight": ((d, h), "trunc"),
            f"{b}.mlp.fc2.bias": ((d,), "bias"),
            f"{b}.ls2.gamma": ((d,), "layerscale")})
    return specs


def vit_forward(w: Dict[str, torch.Tensor], dims: dict, x: torch.Tensor,
                products: str = "exact") -> torch.Tensor:
    """(B, S, S, 3) transformed images -> (B, 2 d) features in x's type
    (weights cast to it). `products` "fp8" rounds both operands of every
    projection (patch embedding, qkv, proj, fc1, fc2) to float8 e4m3 first:
    the reference one precision below bf16."""
    dt = x.dtype
    rnd = fp8 if products == "fp8" else (lambda t: t)
    d, p, heads = dims["embed_dim"], dims["patch_size"], dims["num_heads"]
    hd = d // heads
    prefix = 1 + dims["reg_tokens"]
    b, s = x.shape[0], x.shape[1]
    g = s // p

    def W(name):
        return w[name].to(dt)

    def proj(y, name):
        return rnd(y) @ rnd(W(f"{name}.weight").reshape(
            w[f"{name}.weight"].shape[0], -1)).T + W(f"{name}.bias")

    # patches flattened (channel, row, col), the convolution weight's order
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, -1)
    x = proj(x, "patch_embed.proj")
    x = torch.cat([W("cls_token").expand(b, 1, d),
                   W("reg_token").expand(b, prefix - 1, d), x], dim=1)
    x = x + W("pos_embed")
    n = x.shape[1]

    def ln(name, y):
        return F.layer_norm(y, (d,), W(f"{name}.weight"), W(f"{name}.bias"), 1e-6)

    for i in range(dims["depth"]):
        pre = f"blocks.{i}"
        y = ln(f"{pre}.norm1", x)
        qkv = proj(y, f"{pre}.attn.qkv").reshape(b, n, 3, heads, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, n, d)
        x = x + proj(o, f"{pre}.attn.proj") * W(f"{pre}.ls1.gamma")
        gate, value = proj(ln(f"{pre}.norm2", x), f"{pre}.mlp.fc1").chunk(2, dim=-1)
        x = x + proj(F.silu(gate) * value, f"{pre}.mlp.fc2") * W(f"{pre}.ls2.gamma")
    x = ln("norm", x)
    return torch.cat([x[:, 0], x[:, prefix:].mean(dim=1)], dim=-1)
