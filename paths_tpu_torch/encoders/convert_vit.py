"""timm VisionTransformer state_dict -> the port's `ViT` (counterpart of
`paths_tpu.encoders.convert_vit`).

Key map (timm `vision_transformer.py` naming, used by UNI, Virchow2 and the
Kaiko ViTs); Linear weights keep timm's (out, in) layout:

    patch_embed.proj.weight (D,3,P,P) -> patch_embed.weight (D, P*P*3), the
                                         columns ordered (row, col, channel)
    cls_token (1,1,D)                 -> cls_token (D,)
    reg_token (1,R,D)                 -> reg_tokens (R,D)
    pos_embed (1,N,D)                 -> pos_embed (N,D)  [layout inferred]
    blocks.i.attn.qkv.*               -> blocks[i].qkv.*
    blocks.i.attn.proj.*              -> blocks[i].proj.*
    blocks.i.ls{1,2}.gamma            -> blocks[i].ls{1,2}
    blocks.i.mlp.fc{1,2}.*            -> blocks[i].fc{1,2}.*
    norm.{weight,bias}                -> norm.{weight,bias}

Virchow2's packed SwiGLU (`GluMlp`): fc1 (6832, 1280), gate rows first, and
fc2 (1280, 3416), each branch zero-padded to the spec's 3456.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from paths_tpu_torch.encoders.vit import ViT, ViTSpec


def _convert_mlp(g, p: str, spec: ViTSpec):
    """(fc1_w, fc1_b, fc2_w, fc2_b) in (out, in) layout. A SwiGLU hidden pads
    with zeros to `spec.mlp_hidden_padded`; the packed fc1's gate and value
    halves pad independently. The padding is exact (see
    `ViTSpec.mlp_hidden_padded`)."""
    fc1_w, fc1_b = g(f"{p}.mlp.fc1.weight"), g(f"{p}.mlp.fc1.bias")
    fc2_w, fc2_b = g(f"{p}.mlp.fc2.weight"), g(f"{p}.mlp.fc2.bias")
    h, hp = spec.mlp_hidden, spec.mlp_hidden_padded
    want = ((2 * h if spec.swiglu else h, spec.embed_dim), (spec.embed_dim, h))
    if (fc1_w.shape, fc2_w.shape) != want:
        raise ValueError(f"{p}.mlp: fc1 {fc1_w.shape}, fc2 {fc2_w.shape}; the "
                         f"spec wants {want[0]} and {want[1]}")
    if spec.swiglu and hp != h:
        w1 = np.zeros((2 * hp, fc1_w.shape[1]), fc1_w.dtype)
        w1[:h], w1[hp:hp + h] = fc1_w[:h], fc1_w[h:]
        b1 = np.zeros((2 * hp,), fc1_b.dtype)
        b1[:h], b1[hp:hp + h] = fc1_b[:h], fc1_b[h:]
        w2 = np.zeros((fc2_w.shape[0], hp), fc2_w.dtype)
        w2[:, :h] = fc2_w
        fc1_w, fc1_b, fc2_w = w1, b1, w2
    return fc1_w, fc1_b, fc2_w, fc2_b


def vit_from_timm(sd: Mapping[str, np.ndarray], spec: ViTSpec) -> ViT:
    """A new CPU `ViT` from a timm state dict of numpy arrays."""
    g = lambda k: np.asarray(sd[k], dtype=np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if not spec.layer_scale and "blocks.0.ls1.gamma" in sd:
        raise ValueError("the state dict has LayerScale (ls1.gamma) and the "
                         "spec has none")
    model = ViT(spec, pos_embed_rows=g("pos_embed").shape[1])
    d = spec.embed_dim
    with torch.no_grad():
        # (D, 3, P, P) -> (D, P, P, 3) -> (D, P*P*3)
        model.patch_embed.weight.copy_(
            t(g("patch_embed.proj.weight").transpose(0, 2, 3, 1)).reshape(d, -1))
        model.patch_embed.bias.copy_(t(g("patch_embed.proj.bias")))
        model.cls_token.copy_(t(g("cls_token").reshape(-1)))
        model.pos_embed.copy_(t(g("pos_embed")[0]))
        if spec.num_reg_tokens:
            model.reg_tokens.copy_(t(g("reg_token")[0]))
        model.norm.weight.copy_(t(g("norm.weight")))
        model.norm.bias.copy_(t(g("norm.bias")))
        for i, blk in enumerate(model.blocks):
            p = f"blocks.{i}"
            for mod, key in ((blk.norm1, "norm1"), (blk.qkv, "attn.qkv"),
                             (blk.proj, "attn.proj"), (blk.norm2, "norm2")):
                mod.weight.copy_(t(g(f"{p}.{key}.weight")))
                mod.bias.copy_(t(g(f"{p}.{key}.bias")))
            fc1_w, fc1_b, fc2_w, fc2_b = _convert_mlp(g, p, spec)
            blk.fc1.weight.copy_(t(fc1_w))
            blk.fc1.bias.copy_(t(fc1_b))
            blk.fc2.weight.copy_(t(fc2_w))
            blk.fc2.bias.copy_(t(fc2_b))
            if spec.layer_scale:
                blk.ls1.copy_(t(g(f"{p}.ls1.gamma")))
                blk.ls2.copy_(t(g(f"{p}.ls2.gamma")))
    return model


def vit_from_torch_file(path: str, spec: ViTSpec) -> ViT:
    """Load a timm checkpoint (`model.state_dict()` saved with torch)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return vit_from_timm({k: v.float().numpy() for k, v in sd.items()}, spec)
