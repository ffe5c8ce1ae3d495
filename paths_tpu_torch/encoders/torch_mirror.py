"""Torch mirrors of timm ViT / torchvision resnet architectures (the port's
own copy of `paths_tpu.encoders.torch_mirror`).

State-dict key names and shapes follow timm / torchvision conventions (the
checkpoint layouts of UNI, Virchow2, the Kaiko ViTs and the resnet encoders),
so:

  * a real downloaded checkpoint loads into a mirror with `strict=True`
    (certifying the key/shape contract), and
  * the mirror's forward is the plain torch oracle the port's converted
    encoders are verified against (`paths_tpu_torch.cli.verify_conversion`).

These are written from the architectures' definitions, independent of the
port's converters (`encoders.convert_vit`, `encoders.resnet`) and of its
kernels. timm stores the position-embedding table in one of three layouts;
the mirror takes it explicitly (`pos_layout`), while the converted encoder
infers it from the table's row count (`encoders/vit.py::vit_apply`):

  * "cls"   — rows = patches + 1: cls prepended, then pos added, then
    register tokens inserted (timm default with reg_token)
  * "patch" — rows = patches: pos added to patch tokens only, cls/reg
    prepended WITHOUT pos (timm `no_embed_class`, DINOv2 style)
  * "all"   — rows = patches + 1 + reg: every token gets pos
"""
from __future__ import annotations

import math

import torch
from torch import nn


class TimmAttention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = (q @ k.transpose(-2, -1)) / math.sqrt(d // h)
        att = att.softmax(dim=-1)
        out = (att @ v).transpose(1, 2).reshape(b, n, d)
        return self.proj(out)


class TimmMlp(nn.Module):
    def __init__(self, dim, hidden, swiglu=False):
        super().__init__()
        self.swiglu = swiglu
        self.fc1 = nn.Linear(dim, 2 * hidden if swiglu else hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        x = self.fc1(x)
        if self.swiglu:
            x1, x2 = x.chunk(2, dim=-1)
            x = torch.nn.functional.silu(x1) * x2
        else:
            x = torch.nn.functional.gelu(x)
        return self.fc2(x)


class LayerScale(nn.Module):
    def __init__(self, dim, init=1e-5):
        super().__init__()
        self.gamma = nn.Parameter(init * torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class TimmBlock(nn.Module):
    def __init__(self, dim, heads, hidden, layer_scale=False, swiglu=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = TimmMlp(dim, hidden, swiglu)
        if layer_scale:
            self.ls1 = LayerScale(dim)
            self.ls2 = LayerScale(dim)
        self.layer_scale = layer_scale

    def forward(self, x):
        a = self.attn(self.norm1(x))
        x = x + (self.ls1(a) if self.layer_scale else a)
        m = self.mlp(self.norm2(x))
        x = x + (self.ls2(m) if self.layer_scale else m)
        return x


class TimmViT(nn.Module):
    """timm VisionTransformer mirror; see module docstring for
    `pos_layout` semantics."""

    def __init__(self, img_size, patch_size, dim, depth, heads, hidden,
                 layer_scale=False, swiglu=False, reg_tokens=0,
                 pool="token", pos_layout="cls"):
        super().__init__()
        assert pos_layout in ("cls", "patch", "all"), pos_layout
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch_size, patch_size)
        n = (img_size // patch_size) ** 2
        pos_rows = {"cls": n + 1, "patch": n, "all": n + 1 + reg_tokens}
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
        self.pos_embed = nn.Parameter(
            torch.randn(1, pos_rows[pos_layout], dim) * 0.02)
        if reg_tokens:
            self.reg_token = nn.Parameter(
                torch.randn(1, reg_tokens, dim) * 0.02)
        self.reg_tokens = reg_tokens
        self.pos_layout = pos_layout
        self.blocks = nn.ModuleList(
            [TimmBlock(dim, heads, hidden, layer_scale, swiglu)
             for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pool = pool

    def _prefix(self, b):
        toks = [self.cls_token.expand(b, -1, -1)]
        if self.reg_tokens:
            toks.append(self.reg_token.expand(b, -1, -1))
        return toks

    def forward(self, x):  # x: B,3,H,W
        b = x.shape[0]
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # B,N,D
        if self.pos_layout == "patch":
            x = torch.cat(self._prefix(b) + [x + self.pos_embed], dim=1)
        elif self.pos_layout == "all":
            x = torch.cat(self._prefix(b) + [x], dim=1) + self.pos_embed
        else:  # "cls": pos over [cls]+patches, registers inserted after
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
            x = x + self.pos_embed
            if self.reg_tokens:
                r = self.reg_token.expand(b, -1, -1)
                x = torch.cat([x[:, :1], r, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        cls = x[:, 0]
        if self.pool == "token+mean":
            return torch.cat([cls, x[:, 1 + self.reg_tokens:].mean(1)],
                             dim=-1)
        return cls


def timm_vit_mirror(spec, pos_layout="cls") -> "TimmViT":
    """Mirror sized from a `paths_tpu_torch.encoders.vit.ViTSpec`."""
    return TimmViT(spec.img_size, spec.patch_size, spec.embed_dim,
                   spec.depth, spec.num_heads, spec.mlp_hidden,
                   layer_scale=spec.layer_scale, swiglu=spec.swiglu,
                   reg_tokens=spec.num_reg_tokens, pool=spec.pool,
                   pos_layout=pos_layout)


# ------------------------------------------------------------------ resnet

class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))
        else:
            self.downsample = None

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + idn)


class Bottleneck(nn.Module):
    def __init__(self, cin, cmid, stride=1):
        super().__init__()
        cout = cmid * 4
        self.conv1 = nn.Conv2d(cin, cmid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cmid)
        self.conv2 = nn.Conv2d(cmid, cmid, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cmid)
        self.conv3 = nn.Conv2d(cmid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))
        else:
            self.downsample = None

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + idn)


class TorchResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cins = [64, 64, 128, 256]
        couts = [64, 128, 256, 512]
        for s in range(4):
            stride = 1 if s == 0 else 2
            blocks = [BasicBlock(cins[s], couts[s], stride),
                      BasicBlock(couts[s], couts[s], 1)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
        return x.mean(dim=(2, 3))


class TorchResNet50(nn.Module):
    """torchvision resnet50 layout (fc replaced by the global pool, as the
    reference's encoder zoo replaces fc with Identity)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        counts = [3, 4, 6, 3]
        cmids = [64, 128, 256, 512]
        cin = 64
        for s in range(4):
            stride = 1 if s == 0 else 2
            blocks = [Bottleneck(cin, cmids[s], stride)]
            cin = cmids[s] * 4
            blocks += [Bottleneck(cin, cmids[s], 1)
                       for _ in range(counts[s] - 1)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
        return x.mean(dim=(2, 3))
