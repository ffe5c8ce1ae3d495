"""Kernel #4 (the fused ViT attention block: LayerNorm, qkv GEMM,
attention, proj GEMM) against its roofline, over the traced segment."""
from benchmark.layers import vit_roofline_pct


def read(layer):
    return vit_roofline_pct(layer, "attn")
