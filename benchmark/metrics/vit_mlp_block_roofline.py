"""Kernel #5 (the fused ViT GELU MLP block: LayerNorm, fc1 GEMM with
GELU, fc2 GEMM) against its roofline, over the traced segment."""
from benchmark.layers import vit_roofline_pct


def read(layer):
    return vit_roofline_pct(layer, "mlp")
