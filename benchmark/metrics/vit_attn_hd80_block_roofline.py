"""Kernel #4 at head dim 80 (Virchow2's fused attention block: LayerNorm,
qkv GEMM, attention over 16 heads of 80, proj GEMM) against its roofline,
over the traced segment; nothing where the trace holds no head-dim-80
attention kernel."""
from benchmark.glu_vit import roofline_pct


def read(layer):
    return roofline_pct(layer, "attn")
