"""Kernel #6 (the fused packed-SwiGLU MLP block: LayerNorm, fc1 GEMM with
the SwiGLU epilogue, fc2 GEMM) against its roofline over the traced
segment, its work counted at the published branch width (3416), not the
held 3456."""
from benchmark.glu_vit import roofline_pct


def read(layer):
    return roofline_pct(layer, "mlp")
