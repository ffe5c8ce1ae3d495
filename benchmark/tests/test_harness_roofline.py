"""The frozen operation and byte counts against hand-counted shapes."""
from __future__ import annotations

import math

import pytest

from benchmark import harness, roofline
from benchmark.reference import paths_model

H100 = "NVIDIA H100 80GB HBM3"


def _uni():
    return harness.read_json(f"{harness.BENCH}/configs/uni-vitl16.json")["model"]


def test_uni_is_about_123_gflop_a_patch():
    # 24 blocks x (8 n d^2 + 4 n^2 d + 4 n d m) + the patch embedding,
    # n = 197, d = 1024, m = 4096, 16 x 16 x 3 inputs per patch token
    n, d, m = 197, 1024, 4096
    hand = 24 * (8 * n * d * d + 4 * n * n * d + 4 * n * d * m) + 2 * 196 * 768 * d
    assert roofline.vit_flops_per_image(_uni()) == hand
    assert 122e9 < hand < 124e9


def test_vit_block_bounds_match_the_kernel_table():
    # PERF.md's bound column for 64 UNI images in bf16: #4 0.1172 ms, #5 0.2139
    pk = roofline.peaks(H100)
    for kind, ms in (("attn", 0.1172), ("mlp", 0.2139)):
        ops, nbytes = roofline.vit_block_counts(kind, 64, 197, 1024, 4096, 2)
        got = roofline.bound_seconds(ops, nbytes, pk["bfloat16"], pk["bytes_per_s"])
        assert got * 1e3 == pytest.approx(ms, abs=1e-4)
    ops, _ = roofline.vit_block_counts("attn", 1, 197, 1024, 4096, 2)
    assert ops == 2 * 197 * 1024 * 3072 + 2 * 197 * 1024 * 1024 + 4 * 197 * 197 * 1024


@pytest.mark.parametrize("n", [257, 81])
def test_flash_forward_counts(n):
    # B 32, H 4, D 32, f32: every query row against the valid keys
    lengths = [n - i for i in range(32)]
    valid = sum(lengths)
    ops, nbytes = roofline.flash_fwd_counts(32, 4, n, 32, lengths, 4)
    assert ops == 4 * 4 * n * 32 * valid
    assert nbytes == 4 * (2 * 32 * 4 * n * 32 + 2 * 4 * valid * 32) + 4 * (32 * 4 * n + 32)
    full = roofline.flash_fwd_counts(32, 4, n, 32, [n] * 32, 4)[0]
    assert ops < full


@pytest.mark.parametrize("n", [257, 81])
def test_flash_backward_counts(n):
    lengths = [n] * 32
    ops, nbytes = roofline.flash_bwd_counts(32, 4, n, n, 32, lengths, 4)
    assert ops == 14 * 4 * n * 32 * (32 * n)
    q = 32 * 4 * n * 32
    kv = 2 * 4 * 32 * n * 32
    vec = 32 * 4 * n
    want = (4 * (4 * q + kv) + 4 * (2 * vec + 32)
            + 4 * (2 * q + kv + 2 * q) + 4 * (2 * vec + 32))
    assert nbytes == want


def test_paths_level_flops_by_hand():
    model = harness.read_json(f"{harness.BENCH}/configs/brca_paths_0.json")["model"]
    dims = paths_model.Dims.of(model)
    n = 100
    lstm = 2 * n * 2048 * (3 * 256 + 1024) + 2 * n * 256 * 1024
    imp = 2 * n * 1024 * 128 + 2 * n * 128
    proj = 2 * n * 1024 * 128
    rows = n + 1
    layer = 8 * rows * 128 ** 2 + 4 * rows ** 2 * 128 + 16 * rows * 128 ** 2
    head = 2 * 128 * 4
    assert roofline.paths_level_flops(n, dims) == lstm + imp + proj + 2 * layer + head


def test_peaks_table():
    pk = roofline.peaks(H100)
    assert pk["bfloat16"] == 989e12 and pk["float32"] == 67e12
    assert pk["bytes_per_s"] == 3.35e12
    assert roofline.peaks("some other card") is None
    assert math.isclose(pk["int8"], 2 * pk["bfloat16"], rel_tol=1e-3)
