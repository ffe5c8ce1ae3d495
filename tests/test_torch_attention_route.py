"""The "auto" attention route of the port's `MultiheadAttention`.

`nn.attention.AUTO_PALLAS_MIN_LEN` is the bag length from which "auto" takes
the flash kernels on a CUDA tensor; a sweep on the card sets it
(`paths_tpu_torch/kernels/bench_vit.py --sweep-auto`). On the CPU "auto" is
the plain route at every length, as the JAX package's "auto" is its XLA route
off the TPU, and the two agree there to 1e-5 (f32, summation order). The
route rule itself is a pure function, held here to its cases for a CUDA
tensor as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paths_tpu.nn import attention as jattn
from paths_tpu.train.state import _flatten

from paths_tpu_torch import convert
from paths_tpu_torch.kernels import bench_vit
from paths_tpu_torch.nn import attention as tattn

MIN = tattn.AUTO_PALLAS_MIN_LEN
KERNEL_ENTRIES = ("masked_flash_attention", "flash_attention_fwd")


def _spy(monkeypatch, names=KERNEL_ENTRIES):
    """Calls of the kernel entries as `nn.attention` sees them."""
    calls = []
    for name in names:
        real = getattr(tattn, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(tattn, name, spy)
    return calls


def test_threshold_is_a_swept_length_and_jax_keeps_its_own():
    """The port's threshold is one of the swept bag lengths; the JAX
    package's stays 4096, a tuning for the TPU."""
    assert MIN in [n for n, _ in bench_vit.SWEEP]
    assert jattn.AUTO_PALLAS_MIN_LEN == 4096


@pytest.mark.parametrize("n", [MIN - 1, MIN, MIN + 40])
def test_auto_takes_no_kernel_on_a_cpu_tensor(monkeypatch, n):
    """Below, at and above the threshold a CPU tensor under "auto" takes
    the plain route and matches JAX's "auto" on the same weights."""
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n, 16)).astype(np.float32)
    valid = np.arange(n)[None] < np.array([n, n // 3])[:, None]
    jp = jattn.mha_init(jax.random.PRNGKey(0), 16, 2)
    mha = convert.load_jax_flat(tattn.MultiheadAttention(16, 2), _flatten(jp))
    xt = torch.from_numpy(x)
    got = mha(xt, xt, xt, key_valid=torch.from_numpy(valid), impl="auto")
    assert calls == []
    want = jattn.mha_apply(jp, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                           key_valid=jnp.asarray(valid), impl="auto")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl,nq,nk,on_cuda,dropout,want", [
    ("auto", MIN, MIN, True, False, True),
    ("auto", MIN + 7, MIN + 7, True, False, True),
    ("auto", MIN - 1, MIN - 1, True, False, False),
    ("auto", MIN, MIN, False, False, False),
    ("auto", MIN, MIN, True, True, False),
    ("auto", MIN, MIN + 1, True, False, False),
    ("pallas", 5, 5, False, False, True),
    ("pallas", 5, 5, True, True, False),
    ("pallas", 5, 6, True, False, False),
    ("xla", MIN, MIN, True, False, False),
])
def test_kernel_route_rule(impl, nq, nk, on_cuda, dropout, want):
    """"auto" takes the kernels on CUDA from the threshold on; "pallas"
    everywhere (on the CPU its wrappers run the plain versions); neither for
    cross-attention or under active attention dropout."""
    assert tattn.kernel_route(impl, nq, nk, on_cuda, dropout) is want


@pytest.mark.parametrize("training,rate,routed", [
    (True, 0.1, False), (True, 0.0, True), (False, 0.1, True)])
def test_auto_route_skipped_under_active_dropout(monkeypatch, training, rate,
                                                 routed):
    """With the device check answered as for a CUDA tensor, "auto" at the
    threshold takes the differentiable kernel route (whose CPU wrappers run
    the plain versions) exactly when attention dropout is not active, as
    "pallas" does."""
    real = tattn.kernel_route
    monkeypatch.setattr(
        tattn, "kernel_route",
        lambda impl, nq, nk, on_cuda, drop: real(impl, nq, nk, True, drop))
    calls = _spy(monkeypatch)
    mha = tattn.MultiheadAttention(16, 2,
                                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, MIN, 16, generator=torch.Generator().manual_seed(1))
    valid = torch.arange(MIN)[None] < torch.tensor([MIN, 5])[:, None]
    mha(x, x, x, key_valid=valid, dropout_rate=rate, training=training,
        generator=torch.Generator().manual_seed(2), impl="auto")
    assert calls == (["masked_flash_attention"] if routed else [])
