"""The port's ResNet encoders (`encoders.resnet`) and torch mirrors
(`encoders.torch_mirror`) against the JAX package's on the same state dicts
and images, made from seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paths_tpu.encoders import resnet as jresnet
from paths_tpu.encoders import torch_mirror as jmirror
from paths_tpu.encoders.vit import ViTSpec as JViTSpec
from paths_tpu_torch.encoders import registry as tregistry
from paths_tpu_torch.encoders import resnet as tresnet
from paths_tpu_torch.encoders import torch_mirror as tmirror
from paths_tpu_torch.encoders.vit import ViTSpec as TViTSpec

ARCHS = {"resnet18": "TorchResNet18", "resnet50": "TorchResNet50"}


def _mirror(mod, arch, seed=0):
    """A random mirror with non-trivial BatchNorm statistics."""
    torch.manual_seed(seed)
    m = getattr(mod, ARCHS[arch])().eval()
    with torch.no_grad():
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                b.running_mean.uniform_(-0.2, 0.2)
                b.running_var.uniform_(0.5, 1.5)
                b.weight.uniform_(0.5, 1.5)
                b.bias.uniform_(-0.1, 0.1)
    return m


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    arch = request.param
    m = _mirror(tmirror, arch)
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    imgs = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return arch, m, sd, imgs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_apply_matches_jax(case, dtype):
    """f32 within JAX's own bar of 2e-4; bf16 within 2e-2 of each row's norm
    (torch's CPU bf16 convolution and XLA's may round a value one ulp apart,
    and the difference propagates)."""
    arch, _, sd, imgs = case
    want = np.asarray(jresnet.resnet_apply(
        jresnet.resnet_from_torchvision(sd, arch), jnp.asarray(imgs),
        compute_dtype=getattr(jnp, dtype)))
    got = tresnet.resnet_apply(tresnet.resnet_from_torchvision(sd, arch),
                               torch.from_numpy(imgs), getattr(torch, dtype))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == (2, 2048 if arch == "resnet50" else 512)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.05
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    else:
        rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert rel.max() < 2e-2, rel


def test_mirror_matches_jax_mirror(case):
    """Same state-dict keys and shapes, and the same forward to 1e-6, as the
    JAX package's resnet mirror; the port's converted f32 forward equals its
    mirror's."""
    arch, m, sd, imgs = case
    j = getattr(jmirror, ARCHS[arch])().eval()
    assert {k: tuple(v.shape) for k, v in j.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in m.state_dict().items()}
    j.load_state_dict(m.state_dict(), strict=True)
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2))
    with torch.no_grad():
        a, b = m(x), j(x)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    got = tresnet.resnet_apply(tresnet.resnet_from_torchvision(sd, arch),
                               torch.from_numpy(imgs), torch.float32)
    torch.testing.assert_close(got, a, atol=2e-4, rtol=0)


@pytest.mark.parametrize("layout", ["cls", "patch", "all"])
def test_vit_mirror_matches_jax_mirror(layout):
    kw = dict(img_size=32, patch_size=8, embed_dim=24, depth=2, num_heads=2,
              mlp_ratio=2.0, num_reg_tokens=2, layer_scale=True)
    torch.manual_seed(1)
    t = tmirror.timm_vit_mirror(TViTSpec(**kw), pos_layout=layout).eval()
    j = jmirror.timm_vit_mirror(JViTSpec(**kw), pos_layout=layout).eval()
    assert {k: tuple(v.shape) for k, v in j.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in t.state_dict().items()}
    j.load_state_dict(t.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(t(x), j(x), atol=1e-6, rtol=0)


def test_from_name_resnet_on_cpu(case, tmp_path):
    arch, m, sd, imgs = case
    path = str(tmp_path / f"{arch}.pt")
    sd_fc = dict(m.state_dict())
    sd_fc["fc.weight"] = torch.zeros(1000, 2048 if arch == "resnet50" else 512)
    sd_fc["fc.bias"] = torch.zeros(1000)
    torch.save(sd_fc, path)
    encode, dim, tspec = tregistry.from_name(arch, weights_path=path,
                                             compute_dtype=torch.float32,
                                             device="cpu")
    assert dim == (2048 if arch == "resnet50" else 512) and tspec.identity
    u8 = (imgs * 255).astype(np.uint8)
    got = encode(torch.from_numpy(u8))
    with torch.no_grad():
        want = m(torch.from_numpy(u8.transpose(0, 3, 1, 2)).float() / 255.0)
    assert got.shape == (2, dim)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
