"""The port's weights-drop-in harness (`paths_tpu_torch.cli.verify_conversion`)
against the JAX package's on small specs: every timm pos-embed layout, a
torchvision resnet50 with its classifier keys, a wrong architecture failing
loudly, and the CLI entry. On the same state dict the port's converted
forward equals the JAX package's converted forward."""
import os

import numpy as np
import pytest
import torch

from paths_tpu.cli import verify_conversion as jvc
from paths_tpu.encoders.vit import ViTSpec as JViTSpec
from paths_tpu_torch.cli import verify_conversion as tvc
from paths_tpu_torch.encoders.torch_mirror import TorchResNet50, timm_vit_mirror
from paths_tpu_torch.encoders.vit import KAIKO_VITS16, ViTSpec

SMALL = dict(img_size=32, patch_size=8, embed_dim=24, depth=3, num_heads=2,
             mlp_ratio=2.0, num_reg_tokens=2)


def _save(tmp_path, sd, name="w.pt"):
    p = os.path.join(str(tmp_path), name)
    torch.save(sd, p)
    return p


@pytest.mark.parametrize("layout,impl", [("cls", "xla"), ("patch", "xla"),
                                         ("all", "xla"), ("cls", "fused"),
                                         ("all", "fused1")])
def test_pos_embed_layouts_match_jax(layout, impl):
    """All three timm pos-embed layouts round-trip (the converted encoder
    infers the layout from the table's row count), through the plain route
    and the kernel routes' plain versions on the CPU; the port's converted
    forward equals the JAX package's within 1e-5."""
    torch.manual_seed(2)
    spec = ViTSpec(**SMALL, layer_scale=True)
    mirror = timm_vit_mirror(spec, pos_layout=layout).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    assert tvc._vit_pos_layout(sd, spec) == layout
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    res = tvc.verify_vit("small", sd, imgs, spec=spec, block_impl=impl,
                         device="cpu")
    assert res["max_abs"] < 1e-4, res["max_abs"]
    assert res["pos_layout"] == layout and res["out_port"].shape == (2, 24)
    want = jvc.verify_vit("small", sd, imgs,
                          spec=JViTSpec(**SMALL, layer_scale=True))
    np.testing.assert_allclose(res["out_port"], want["out_jax"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["out_torch"], want["out_torch"], rtol=0,
                               atol=1e-6)


def test_resnet50_with_fc_keys(tmp_path):
    """torchvision resnet50 checkpoints include fc.* keys (the encoder zoo
    strips them) and num_batches_tracked: the harness accepts both."""
    torch.manual_seed(3)
    mirror = TorchResNet50()
    with torch.no_grad():
        for m in mirror.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    sd = mirror.state_dict()
    assert any("num_batches_tracked" in k for k in sd)
    sd["fc.weight"] = torch.randn(1000, 2048)
    sd["fc.bias"] = torch.randn(1000)
    p = _save(tmp_path, sd, "r50.pt")
    res = tvc.run("resnet50", p, n_images=1, tol=1e-3, device="cpu")
    assert res["ok"], (res["max_abs"], res["max_rel"])
    assert res["out_port"].shape == (1, 2048)
    want = jvc.run("resnet50", p, n_images=1, tol=1e-3)
    np.testing.assert_allclose(res["out_port"], want["out_jax"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["UNI", "resnet18"])
def test_wrong_architecture_fails_loudly(tmp_path, model):
    """A checkpoint for the wrong architecture raises and names the missing
    and unexpected keys, not silently produce garbage features."""
    torch.manual_seed(4)
    small = timm_vit_mirror(ViTSpec(img_size=32, patch_size=8, embed_dim=24,
                                    depth=2, num_heads=2))
    path = _save(tmp_path, small.state_dict())
    with pytest.raises((ValueError, KeyError)) as info:
        tvc.run(model, path, n_images=1, device="cpu")
    if model == "resnet18":
        assert "missing=" in str(info.value) and "unexpected=" in str(info.value)


def test_planted_fault_is_caught(tmp_path, monkeypatch):
    """A converted model that differs from the file (one block's fc1 weight
    scaled by 1.05 after conversion; the mirror keeps the file's weights)
    must fail the check."""
    torch.manual_seed(6)
    spec = ViTSpec(**SMALL, layer_scale=False)
    sd = {k: v.detach().numpy()
          for k, v in timm_vit_mirror(spec).eval().state_dict().items()}
    imgs = np.random.default_rng(1).uniform(-1.5, 1.5, (2, 32, 32, 3)).astype(np.float32)
    convert = tvc.vit_from_timm

    def faulty(sd_, spec_):
        model = convert(sd_, spec_)
        with torch.no_grad():
            model.blocks[1].fc1.weight.mul_(1.05)
        return model

    monkeypatch.setattr(tvc, "vit_from_timm", faulty)
    res = tvc.verify_vit("small", sd, imgs, spec=spec, device="cpu")
    assert res["max_abs"] > 1e-3, res["max_abs"]


def test_cli_entry(tmp_path, capsys):
    torch.manual_seed(5)
    path = _save(tmp_path, timm_vit_mirror(KAIKO_VITS16).state_dict())
    res = tvc.main(["--model", "kaiko-vits16", "--weights", path, "--images",
                    "1", "--device", "cpu", "--block-impl", "fused"])
    out = capsys.readouterr().out
    assert "OK" in out and "max_abs_err" in out and res["ok"]
    assert res["pos_layout"] == "cls" and res["out_port"].shape == (1, 384)
