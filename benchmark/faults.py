"""Faults planted underneath a cell's timed path, for the tests that
must see `correct` come out false and for the readings a training cell's
limits are held against (`benchmark.control --fault`): a step that returns
its state unchanged, half of the batch left out (the mean over the rest),
an answer altered where it is produced. One chip: no exchange between
chips to leave out."""
from __future__ import annotations

import contextlib

import torch


def _scaled_vit(factor):
    from paths_tpu_torch.encoders import vit
    real = vit.vit_apply

    def broken(*a, **kw):
        return real(*a, **kw) * factor
    return "paths_tpu_torch.encoders.vit.vit_apply", broken


def _half_vit():
    from paths_tpu_torch.encoders import vit
    real = vit.vit_apply

    def broken(model, images, **kw):
        half = images.shape[0] // 2
        out = real(model, images[:half], **kw)
        return torch.cat([out, torch.zeros_like(out)])[: images.shape[0]]
    return "paths_tpu_torch.encoders.vit.vit_apply", broken


def _no_step():
    return "paths_tpu_torch.train.loop.optimizer_step", lambda *a, **kw: None


def _half_loss():
    from paths_tpu_torch.engine import hierarchy
    real = hierarchy.task_loss

    def broken(config, logits, labels, denom=None):
        w = labels["weight"].clone()
        w[w.shape[0] // 2:] = 0
        return real(config, logits, dict(labels, weight=w), None)
    return "paths_tpu_torch.engine.hierarchy.task_loss", broken


def _scaled_loss():
    from paths_tpu_torch.engine import hierarchy
    real = hierarchy.task_loss

    def broken(*a, **kw):
        loss, pred = real(*a, **kw)
        return loss * 1.001, pred
    return "paths_tpu_torch.engine.hierarchy.task_loss", broken


def _half_forward():
    from paths_tpu_torch import serve
    real = serve.serving_forward

    def broken(model, config, bag, tables):
        out = real(model, config, bag, tables)
        pred = out["pred"]
        half = pred.shape[0] // 2
        return dict(out, pred=torch.cat([pred[:half], pred[:pred.shape[0] - half]]))
    return "paths_tpu_torch.serve.serving_forward", broken


def _scaled_forward():
    from paths_tpu_torch import serve
    real = serve.serving_forward

    def broken(*a):
        out = real(*a)
        return dict(out, pred=out["pred"] * 1.001)
    return "paths_tpu_torch.serve.serving_forward", broken


FAULTS = {
    ("preprocess", "half_batch"): _half_vit,
    ("preprocess", "answer_altered"): lambda: _scaled_vit(1.01),
    ("train", "state_unchanged"): _no_step,
    ("train", "half_batch"): _half_loss,
    ("train", "answer_altered"): _scaled_loss,
    ("predict", "half_batch"): _half_forward,
    ("predict", "answer_altered"): _scaled_forward,
}


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """The fault planted underneath the timed path while active."""
    import importlib

    target, broken = FAULTS[(driver, fault)]()
    module, name = target.rsplit(".", 1)
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, real)
