"""What the drivers share: the sample of a run's outputs drawn from its
seed, the lower-precision switch of the reference, and the benchmark's own
count of the flash kernels' launches (shapes and valid lengths), taken
around the kernels' entries while the traced segment runs."""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch


def sample_rng(seed: int) -> np.random.Generator:
    """The generator of the check's sample (apart from the traffic's)."""
    return np.random.default_rng([int(seed), 0xC0FFEE])


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 (the control) or exact (the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class FlashLaunches:
    """Every launch of the three flash kernels while active: (kernel, q's
    shape, key count, item size, valid lengths on the device)."""

    NAMES = {"masked_flash_attention_fwd": "fwd",
             "masked_flash_attention_bwd_dq": "bwd",
             "masked_flash_attention_bwd_dkv": None}

    def __init__(self):
        self.launches: List[tuple] = []

    @contextlib.contextmanager
    def active(self):
        from paths_tpu_torch.kernels import flash_attention as fa

        saved = {n: getattr(fa, n) for n in self.NAMES}

        def wrap(name, fn):
            kind = self.NAMES[name]

            def counted(q, k, v, lengths, *args, **kw):
                if kind is not None:
                    self.launches.append((kind, tuple(q.shape), k.shape[2],
                                          q.element_size(), lengths.clone()))
                return fn(q, k, v, lengths, *args, **kw)
            # the kernel entry counts its launches on the module's name
            counted.launches = getattr(fn, "launches", 0)
            return counted

        for n, fn in saved.items():
            setattr(fa, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                fn.launches = getattr(getattr(fa, n), "launches", 0)
                setattr(fa, n, fn)

    def host(self) -> List[tuple]:
        """The launches with their lengths on the host."""
        return [(kind, shape, nk, item, lengths.cpu().tolist())
                for kind, shape, nk, item, lengths in self.launches]
