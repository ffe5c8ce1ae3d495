"""Process-group setup for the entry points (counterpart of
`paths_tpu.runtime.maybe_init_distributed`).

JAX runs one controller that sees every device of a host. The port runs one
process per card, as `torchrun --nproc-per-node N` starts them, and joins
them in a `torch.distributed` process group: NCCL between cards, gloo on the
CPU. The process group is the `data` axis of training and `cli.evaluate`
(`parallel/mesh.py::mesh_from_config`).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# what torchrun sets for every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def rank_device(device="cuda") -> torch.device:
    """The device this process runs on. Under torchrun an unindexed "cuda"
    is this rank's card, `cuda:{LOCAL_RANK}`; a host with fewer cards than
    that raises (two ranks never share a card by accident). An indexed card
    or the CPU is taken as given."""
    device = torch.device(device)
    if (device.type != "cuda" or device.index is not None
            or "LOCAL_RANK" not in os.environ):
        return device
    local = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(
            f"LOCAL_RANK {local}, but this host has {count} CUDA device(s): "
            f"start at most {count} processes per host, or pass a device")
    return torch.device("cuda", local)


def maybe_init_distributed(backend: Optional[str] = None, device="cuda",
                           timeout: Optional[float] = None) -> bool:
    """Join the process group that torchrun's environment describes; a no-op
    that returns False without that environment, as JAX's is without a
    coordinator address. Returns True once the group exists (also when it
    existed before the call).

    :param backend: "nccl" when this rank's device is a card, "gloo" on the
        CPU, unless given (two ranks on one card need "gloo": NCCL refuses
        them)
    :param device: this rank's device, resolved by `rank_device`; a card
        becomes the current CUDA device
    :param timeout: seconds a collective may wait for the other ranks
        (torch's default when None)
    """
    if dist.is_initialized():
        return True
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if not present:
        return False
    if len(present) < len(TORCHRUN_ENV):
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        raise RuntimeError(
            f"{', '.join(present)} set but {', '.join(missing)} not: a process "
            "group needs all of " + ", ".join(TORCHRUN_ENV))
    device = rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return True
