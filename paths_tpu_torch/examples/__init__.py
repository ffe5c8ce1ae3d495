"""The repository's end-to-end runs on the port: the flagship dress
rehearsal, the cohort soak and the synthetic demo, each the counterpart of
the JAX package's script of the same name under `examples/`:

    python -m paths_tpu_torch.examples.flagship_dress_rehearsal [--record]
    python -m paths_tpu_torch.examples.cohort_soak [--record]
    python -m paths_tpu_torch.examples.run_synthetic_demo

Each runs on the card unless `--device cpu` is given; `--device cuda` on a
host without one raises. `--record` writes a run's record under
`paths_tpu_torch/examples/records/`. Without `--workdir`, a run works in a
new directory under the temp dir (`TMPDIR` where set) and removes it at
the end.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "records")
FLAGSHIP_DIR = os.path.join(REPO, "models", "brca_paths_0")


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a host without a card
    raises (the runs never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device on this host "
                           "(pass --device cpu to run on the CPU)")
    return device


def work_dir(path: Optional[str], name: str) -> Tuple[str, bool]:
    """(`path`, False) where a work dir is named, else (a new directory
    under the temp dir, True): one per run, so that two runs on one host
    never share or remove each other's data."""
    if path:
        return path, False
    return tempfile.mkdtemp(prefix=f"{name}_"), True


def _stamp_path(store_dir: str) -> str:
    return os.path.normpath(store_dir) + ".json"


def stamp_store(store_dir: str, **params) -> None:
    """Record beside a synthetic store the parameters it was made with."""
    with open(_stamp_path(store_dir), "w") as f:
        json.dump(params, f, sort_keys=True)


def store_made_with(store_dir: str, **params) -> bool:
    """True where `store_dir` holds a synthetic store made with `params`,
    False where there is none; a store made with other parameters, or with
    none recorded, raises rather than being reused."""
    if not os.path.isdir(store_dir):
        return False
    want = json.loads(json.dumps(params, sort_keys=True))
    try:
        with open(_stamp_path(store_dir)) as f:
            got = json.load(f)
    except FileNotFoundError:
        got = None
    if got != want:
        raise ValueError(f"{store_dir} holds a store made with {got}, not "
                         f"{want}: name another work dir")
    return True


def card_name(device: torch.device):
    """The card's name and power limit as `nvidia-smi` reports them, or
    None for a CPU run."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def flash_counters():
    """The launch counters of kernels #1-#3 (`kernels/flash_attention.py`)."""
    from paths_tpu_torch.kernels import flash_attention as tfa

    return (tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
            tfa.masked_flash_attention_bwd_dkv)


def reset_flash_launches() -> None:
    for fn in flash_counters():
        fn.launches = 0


def flash_launches() -> dict:
    return {fn.__name__: fn.launches for fn in flash_counters()}
