"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``); under a process group of more than
    one rank, the rank's own card ``cuda:{LOCAL_RANK}``, made the current
    device.  Without a GPU that raises: nothing carries on silently on the
    CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions of the
    kernels on the CPU, as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "irw_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        if dist.is_initialized() and dist.get_world_size() > 1:
            index = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            torch.cuda.set_device(index)
            return torch.device("cuda", index)
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but CUDA is not available")
    return device
