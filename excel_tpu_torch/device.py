"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks for
    the CPU. A GPU request on a machine without one raises; nothing falls
    back to the CPU quietly. On a rank that torchrun started (LOCAL_RANK
    set), "cuda" means the rank's own card, cuda:{LOCAL_RANK}; a device
    named with its index is that device. A card that does not exist
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if device.index is None and "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        if (device.index is not None
                and device.index >= torch.cuda.device_count()):
            raise RuntimeError(
                f"{device} does not exist: {torch.cuda.device_count()} "
                "CUDA device(s); ranks that share a card name it "
                "(--device cuda:0) and take --dist-backend gloo")
    return device
