"""Device resolution shared by the CLIs and the library's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device`` (``"cuda"``, ``"cpu"``, or a
    ``torch.device``); a CUDA device without a GPU raises: nothing falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda requested but torch.cuda.is_available() is "
                "False; pass --device cpu (device='cpu') to run on the CPU")
        if device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return device
