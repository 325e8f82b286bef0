"""Resolve the ``device`` argument of the port's entry points.

``"cuda"`` needs a usable GPU and raises without one: the port never drops
to the CPU on its own.  ``"cpu"`` runs the kernels' plain PyTorch versions
and is taken only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} needs a usable CUDA GPU and torch "
                "finds none; pass device='cpu' to run the plain versions")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
