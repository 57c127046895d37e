"""Device selection for the port's entry points: CUDA unless the caller
asks for another device, and no silent fallback to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` or CUDA by default; raises when CUDA is asked for and no
    GPU is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
