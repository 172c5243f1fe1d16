"""Device selection for the port's entry points.

Every entry point runs on ``cuda:{index}`` unless its caller names another
device (the CPU tests pass ``device="cpu"``). A CUDA request on a host
without CUDA raises: nothing falls back to the CPU on its own.

TF32 is pinned off for both matrix products and cuDNN convolutions. The
port computes in bf16 by default; ``--dtype float32`` is the parity mode
that the tests hold against the JAX package, and there float32 has to mean
float32 (TF32 keeps ~3 decimal digits, and cuDNN would use it for fp32
convolutions by default).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def select_device(
    device: Optional[Union[str, torch.device]] = None, index: int = 0
) -> torch.device:
    """``device`` if given, else ``cuda:{index}``; raises when that is a CUDA
    device and CUDA is not available."""
    dev = torch.device(device if device is not None else f"cuda:{index}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
