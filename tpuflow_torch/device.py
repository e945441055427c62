"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Where no GPU is present they
raise instead of running on the CPU unasked; the CPU runs only when the
caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, raising if it is a CUDA
    device and none is available.

    On a CUDA device this also pins float32 convolutions and matrix
    products to full float32: cuDNN defaults to TF32 convolutions, which
    keep about three decimal digits and would put the flow's f32
    reverse path at TF32 precision.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpuflow_torch: CUDA device requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
