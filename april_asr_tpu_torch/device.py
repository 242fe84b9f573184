"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, which runs every kernel's plain PyTorch version). Without
`device=` and without a CUDA device they raise: the port never drops to the
CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def exact_float_math() -> None:
    """Full-f32 products and convolutions on the card: PyTorch's cuDNN
    convolutions default to TF32, which keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
