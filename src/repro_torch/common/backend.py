"""Device resolution for the port's entry points.

There is no environment override: the kernels are chosen by the device of
the tensors they are handed (see ``kernels/compress.py``), and the device
is whatever the caller asked for.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if CUDA is asked for and absent.

    Also pins fp32 to fp32: TF32 is switched off for matmuls and cuDNN, so
    the card computes what the CPU reference computes.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
