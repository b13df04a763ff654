"""The one device policy of the port.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
There is no silent CPU path: asking for CUDA on a machine without a card
raises. On CUDA the float32 lane is full float32 (TF32 off for both matmul
and cuDNN convolutions), so an f32 pipeline on the card is comparable with
the CPU one; the served lane is bf16 (:func:`serving_dtype`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return an explicit ``torch.device``; raise if CUDA is asked for and
    absent. Sets the float32 policy (TF32 off) when the device is CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly for the CPU lane"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def serving_dtype(device: torch.device) -> torch.dtype:
    """Serving precision: bf16 on the card (with the CUDA kernels), f32 on
    the CPU (with the plain versions), as the JAX package served bf16 on
    its accelerator and f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
