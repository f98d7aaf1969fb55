"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Asking
for CUDA where there is none raises: the port never falls back to the CPU
on its own.  Tests pass ``device="cpu"``, where every kernel wrapper runs
its plain PyTorch version.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``str | torch.device`` -> ``torch.device``; raises if CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(device: torch.device):
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
