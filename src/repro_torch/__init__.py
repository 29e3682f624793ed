"""``repro_torch`` — the PLAID engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (``sm_90a``).

The package mirrors ``repro`` (the JAX/Pallas engine) module for module:
``repro_torch/core/pipeline.py`` is the counterpart of
``repro/core/pipeline.py``, and so on.  It imports torch and numpy only.

Entry points take an explicit ``device=`` that defaults to ``"cuda"`` and
raise when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of every kernel on the host.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ieee_f32_matmul", "resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.

    There is no silent fallback to the CPU: a caller that wants the host
    asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@contextlib.contextmanager
def ieee_f32_matmul():
    """No TF32 for CUDA matmuls inside the block; the caller's setting is
    restored after it.

    The reference computes its products in f32; TF32 keeps ~3 decimal
    digits and would reorder the stage-1 probe.  The switch is scoped to
    the port's own products so that a caller's matmuls keep their setting.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
