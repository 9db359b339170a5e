"""Device selection and numeric settings for the port's entry points.

The device always comes from the caller.  Nothing here picks the CPU
because CUDA is missing: asking for ``"cuda"`` on a machine without a
card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str, torch.device) -> torch.device, validated.

    A CUDA device without a usable card raises ``RuntimeError`` instead of
    quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_precision_matmul() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    TF32 keeps ~10 mantissa bits: the acquisition fold matmul (the Doppler
    wipe-off over code periods) and the refinement FFT products must not
    run in it, or SNRs and refined code phases drift from the reference.
    Called by every entry point (Receiver, FoldedSearcher, the CLI).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
