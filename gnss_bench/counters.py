"""The counters the program registers (``tpu_gnss_torch.utils.metrics.
COUNTERS``), for the readers of a count that an older program does not
keep: where the name is not registered, no count of it is no zero."""

from __future__ import annotations


def registered(name: str) -> bool:
    """Whether the program counts ``name``."""
    from tpu_gnss_torch.utils import metrics
    return name in dict(getattr(metrics, "COUNTERS", ()))
