"""Compat shim, as the reference's ``launch/hlo_analysis.py``: the cost
and collective analysis lives in ``repro_torch.analysis.costs``; import it
from there in new code."""
from repro_torch.analysis.costs import (  # noqa: F401
    DTYPE_BYTES,
    KINDS,
    collective_bytes,
    cost_summary,
    memory_summary,
)

__all__ = ["collective_bytes", "DTYPE_BYTES", "cost_summary",
           "memory_summary", "KINDS"]
