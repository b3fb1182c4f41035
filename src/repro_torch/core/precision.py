"""Per-layer quantization policy (paper §2.1: hidden 3-bit, output 8-bit).

Port of the reference's ``core/precision.py``. A :class:`QuantPolicy` maps
each weight *role* (hidden / output / embed / router; norms, biases and SSM
dynamics stay float) to a :class:`~repro_torch.core.quantizer.QuantSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.quantizer import QuantSpec

__all__ = ["QuantPolicy", "FLOAT", "W3A8", "W4A8", "W8", "TERNARY"]

_NOQUANT_ROLES = ("norm", "bias", "ssm", "scale")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Maps weight roles to quant specs; controls forward-path mode."""

    mode: str = "float"                 # 'float' | 'fake' | 'packed'
    bits: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=lambda: {"hidden": 3, "output": 8, "embed": 8, "router": 8}
    )
    act_bits: Optional[int] = None      # None = full precision activations
    per_channel: Optional[int] = None   # None = per-tensor (paper); else axis

    def spec_for(self, role: str) -> Optional[QuantSpec]:
        if self.mode == "float":
            return None
        if role in _NOQUANT_ROLES:
            return None
        b = self.bits.get(role, self.bits.get("hidden"))
        if not b:
            return None
        return QuantSpec(bits=b, per_channel=self.per_channel)


FLOAT = QuantPolicy(mode="float")
# The paper's deployed configuration: 3-bit hidden, 8-bit output, 8-bit signals.
W3A8 = QuantPolicy(mode="fake", bits={"hidden": 3, "output": 8, "embed": 8, "router": 8}, act_bits=8)
W4A8 = QuantPolicy(mode="fake", bits={"hidden": 4, "output": 8, "embed": 8, "router": 8}, act_bits=8)
W8 = QuantPolicy(mode="fake", bits={"hidden": 8, "output": 8, "embed": 8, "router": 8})
# Hwang & Sung 2014 ternary (+1, 0, -1) — the paper's reference [14].
TERNARY = QuantPolicy(mode="fake", bits={"hidden": 2, "output": 8, "embed": 8, "router": 8}, act_bits=8)
