"""Parsing and naming for the grid's adversary axis (the port of
`repro.adversary.spec`; pure Python).

The axis value is a compact string — ``none``, ``eavesdrop:p``,
``collude:c``, ``byzantine:b`` — because grid axes travel through
scenario names, JSON artifacts, and CLI flags.  This module is the one
place that string is interpreted.

* ``eavesdrop:p`` — a passive attacker intercepting each transmitted
  coded tuple independently with probability p (or, on hierarchical
  cells, tapping a fraction p of the edge→server links).
* ``collude:c``  — c clients pool their own plaintext packets with the
  eavesdropper: c free identity rows in the attacker's basis.
* ``byzantine:b`` — an active interior node corrupting each tuple with
  probability b (see :class:`repro_torch.adversary.ByzantineChannel`).
"""
from __future__ import annotations

from dataclasses import dataclass

KINDS = ("none", "eavesdrop", "collude", "byzantine")


@dataclass(frozen=True)
class AdversarySpec:
    """One parsed adversary-axis value.

    >>> AdversarySpec.parse("eavesdrop:0.5")
    AdversarySpec(kind='eavesdrop', param=0.5)
    >>> AdversarySpec.parse("none").none
    True
    >>> str(AdversarySpec.parse("collude:3"))
    'collude:3'
    >>> AdversarySpec.parse("byzantine:0.1").tag
    'byzantine0.1'
    """

    kind: str = "none"
    param: float = 0.0

    @classmethod
    def parse(cls, text: str) -> "AdversarySpec":
        text = str(text).strip()
        if text in ("", "none"):
            return cls()
        if ":" not in text:
            raise ValueError(f"adversary {text!r}: expected kind:param "
                             f"with kind in {KINDS[1:]}")
        kind, _, raw = text.partition(":")
        if kind not in KINDS[1:]:
            raise ValueError(f"unknown adversary kind {kind!r} "
                             f"(choose from {KINDS})")
        param = float(raw)
        if kind == "collude":
            if param != int(param) or param < 1:
                raise ValueError(
                    f"collude:{raw}: colluder count must be a positive "
                    "integer")
        elif not 0.0 <= param <= 1.0:
            raise ValueError(f"{kind}:{raw}: probability outside [0, 1]")
        return cls(kind=kind, param=param)

    @property
    def none(self) -> bool:
        return self.kind == "none"

    @property
    def count(self) -> int:
        """The integer reading of `param` (colluder count)."""
        return int(self.param)

    @property
    def tag(self) -> str:
        """Name-safe form for scenario names (no ':')."""
        return "none" if self.none else f"{self.kind}{self.param:g}"

    def __str__(self) -> str:
        if self.none:
            return "none"
        if self.kind == "collude":
            return f"collude:{self.count}"
        return f"{self.kind}:{self.param:g}"
