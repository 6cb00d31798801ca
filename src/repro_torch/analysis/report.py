"""Structured violation reporting shared by the three analysis passes.

Counterpart of ``repro/analysis/report.py``, with the same names and rule
IDs, so that the two packages' reports compare entry for entry."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: a stable rule ID plus human-readable context.

    ``rule`` is the catalogue key (``PF-*`` flow, ``HA-*`` trace audit,
    ``KG-*`` kernel geometry — see ``src/repro_torch/analysis/README.md``);
    ``where`` points at the offending trace node or call site.
    """

    rule: str
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.rule}{loc}: {self.message}"


@dataclasses.dataclass
class Report:
    """The outcome of one pass over one subject (a step, a trace, a site).

    ``checked`` records every rule the pass evaluated, so a clean report
    is evidence the rules RAN, not that the pass silently skipped them.
    """

    name: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    checked: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, rule: str, message: str, where: str = "") -> None:
        self.violations.append(Violation(rule, message, where))

    def mark_checked(self, *rules: str) -> None:
        for r in rules:
            if r not in self.checked:
                self.checked.append(r)

    def merge(self, other: "Report") -> "Report":
        self.violations.extend(other.violations)
        self.mark_checked(*other.checked)
        return self

    def rules_fired(self) -> Tuple[str, ...]:
        return tuple(sorted({v.rule for v in self.violations}))

    def summary(self) -> str:
        head = (f"{self.name}: OK ({len(self.checked)} rules)" if self.ok
                else f"{self.name}: {len(self.violations)} violation(s)")
        body = "".join(f"\n  {v}" for v in self.violations)
        return head + body
