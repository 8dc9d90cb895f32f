"""Structured diagnostics: a stable ``ADTxxx`` code, a severity, where,
a message and a fix.

The port's copy of ``autodist_tpu/analysis/diagnostics.py`` for the
codes its rules emit (:data:`CODES`): a code never changes meaning, and
:class:`Diagnostic` refuses an unregistered one.
"""
from __future__ import annotations

import dataclasses
import json

ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

# code -> (default severity, one-line summary), as in the JAX package.
CODES: dict = {
    "ADT060": (ERROR, "model/pipeline sharding rides the cross-slice "
                      "dcn axis (DCN carries only data parallelism)"),
    "ADT061": (WARNING, "expert axis sharded across the DCN slice "
                        "boundary (every dispatch/combine all_to_all "
                        "rides the slow inter-slice links)"),
    "ADT070": (ERROR, "reshard source/target state trees incompatible "
                      "(leaf set or logical shape/dtype mismatch)"),
    "ADT071": (WARNING, "compressor error-feedback state not "
                        "transferable across this reshard "
                        "(reinitialized on the target)"),
    "ADT080": (ERROR, "supervised escalation with no saver attached "
                      "(shrink-to-survivors would resume from nothing: "
                      "silent state loss)"),
    "ADT081": (ERROR, "heartbeat interval >= heartbeat timeout (every "
                      "healthy worker is declared dead between beats)"),
    "ADT082": (WARNING, "worst-case restart backoff exceeds the SSP "
                        "staleness window (every peer stalls at the "
                        "gate while the worker restarts)"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code, severity, location, message, fix."""

    code: str
    message: str
    where: str = ""          # var name / boundary / program / file:line
    severity: str = ""       # default: the code's registered severity
    fix: str = ""            # suggested fix, one line
    rule: str = ""           # rule name that produced it

    def __post_init__(self):
        if self.code not in CODES:
            raise KeyError(f"unregistered diagnostic code {self.code!r}; "
                           "add it to analysis.diagnostics.CODES")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])
        if self.severity not in _SEVERITY_ORDER:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        loc = f" [{self.where}]" if self.where else ""
        fix = f" (fix: {self.fix})" if self.fix else ""
        return f"{self.code} {self.severity.upper()}{loc}: " \
               f"{self.message}{fix}"


class LintReport:
    """An ordered collection of diagnostics with severity accessors."""

    def __init__(self, diagnostics=()):
        self.diagnostics: list = list(diagnostics)

    def extend(self, diags):
        self.diagnostics.extend(diags)
        return self

    @property
    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No ERRORs (warnings do not fail)."""
        return not self.errors

    def codes(self) -> set:
        return {d.code for d in self.diagnostics}

    def by_code(self, code: str) -> list:
        return [d for d in self.diagnostics if d.code == code]

    def sorted(self) -> "LintReport":
        return LintReport(sorted(
            self.diagnostics,
            key=lambda d: (_SEVERITY_ORDER[d.severity], d.code, d.where)))

    def render(self, title: str = "") -> str:
        lines = [f"== {title} =="] if title else []
        if not self.diagnostics:
            lines.append("clean (no diagnostics)")
        else:
            lines.extend(str(d) for d in self.sorted().diagnostics)
            lines.append(f"{len(self.errors)} error(s), "
                         f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok, "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.sorted().diagnostics],
        }, indent=1)

    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)
