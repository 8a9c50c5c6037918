"""Structured diagnostics for vscheck (the static IR verifier).

The port's own copy of `repro/analysis/diagnostics.py`.  Every finding is
a `Diagnostic`: a stable rule id (the catalog below), a severity, the
layer path it anchors to (``net/layer``), a message and a fix hint.
`Report` collects them per run; `VSCheckError` carries error diagnostics
across an API boundary (`launch.serve.CNNServer` refusing an invalid net
before it places any weights).

The catalog is the reference's whole vocabulary: the IR rules (VSC1xx,
`analysis.ir`), the kernel-contract rules (VSC2xx, `analysis.contracts`)
and the lint rules (VSC3xx, `analysis.lint`).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Diagnostic", "Report", "VSCheckError", "RULES"]


# Rule catalog: id -> one-line description.  IR rules are VSC1xx, kernel
# contract rules VSC2xx, source lint rules VSC3xx.
RULES: dict[str, str] = {
    # -- IR validation (shape/geometry inference over LayerSpec graphs) ----
    "VSC101": "Conv input channel mismatch (stream C != Conv.cin)",
    "VSC102": "invalid grouped geometry (cin or cout not divisible by groups)",
    "VSC103": "non-positive kernel/stride/dilation/channel parameter",
    "VSC104": "read of an undefined saved slot (src/residual/ResidualAdd)",
    "VSC105": "residual arm shape mismatch at the fused add",
    "VSC106": "FC fan-in mismatch (flattened features != FC.din)",
    "VSC107": "rank mismatch (FC on 4-D stream / Conv after Flatten)",
    "VSC108": "pool window collapses the feature map (output dim < 1)",
    "VSC109": "depthwise channel-multiplier > 1 without allow_fallback "
              "(vk==1 grouped fallback is MXU-wasteful)",
    "VSC110": "output strip shrunk far below vn (non-tileable Cout)",
    "VSC111": "cin zero-padding exceeds the real channel count",
    "VSC112": "kernel extent exceeds the input extent (taps read padding "
              "only)",
    "VSC116": "FC fan-in not a vk multiple: layer stays dense at sparsify",
    # -- kernel contract checking (abstract index-map evaluation) ----------
    "VSC201": "block read escapes the padded buffer bounds",
    "VSC202": "abstractly derived bytes != kernel CostEstimate bytes",
    "VSC203": "abstractly derived bytes != conv_layer_traffic model bytes",
    "VSC204": "faithful revisit simulation exceeds the contract bytes "
              "(cost formula is not a sound upper bound)",
    "VSC205": "abstractly derived FLOPs != kernel CostEstimate FLOPs",
    # -- repo lint (AST rules over src/ + benchmarks/) ---------------------
    "VSC301": "impl= string literal outside the dispatch vocabulary",
    "VSC302": "clock read feeding scheduler control flow",
    "VSC303": "module-scope environment mutation outside a main() guard",
    "VSC304": "bare/blanket except in the serving launch layer (swallows "
              "typed replica faults)",
}

_SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding; ``path`` anchors it (``net/layer``)."""

    rule: str
    severity: str
    path: str
    message: str
    hint: str = ""

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"unknown diagnostic rule {self.rule!r}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        hint = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{self.severity}[{self.rule}] {self.path}: {self.message}{hint}"


class VSCheckError(Exception):
    """An operation refused because vscheck diagnostics rate it invalid."""

    def __init__(self,
                 diagnostics: list[Diagnostic] | Diagnostic) -> None:
        if isinstance(diagnostics, Diagnostic):
            diagnostics = [diagnostics]
        self.diagnostics = list(diagnostics)
        super().__init__(
            "\n".join(d.render() for d in self.diagnostics) or "vscheck failed")


@dataclasses.dataclass
class Report:
    """Collected diagnostics of one analyzer run."""

    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)

    def add(self, rule: str, severity: str, path: str, message: str,
            hint: str = "") -> None:
        self.diagnostics.append(Diagnostic(rule, severity, path, message, hint))

    def error(self, rule: str, path: str, message: str, hint: str = "") -> None:
        self.add(rule, "error", path, message, hint)

    def warn(self, rule: str, path: str, message: str, hint: str = "") -> None:
        self.add(rule, "warning", path, message, hint)

    def extend(self, other: "Report") -> None:
        self.diagnostics.extend(other.diagnostics)

    def suppress(self, rules: set[str]) -> "Report":
        """A copy without diagnostics whose rule id is in ``rules``."""
        return Report([d for d in self.diagnostics if d.rule not in rules])

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def ok(self, *, warnings_as_errors: bool = False) -> bool:
        if warnings_as_errors:
            return not self.diagnostics
        return not self.errors

    def render(self) -> str:
        return "\n".join(d.render() for d in self.diagnostics)

    def raise_errors(self) -> None:
        if self.errors:
            raise VSCheckError(self.errors)
