"""vscheck — static IR/kernel contract verification for the port's sparse
stack (the port of `repro/analysis/`).

Three passes, runnable standalone (``python -m repro_torch.analysis``):

  1. `analysis.ir`         — shape/geometry inference over `SparseNet`
                             layer graphs (rules VSC1xx); the IR gate that
                             `launch.serve.CNNServer` runs before it places
                             any weights;
  2. `analysis.contracts`  — abstract index-map evaluation proving every
                             registered kernel invocation of the layout and
                             cost contract the port shares with the
                             reference in bounds and its byte/FLOP claim
                             exact (rules VSC2xx);
  3. `analysis.lint`       — repo-specific AST lint (rules VSC3xx).

Only `diagnostics`, `intervals` and `ir` are imported eagerly; the
contract, lint and CLI entry points load on first use via ``__getattr__``,
so importing pass 1 stays cheap.
"""
from __future__ import annotations

import importlib
from typing import Any

from .diagnostics import RULES, Diagnostic, Report, VSCheckError
from .intervals import AbstractIdx, Interval
from .ir import ConvSite, FCSite, NetCheck, check_net

__all__ = [
    "RULES", "Diagnostic", "Report", "VSCheckError",
    "AbstractIdx", "Interval",
    "ConvSite", "FCSite", "NetCheck", "check_net",
    # lazy (see __getattr__): contract, lint and CLI entry points
    "check_contracts", "PlanSummary", "lint_paths", "check_one_net", "main",
]

_LAZY = {
    "check_contracts": "contracts", "PlanSummary": "contracts",
    "lint_paths": "lint",
    "check_one_net": "__main__", "main": "__main__",
}


def __getattr__(name: str) -> Any:
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
