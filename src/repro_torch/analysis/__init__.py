"""vscheck pass 1 for the port: the IR gate that `launch.serve.CNNServer`
runs before it places any weights.

`diagnostics` holds the error vocabulary (`Diagnostic`, `Report`,
`VSCheckError`, the rule catalog `RULES`); `ir` walks a
`models.graph.SparseNet` (`check_net`).  The reference's passes 2 and 3
(kernel contracts and the repo lint) are not ported yet.
"""
from __future__ import annotations

from .diagnostics import RULES, Diagnostic, Report, VSCheckError
from .ir import ConvSite, FCSite, NetCheck, check_net

__all__ = ["RULES", "Diagnostic", "Report", "VSCheckError", "ConvSite",
           "FCSite", "NetCheck", "check_net"]
