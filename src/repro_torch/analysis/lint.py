"""vscheck pass 3 — repo-specific AST lint rules (the port's copy of
`repro/analysis/lint.py`, with the port's vocabulary and paths).

Stdlib-`ast` rules for invariants this codebase cares about and generic
linters can't know:

  VSC301  ``impl=`` keyword string literals must come from the dispatch
          vocabulary (`kernels.ops.vsconv` takes 'halo'/'stack',
          `core.sparse_ops` 'plain'/'jnp'/'pallas'/'pallas-halo'/
          'pallas-stack'/'auto') — a typo'd impl string otherwise
          surfaces as a runtime ValueError deep inside a sweep;
  VSC302  wall-clock reads (`time.time`/`monotonic`/`perf_counter`)
          must not appear in `if`/`while` conditions of the serving
          scheduler (`launch/scheduler.py`) — timing-dependent control
          flow makes the replica scheduler non-reproducible; clocks are
          fine in stats/telemetry straight-line code;
  VSC303  module scope must not mutate ``os.environ`` — import order
          then silently decides library flags; mutations belong inside
          ``main()`` / under ``if __name__ == "__main__":``;
  VSC304  no bare or blanket ``except`` (``except:``, ``except
          Exception`` / ``BaseException``) in the serving launch layer
          (`repro_torch/launch/`) — the fleet scheduler's fault tolerance
          relies on replica faults being *typed*
          (`launch.faults.FAULT_TYPES`); an overbroad handler between
          the backend and the scheduler silently swallows the fault and
          defeats quarantine/requeue (and chaos testing with it).

`lint_paths` lints ``src/repro_torch`` and the port's scripts at the
repository root.
"""
from __future__ import annotations

import ast
import pathlib
import re

from .diagnostics import Report

__all__ = ["IMPL_VOCAB", "ROOT_SCRIPTS", "lint_source", "lint_paths"]


# every impl= string the dispatch layers accept
IMPL_VOCAB = frozenset(
    {"halo", "stack", "plain", "jnp", "pallas", "pallas-halo",
     "pallas-stack", "auto"})

_CLOCK_ATTRS = frozenset({"time", "monotonic", "perf_counter"})

# VSC302 only applies where timing-dependent branches are a correctness
# hazard (the serving scheduler's placement/retry logic)
_SCHEDULER_HINTS = ("scheduler",)

# VSC304 applies to the serving launch layer, where fault handling must
# stay typed (FAULT_TYPES) for quarantine/requeue to see replica faults
_LAUNCH_HINTS = ("launch",)

_BLANKET_EXCEPTIONS = frozenset({"Exception", "BaseException"})


def _blanket_name(handler: ast.ExceptHandler) -> str | None:
    """The blanket type a handler catches, if any: None type (bare
    ``except:``), ``Exception``/``BaseException`` by name or attribute,
    including inside a tuple of types."""
    t = handler.type
    if t is None:
        return "bare except:"
    types = list(t.elts) if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name in _BLANKET_EXCEPTIONS:
            return f"except {name}"
    return None


def _is_clock_call(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    f = node.func
    return (f.attr in _CLOCK_ATTRS and isinstance(f.value, ast.Name)
            and f.value.id == "time")


def _is_environ(node: ast.AST) -> bool:
    """os.environ / environ attribute chains."""
    return ((isinstance(node, ast.Attribute) and node.attr == "environ")
            or (isinstance(node, ast.Name) and node.id == "environ"))


def _is_main_guard(node: ast.stmt) -> bool:
    return (isinstance(node, ast.If)
            and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name)
            and node.test.left.id == "__name__")


_IGNORE_RE = re.compile(r"#\s*vscheck:\s*ignore\[([A-Z0-9, ]+)\]")


def _inline_ignores(src: str) -> dict[int, frozenset[str]]:
    """``# vscheck: ignore[VSC303]`` waivers, keyed by 1-based line.
    A waiver covers its own line and the one below it (so it can sit on
    a comment line above a statement too long to share)."""
    out: dict[int, frozenset[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if m:
            rules = frozenset(r.strip() for r in m.group(1).split(","))
            out[i] = out.get(i, frozenset()) | rules
            out[i + 1] = out.get(i + 1, frozenset()) | rules
    return out


def lint_source(src: str, filename: str, *, rep: Report) -> None:
    """All three rules over one file's source text.  A finding whose line
    carries ``# vscheck: ignore[RULE]`` is waived (for findings that are
    genuinely load-bearing; the waiver says why)."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        rep.error("VSC303", f"{filename}:{e.lineno or 0}",
                  f"file does not parse: {e.msg}")
        return
    ignores = _inline_ignores(src)

    def emit(rule: str, lineno: int, message: str, hint: str = "") -> None:
        if rule in ignores.get(lineno, ()):
            return
        rep.error(rule, f"{filename}:{lineno}", message, hint)

    parts = pathlib.PurePath(filename).parts
    is_scheduler = any(h in pathlib.PurePath(filename).name
                       for h in _SCHEDULER_HINTS)
    is_launch = any(h in parts for h in _LAUNCH_HINTS)

    # VSC301 — impl= literals
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg != "impl":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                    and v.value not in IMPL_VOCAB:
                emit(
                    "VSC301", v.lineno,
                    f"impl={v.value!r} is not in the dispatch vocabulary "
                    f"{sorted(IMPL_VOCAB)}",
                    hint="typo'd impl strings raise ValueError at run "
                         "time, deep inside a sweep")

    # VSC302 — clock reads in scheduler control flow
    if is_scheduler:
        for node in ast.walk(tree):
            if isinstance(node, (ast.If, ast.While)):
                for sub in ast.walk(node.test):
                    if _is_clock_call(sub):
                        emit(
                            "VSC302", sub.lineno,
                            "wall-clock read inside a scheduler branch "
                            "condition",
                            hint="read the clock into stats outside the "
                                 "branch; decide on counters/queue state")

    # VSC304 — blanket excepts in the launch layer
    if is_launch:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            blanket = _blanket_name(node)
            if blanket is not None:
                emit(
                    "VSC304", node.lineno,
                    f"{blanket} in the serving launch layer swallows typed "
                    f"replica faults",
                    hint="catch the concrete exception types (e.g. "
                         "launch.faults.FAULT_TYPES) so the fleet "
                         "scheduler's quarantine/requeue sees the fault")

    # VSC303 — module-scope os.environ mutation
    def check_stmt(st: ast.stmt) -> None:
        for node in ast.walk(st):
            bad = False
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                bad = any(isinstance(t, ast.Subscript)
                          and _is_environ(t.value) for t in targets)
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("setdefault", "update", "pop",
                                           "clear")
                    and _is_environ(node.func.value)):
                bad = True
            if bad:
                emit(
                    "VSC303", node.lineno,
                    "os.environ mutated at module scope (import-order "
                    "dependent)",
                    hint="move it into main() / the "
                         "__name__ == '__main__' guard")

    def scan_stmts(stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # deferred bodies don't run at import time
            if _is_main_guard(st):
                continue
            if isinstance(st, (ast.If, ast.For, ast.While, ast.With,
                               ast.Try)):
                # compound statements' bodies still execute at import time
                scan_stmts(st.body)
                scan_stmts(getattr(st, "orelse", []) or [])
                scan_stmts(getattr(st, "finalbody", []) or [])
                for h in getattr(st, "handlers", []) or []:
                    scan_stmts(h.body)
            else:
                check_stmt(st)

    scan_stmts(tree.body)


# the port's scripts at the repository root
ROOT_SCRIPTS = ("chip_smoke.py", "serve_ab.py", "calibrate_torch.py")


def lint_paths(root: pathlib.Path, *, rep: Report,
               subdirs: tuple[str, ...] = ("src/repro_torch",),
               scripts: tuple[str, ...] = ROOT_SCRIPTS) -> int:
    """Lint every .py file under ``root``'s code subdirs and the named
    root scripts; returns the file count."""
    paths = [p for sub in subdirs if (root / sub).is_dir()
             for p in sorted((root / sub).rglob("*.py"))]
    paths += [root / s for s in scripts if (root / s).is_file()]
    for p in paths:
        lint_source(p.read_text(), str(p.relative_to(root)), rep=rep)
    return len(paths)
