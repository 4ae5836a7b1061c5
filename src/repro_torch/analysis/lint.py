"""AST lint passes for the agnocast shm protocol (``agnolint``), aimed at
the port's files.

The registry's correctness argument (see the "Invariants" section of
``repro_torch/core/registry.py``) rests on a small number of *syntactically
checkable* disciplines.  Each is a rule here:

``AGNO-LOCK-001`` — **lock discipline.**  Any store into registry shm
    (a subscript assignment whose base aliases an ``np.frombuffer`` /
    ``shm.buf`` view, or a ``pack_into`` targeting one) must happen
    inside a write-locked context: ``with self._locked(tidx)`` (the
    seqlock'd topic critical section), ``with self._topic_flock(tidx)``
    (the raw topic lock — seqlock handling is the callee's contract) or
    ``with self._lock`` (the domain lock, for the name table/header).
    ``_locked(..., write=False)`` is a *read* fallback and does NOT
    license writes.  The sanctioned lock-free stores (the ``released``
    byte, waiter/lease stamps, single-writer rings) carry inline
    ``# agnolint: allow[AGNO-LOCK-001] -- why`` justifications, or a
    ``# agnolint: single-writer -- why`` class directive, or a
    ``# agnolint: locked-context -- why`` function directive for helpers
    whose caller holds the lock.  Every suppression is counted in the
    report; one without a justification is itself a violation.

``AGNO-LOCK-002`` — **lock order.**  The only sanctioned nesting is
    domain → topic.  Acquiring the domain lock under a topic lock, or
    nesting two topic locks, deadlocks against ``sweep``/``topic_index``.

``AGNO-LOCK-003`` — **no blocking under a lock.**  Direct calls to
    ``time.sleep``, ``select.select``, ``fcntl.flock``, thread ``join``,
    socket ``recv``/``accept``/``connect``/``sendall``, ``os.waitpid``
    or ``subprocess.run`` inside a held-lock ``with`` block stretch the
    critical section across arbitrary delays.  (Intraprocedural only: a
    blocking call hidden behind a helper is out of scope by design.)

``AGNO-HOT-001`` — **no ``time.sleep`` on publish paths** (modules
    ``repro_torch/core/topic.py``, ``core/routing.py``,
    ``core/executor.py``):
    backpressure is event-driven (slot-freed FIFOs), never a retry nap.
    ``registry.py`` is deliberately *excluded*: its two sleeps are
    bounded protocol retries that run outside any lock.

``AGNO-HOT-002`` — **no queue-full retry coupling** in
    ``repro_torch/data/pipeline.py``, ``data/ordered.py`` (the in-order
    batch publisher the trainer reads) and ``apps/pointcloud.py``:
    app-layer code must use ``publish_blocking``; referencing
    ``AgnocastQueueFull`` there means a poll-retry loop crept back in.

``AGNO-HOT-003`` — **trace-emit purity.**  ``TraceRing.emit``/``emit2``
    (``repro_torch/obs/trace.py``) are called on closed-loop hot paths;
    their bodies may only call the
    pre-bound ``self._pack``/``self._mono`` (or locals bound from them)
    and must not allocate (comprehensions, literals, f-strings) or take
    locks (``with``).

``AGNO-CNT-001`` — **no bare cross-thread counters.**  In a class that
    already creates ``metrics.counter(...)`` instruments, a plain
    ``self.x += n`` outside a ``with self.<thread-lock>`` block is a
    racy lost update.

``AGNO-SUPP-001`` — a ``# agnolint:`` directive with no
    ``-- justification`` text.

Directive grammar (line comments)::

    # agnolint: allow[RULE-ID] -- justification     (this line only)
    # agnolint: locked-context -- justification     (on a ``def`` line)
    # agnolint: single-writer -- justification      (on a ``class`` line)

Fixture tests drive :func:`lint_source` with virtual paths so each rule
has a minimal violating and a clean snippet (``tests/test_torch_analysis.py``
runs the reference's fixtures through this copy on ``repro_torch/...``
paths).  The rules are the reference's (``repro/analysis/lint.py``); the
path-scoped ones match the port's modules, which the reference's suffixes
never do.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field, asdict

__all__ = ["Finding", "Suppression", "Report", "lint_source", "lint_paths",
           "RULES"]

RULES = {
    "AGNO-LOCK-001": "registry-shm write outside a write-locked context",
    "AGNO-LOCK-002": "lock-order violation (domain under topic, or nested topic locks)",
    "AGNO-LOCK-003": "blocking call while a lock is held",
    "AGNO-HOT-001": "time.sleep on a publish hot-path module",
    "AGNO-HOT-002": "queue-full retry coupling on an app publish path",
    "AGNO-HOT-003": "allocation/locking/foreign call inside a trace emit body",
    "AGNO-CNT-001": "bare cross-thread counter increment in a metrics-instrumented class",
    "AGNO-SUPP-001": "agnolint suppression without a justification",
}

# modules (posix-relpath suffixes) each HOT rule applies to
_SLEEP_FORBIDDEN = ("repro_torch/core/topic.py", "repro_torch/core/routing.py",
                    "repro_torch/core/executor.py")
_QUEUEFULL_FORBIDDEN = ("repro_torch/data/pipeline.py", "repro_torch/data/ordered.py",
                        "repro_torch/apps/pointcloud.py")
_EMIT_PURE = ("repro_torch/obs/trace.py",)
_EMIT_FUNCS = ("emit", "emit2")

_DIRECTIVE_RE = re.compile(
    r"#\s*agnolint:\s*(allow\[(?P<rule>[A-Z0-9-]+)\]|(?P<kind>locked-context|single-writer))"
    r"(\s*--\s*(?P<why>.*?))?\s*$")

# numpy-view methods that preserve aliasing onto the underlying shm buffer
_ALIAS_PRESERVING = {"view", "reshape", "cast"}
# calls that definitely produce a fresh buffer (break aliasing)
_ALIAS_BREAKING = {"copy", "tobytes", "astype", "bytes"}

_BLOCKING_ATTRS = {"recv", "recv_into", "accept", "connect", "sendall"}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.msg}"


@dataclass
class Suppression:
    rule: str          # rule id, or "*" for scope directives
    path: str
    line: int
    kind: str          # "allow" | "locked-context" | "single-writer"
    justification: str

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class Report:
    findings: list = field(default_factory=list)
    suppressions: list = field(default_factory=list)
    files: list = field(default_factory=list)

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "files": self.files,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressions": [s.to_dict() for s in self.suppressions],
        }


class _Directives:
    """Per-file ``# agnolint:`` comment directives, by line number."""

    def __init__(self, text: str, path: str):
        self.by_line: dict[int, list[tuple[str, str | None, str]]] = {}
        self.suppressions: list[Suppression] = []
        self.findings: list[Finding] = []
        for i, raw in enumerate(text.splitlines(), start=1):
            m = _DIRECTIVE_RE.search(raw)
            if not m:
                continue
            kind = m.group("kind") or "allow"
            rule = m.group("rule")
            why = (m.group("why") or "").strip()
            # a trailing comment governs its own line; a comment-only line
            # governs the next line (the statement/def/class right below)
            target = i if raw.split("#", 1)[0].strip() else i + 1
            self.by_line.setdefault(target, []).append((kind, rule, why))
            self.suppressions.append(Suppression(
                rule=rule or "*", path=path, line=i, kind=kind,
                justification=why))
            if not why:
                self.findings.append(Finding(
                    "AGNO-SUPP-001", path, i,
                    f"agnolint directive {kind!r} has no '-- justification'"))

    def allows(self, rule: str, line: int) -> bool:
        return any(k == "allow" and r == rule
                   for k, r, _ in self.by_line.get(line, ()))

    def scope(self, kind: str, line: int) -> bool:
        return any(k == kind for k, _, _ in self.by_line.get(line, ()))


def _peel_base(node: ast.AST) -> ast.AST:
    """Strip subscripts off a store target: ``a[i]["f"][j]`` → ``a``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def _is_frombuffer_chain(v: ast.AST) -> bool:
    """``np.frombuffer(live_buf, ...)`` possibly wrapped in view-preserving
    calls (``.reshape`` etc.).  ``frombuffer(bytes(...))`` copies and is
    excluded."""
    while isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
            and v.func.attr in _ALIAS_PRESERVING:
        v = v.func.value
    if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
            and v.func.attr == "frombuffer":
        arg = v.args[0] if v.args else None
        return not (isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)
                    and arg.func.id == "bytes")
    return False


def _collect_attr_roots(tree: ast.Module) -> set[str]:
    """Attribute names (``self.X``) holding shm-backed buffers anywhere in
    the module: assigned from ``np.frombuffer(...)``, ``*.buf``, or derived
    from an existing root through alias-preserving ops (to fixpoint)."""
    roots: set[str] = set()

    def rooted(v: ast.AST) -> bool:
        # at class level every non-bytes frombuffer maps live shm — the
        # buffer argument is typically a local (``buf = shm.buf``) whose
        # aliasing we can't see from here
        return _is_frombuffer_chain(v) or _expr_rooted(v, set(), roots)

    for _ in range(4):  # fixpoint for chains like _shm -> _buf -> _head_mv
        before = len(roots)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self" and rooted(node.value):
                roots.add(t.attr)
        if len(roots) == before:
            break
    return roots


def _expr_rooted(v: ast.AST, aliases: set[str], attr_roots: set[str]) -> bool:
    """Does expression ``v`` alias registry/ring shm memory?"""
    if isinstance(v, ast.Name):
        return v.id in aliases
    if isinstance(v, ast.Attribute):
        if v.attr == "buf":          # shm.buf / self._shm.buf
            return True
        return v.attr in attr_roots
    if isinstance(v, ast.Subscript):
        return _expr_rooted(v.value, aliases, attr_roots)
    if isinstance(v, ast.IfExp):
        return (_expr_rooted(v.body, aliases, attr_roots)
                or _expr_rooted(v.orelse, aliases, attr_roots))
    if isinstance(v, ast.Call):
        f = v.func
        if isinstance(f, ast.Attribute):
            if f.attr in _ALIAS_PRESERVING:
                return _expr_rooted(f.value, aliases, attr_roots)
            if f.attr == "frombuffer":   # np.frombuffer(shm.buf, ...)
                # a frombuffer over live shm aliases it; over bytes() it
                # does not — check the first argument
                return bool(v.args) and _expr_rooted(v.args[0], aliases,
                                                     attr_roots)
        return False
    return False


class _LockCtx:
    """One entry of the lexical lock-context stack."""

    __slots__ = ("kind", "write")

    def __init__(self, kind: str, write: bool):
        self.kind = kind      # "topic" | "domain" | "thread"
        self.write = write    # licenses shm writes?


def _classify_with_item(item: ast.withitem) -> _LockCtx | None:
    ctx = item.context_expr
    # with self._locked(tidx[, write=...]) / reg._locked(...)
    if isinstance(ctx, ast.Call) and isinstance(ctx.func, ast.Attribute):
        attr = ctx.func.attr
        if attr == "_locked":
            write = True
            for kw in ctx.keywords:
                if kw.arg == "write" and isinstance(kw.value, ast.Constant):
                    write = bool(kw.value.value)
            return _LockCtx("topic", write)
        if attr == "_topic_flock":
            return _LockCtx("topic", True)
        if attr in ("Lock", "RLock", "Condition"):
            return None  # constructing, not acquiring
    # with self._lock: (the domain flock)
    if isinstance(ctx, ast.Attribute):
        if ctx.attr == "_lock":
            return _LockCtx("domain", True)
        a = ctx.attr.lower()
        if a.endswith(("_mu", "_cond", "lock", "mutex")) or a in ("_mu", "_cond"):
            return _LockCtx("thread", False)
    return None


def _call_name(func: ast.AST) -> str:
    """Dotted name of a call target, best-effort ('time.sleep', '.join')."""
    parts: list[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    else:
        parts.append("")
    return ".".join(reversed(parts))


def _is_blocking_call(node: ast.Call) -> str | None:
    name = _call_name(node.func)
    if name in ("time.sleep", "select.select", "fcntl.flock", "os.waitpid",
                "subprocess.run", "subprocess.check_call",
                "subprocess.check_output"):
        return name
    if isinstance(node.func, ast.Attribute):
        a = node.func.attr
        if a in _BLOCKING_ATTRS:
            return f".{a}"
        if a == "join":
            # distinguish thread.join()/join(timeout) from str.join(iter):
            # a string join always takes exactly one non-numeric argument
            if not node.args or (len(node.args) == 1
                                 and isinstance(node.args[0], ast.Constant)
                                 and isinstance(node.args[0].value, (int, float))):
                return ".join"
    return None


class _FunctionPass(ast.NodeVisitor):
    """Walks one function body with a lexical lock-context stack, emitting
    AGNO-LOCK-001/002/003 findings."""

    def __init__(self, lint: "_FileLint", fn: ast.AST, cls: ast.ClassDef | None):
        self.lint = lint
        self.fn = fn
        self.cls = cls
        self.stack: list[_LockCtx] = []
        self.aliases: set[str] = set()
        d = lint.directives
        self.fn_locked = d.scope("locked-context", fn.lineno)
        self.cls_single = cls is not None and d.scope("single-writer", cls.lineno)

    # -- helpers ---------------------------------------------------------------

    def _held(self, kinds=("topic", "domain", "thread")) -> bool:
        return any(c.kind in kinds for c in self.stack)

    def _write_licensed(self) -> bool:
        return any(c.write for c in self.stack) or self.fn_locked \
            or self.cls_single

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.lint.emit(rule, node.lineno, msg)

    def _rooted(self, v: ast.AST) -> bool:
        return _expr_rooted(v, self.aliases, self.lint.attr_roots)

    # -- statements ------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            ctx = _classify_with_item(item)
            if ctx is None:
                continue
            if ctx.kind == "domain" and self._held(("topic",)):
                self._check(node, "AGNO-LOCK-002",
                            "domain lock acquired while a topic lock is held "
                            "(sanctioned order is domain -> topic)")
            elif ctx.kind == "topic" and self._held(("topic",)):
                self._check(node, "AGNO-LOCK-002",
                            "nested topic locks (topic locks never nest)")
            self.stack.append(ctx)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.stack[len(self.stack) - pushed:len(self.stack)]

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store(t, node)
        # alias tracking: x = <rooted expr> makes x shm-aliased; any other
        # rebind of x kills the alias
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if self._rooted(node.value):
                self.aliases.add(name)
            else:
                self.aliases.discard(name)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # pack_into writes into its first argument
        if isinstance(node.func, ast.Attribute) and node.func.attr == "pack_into":
            if node.args and self._rooted(node.args[0]):
                self._store_finding(node)
        blocking = _is_blocking_call(node)
        if blocking and self._held():
            kinds = ",".join(sorted({c.kind for c in self.stack}))
            self._check(node, "AGNO-LOCK-003",
                        f"blocking call {blocking} while a {kinds} lock is held")
        self.generic_visit(node)

    # nested defs get their own pass (fresh lock context: they run later)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.lint.queue_function(node, self.cls)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.lint.queue_class(node)

    # -- store checking --------------------------------------------------------

    def _check_store(self, target: ast.AST, node: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._check_store(el, node)
            return
        if not isinstance(target, ast.Subscript):
            return
        base = _peel_base(target)
        if self._rooted(base):
            self._store_finding(node)

    def _store_finding(self, node: ast.AST) -> None:
        if self._write_licensed():
            # write=False read contexts deliberately do NOT license
            return
        if self._held(("topic",)) and not self._write_licensed():
            self._check(node, "AGNO-LOCK-001",
                        "shm write under a read-only locked context "
                        "(_locked(..., write=False) does not license writes)")
            return
        self._check(node, "AGNO-LOCK-001",
                    "shm write outside a write-locked context "
                    "(_locked/_topic_flock/_lock)")

    def _check(self, node: ast.AST, rule: str, msg: str) -> None:
        self.lint.emit(rule, node.lineno, msg)


class _FileLint:
    """All passes over one source file."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.directives = _Directives(text, path)
        self.attr_roots = _collect_attr_roots(self.tree)
        self.findings: list[Finding] = list(self.directives.findings)
        self._fn_queue: list[tuple[ast.AST, ast.ClassDef | None]] = []

    def emit(self, rule: str, line: int, msg: str) -> None:
        if self.directives.allows(rule, line):
            return
        self.findings.append(Finding(rule, self.path, line, msg))

    def queue_function(self, fn: ast.AST, cls: ast.ClassDef | None) -> None:
        self._fn_queue.append((fn, cls))

    def queue_class(self, cls: ast.ClassDef) -> None:
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._fn_queue.append((stmt, cls))
            elif isinstance(stmt, ast.ClassDef):
                self.queue_class(stmt)

    def run(self) -> list[Finding]:
        # seed the queue with every function (module-level and class-level)
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._fn_queue.append((stmt, None))
            elif isinstance(stmt, ast.ClassDef):
                self.queue_class(stmt)
        while self._fn_queue:
            fn, cls = self._fn_queue.pop()
            p = _FunctionPass(self, fn, cls)
            for stmt in fn.body:
                p.visit(stmt)
        self._hot_path_rules()
        self._counter_rule()
        return self.findings

    # -- hot-path purity -------------------------------------------------------

    def _hot_path_rules(self) -> None:
        if self.path.endswith(_SLEEP_FORBIDDEN):
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Call) \
                        and _call_name(node.func) == "time.sleep":
                    self.emit("AGNO-HOT-001", node.lineno,
                              "time.sleep on a publish hot-path module "
                              "(backpressure must be event-driven)")
        if self.path.endswith(_QUEUEFULL_FORBIDDEN):
            for node in ast.walk(self.tree):
                name = None
                if isinstance(node, ast.Name):
                    name = node.id
                elif isinstance(node, ast.Attribute):
                    name = node.attr
                if name == "AgnocastQueueFull":
                    self.emit("AGNO-HOT-002", node.lineno,
                              "AgnocastQueueFull referenced on an app publish "
                              "path (use publish_blocking, not retry loops)")
        if self.path.endswith(_EMIT_PURE):
            for node in ast.walk(self.tree):
                if isinstance(node, ast.ClassDef) and node.name == "TraceRing":
                    for stmt in node.body:
                        if isinstance(stmt, ast.FunctionDef) \
                                and stmt.name in _EMIT_FUNCS:
                            self._check_emit_purity(stmt)

    def _check_emit_purity(self, fn: ast.FunctionDef) -> None:
        allowed_attrs = {"_pack", "_mono"}
        bound: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in allowed_attrs:
                bound.add(node.targets[0].id)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                ok = (isinstance(f, ast.Attribute) and f.attr in allowed_attrs) \
                    or (isinstance(f, ast.Name) and f.id in bound)
                if not ok:
                    self.emit("AGNO-HOT-003", node.lineno,
                              f"call to {_call_name(f) or '<expr>'} inside "
                              f"{fn.name} (only the pre-bound _pack/_mono "
                              "are allowed on the emit path)")
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                self.emit("AGNO-HOT-003", node.lineno,
                          f"lock/context acquisition inside {fn.name}")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp, ast.Lambda,
                                   ast.JoinedStr, ast.List, ast.Dict,
                                   ast.Set)):
                self.emit("AGNO-HOT-003", node.lineno,
                          f"allocation ({type(node).__name__}) inside "
                          f"{fn.name}")

    # -- bare counters ---------------------------------------------------------

    def _counter_rule(self) -> None:
        for cls in ast.walk(self.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            instrumented = any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("counter", "gauge")
                and "metrics" in _call_name(n.func.value).lower()
                for n in ast.walk(cls))
            if not instrumented:
                continue
            for fn in (s for s in cls.body if isinstance(s, ast.FunctionDef)):
                self._counter_scan(fn.body, cls, held=False)

    def _counter_scan(self, body, cls, *, held: bool) -> None:
        for stmt in body:
            if isinstance(stmt, ast.With):
                h = held or any(
                    (c := _classify_with_item(i)) is not None
                    and c.kind == "thread"
                    for i in stmt.items)
                self._counter_scan(stmt.body, cls, held=h)
                continue
            if isinstance(stmt, ast.AugAssign) and not held \
                    and isinstance(stmt.op, (ast.Add, ast.Sub)) \
                    and isinstance(stmt.target, ast.Attribute) \
                    and isinstance(stmt.target.value, ast.Name) \
                    and stmt.target.value.id == "self":
                self.emit("AGNO-CNT-001", stmt.lineno,
                          f"bare counter increment self.{stmt.target.attr} "
                          f"+= ... in metrics-instrumented class {cls.name} "
                          "(use metrics.counter(...).inc())")
            # recurse into compound statements (if/for/while/try)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list) and sub \
                        and not isinstance(stmt, (ast.FunctionDef,
                                                  ast.ClassDef)):
                    self._counter_scan(sub, cls, held=held)
            for h in getattr(stmt, "handlers", ()):
                self._counter_scan(h.body, cls, held=held)


def _relpath(path: str, root: str | None) -> str:
    p = os.path.abspath(path)
    if root:
        try:
            p = os.path.relpath(p, root)
        except ValueError:
            pass
    return p.replace(os.sep, "/")


def lint_source(text: str, virtual_path: str) -> Report:
    """Lint one in-memory source blob as if it lived at ``virtual_path``
    (posix-style, e.g. ``"repro_torch/core/topic.py"``).  Used by the fixture
    tests; path-scoped rules key off the suffix."""
    fl = _FileLint(virtual_path, text)
    rep = Report(files=[virtual_path])
    rep.findings = fl.run()
    rep.suppressions = fl.directives.suppressions
    return rep


def lint_paths(paths, *, root: str | None = None) -> Report:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _dirnames, filenames in os.walk(p):
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    rep = Report()
    for f in sorted(files):
        rel = _relpath(f, root)
        rep.files.append(rel)
        with open(f, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            fl = _FileLint(rel, text)
        except SyntaxError as e:
            rep.findings.append(Finding("AGNO-SUPP-001", rel,
                                        e.lineno or 0, f"unparseable: {e}"))
            continue
        rep.findings.extend(fl.run())
        rep.suppressions.extend(fl.directives.suppressions)
    rep.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return rep
