"""Layout verifier: extract every hand-maintained shm/wire layout
constant of the port and fail on drift without a version bump
(``AGNO-LAYOUT-*``).

The port carries four independently-versioned binary layouts, each the
reference's byte for byte so that a message published through one
package is taken by the other:

* **registry** (``repro_torch/core/registry.py``) — the shm segment: header,
  name table, journal, topic rows, entry rings.  Version: ``_MAGIC``
  (``0xA6_0C_0D_xx``, low byte = layout revision; the v5→v6 bump is the
  historical precedent this check mechanizes).
* **trace** (``repro_torch/obs/trace.py``) — per-process trace rings: 32-byte
  header + 24-byte records + stage ids.  Version: ``_MAGIC``.
* **transport** (``repro_torch/core/transport.py``) — bus frames: ``_FRAME``
  length prefix, ``_PUBHDR``, fan-out counts, ``K_*`` kinds; plus the
  serialize header from ``messages.py`` that rides inside ``K_PUB``
  payloads.  Version: ``WIRE_REV``.
* **metrics** (``repro_torch/obs/metrics.py``) — seqlock'd export segments.
  Version: ``_MX_MAGIC``.

Everything is extracted *statically*: module sources are parsed to AST
and layout-bearing assignments folded by a restricted evaluator (ints,
strings, tuples, arithmetic, ``np.dtype(...)``, ``struct.Struct(...)``
and their ``itemsize``/``size`` attributes).  No target module is
imported, so the verifier works on a scratch copy of a single file —
which is exactly how the drift test uses it.

Checks:

``AGNO-LAYOUT-001`` — **drift without a version bump.**  Each section's
    extracted constants are canonicalized and fingerprinted (sha256);
    the checked-in baseline is ``src/repro_torch/analysis/layout_lock.json``,
    which equals the reference's ``src/repro/analysis/layout_lock.json``
    section for section (``tests/test_torch_analysis.py`` holds the two
    together).  A changed fingerprint under an unchanged version constant
    fails hard.  A changed version requires regenerating the lock
    (``scripts/agnolint_torch.py --update-layout-lock``) so the bump is
    reviewed together with the layout change.

``AGNO-LAYOUT-002`` — **internal consistency** wherever one layout
    constant is consumed by another: mask widths vs ``MAX_SUBS``,
    journal before-image sizes vs row dtypes, the trace record/header
    sizes vs their documented byte counts, distinct section magics,
    distinct frame kinds, and the deliberately-duplicated
    ``_domain_hash`` in ``metrics.py`` staying token-identical to the
    original in ``trace.py``.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import struct

import numpy as np

from .lint import Finding

__all__ = ["extract_layout", "check_layout", "compute_lock", "LOCK_PATH"]

_HERE = os.path.dirname(os.path.abspath(__file__))
LOCK_PATH = os.path.join(_HERE, "layout_lock.json")

# section -> (module relpath suffix, version constant, layout constants)
SECTIONS = {
    "registry": {
        "file": "repro_torch/core/registry.py",
        "version": "_MAGIC",
        "consts": ["MAX_TOPICS", "MAX_PUBS", "MAX_SUBS", "DEPTH_MAX",
                   "HASH_CAP", "ST_FREE", "ST_USED", "ST_DEAD",
                   "ORIGIN_AGNOCAST", "ORIGIN_BRIDGE",
                   "_J_CLEAN", "_J_PENDING",
                   "TOPIC_DT", "ENTRY_DT", "HASH_DT", "JOURNAL_DT"],
    },
    "trace": {
        "file": "repro_torch/obs/trace.py",
        "version": "_MAGIC",
        "consts": ["_HDR", "_HDR_SIZE", "_REC", "REC_SIZE", "FLAG_EOS",
                   "Stage"],
    },
    "transport": {
        "file": "repro_torch/core/transport.py",
        "version": "WIRE_REV",
        "consts": ["_FRAME", "_PUBHDR", "_FANOUT",
                   "K_PUB", "K_SUB", "K_CTRL", "K_ACK", "K_FANOUT"],
    },
    "metrics": {
        "file": "repro_torch/obs/metrics.py",
        "version": "_MX_MAGIC",
        "consts": ["_MX_HDR", "_MX_SIZE"],
    },
}


class _Unevaluable(Exception):
    pass


class _Eval:
    """Restricted constant folder over module-level assignments."""

    def __init__(self):
        self.env: dict[str, object] = {}

    def run_module(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            self._run_stmt(stmt, self.env)

    def _run_stmt(self, stmt: ast.stmt, env: dict) -> None:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            try:
                env[stmt.targets[0].id] = self.eval(stmt.value)
            except _Unevaluable:
                pass
        elif isinstance(stmt, ast.Assign) \
                and isinstance(stmt.targets[0], ast.Tuple) \
                and isinstance(stmt.value, ast.Tuple) \
                and len(stmt.targets[0].elts) == len(stmt.value.elts):
            # ST_FREE, ST_USED, ST_DEAD = 0, 1, 2
            for t, v in zip(stmt.targets[0].elts, stmt.value.elts):
                if isinstance(t, ast.Name):
                    try:
                        env[t.id] = self.eval(v)
                    except _Unevaluable:
                        pass
        elif isinstance(stmt, ast.ClassDef):
            cls_env: dict[str, object] = {}
            for s in stmt.body:
                self._run_stmt(s, cls_env)
            env[stmt.name] = {"__class__": stmt.name, **cls_env}

    def eval(self, node: ast.AST):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            raise _Unevaluable(node.id)
        if isinstance(node, ast.Tuple):
            return tuple(self.eval(e) for e in node.elts)
        if isinstance(node, ast.List):
            return [self.eval(e) for e in node.elts]
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.Invert):
                return ~v
            raise _Unevaluable
        if isinstance(node, ast.BinOp):
            a, b = self.eval(node.left), self.eval(node.right)
            op = type(node.op)
            table = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                     ast.Mult: lambda: a * b, ast.FloorDiv: lambda: a // b,
                     ast.Mod: lambda: a % b, ast.LShift: lambda: a << b,
                     ast.RShift: lambda: a >> b, ast.BitOr: lambda: a | b,
                     ast.BitAnd: lambda: a & b, ast.BitXor: lambda: a ^ b,
                     ast.Pow: lambda: a ** b}
            if op in table:
                return table[op]()
            raise _Unevaluable
        if isinstance(node, ast.Attribute):
            v = self.eval(node.value)
            if node.attr == "itemsize" and isinstance(v, np.dtype):
                return int(v.itemsize)
            if node.attr == "size" and isinstance(v, struct.Struct):
                return int(v.size)
            raise _Unevaluable(node.attr)
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            if fname in ("np.dtype", "numpy.dtype"):
                return np.dtype(self.eval(node.args[0]))
            if fname == "struct.Struct":
                return struct.Struct(self.eval(node.args[0]))
            if fname == "struct.calcsize":
                return struct.calcsize(self.eval(node.args[0]))
            raise _Unevaluable(fname)
        raise _Unevaluable(type(node).__name__)


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _canon(v) -> object:
    """Canonical JSON-able form of an extracted layout value."""
    if isinstance(v, np.dtype):
        return {"__dtype__": True, "itemsize": int(v.itemsize),
                "fields": [
                    [name, str(v.fields[name][0].base),
                     list(v.fields[name][0].shape),
                     int(v.fields[name][1])]            # byte offset
                    for name in v.names]}
    if isinstance(v, struct.Struct):
        return {"__struct__": v.format if isinstance(v.format, str)
                else v.format.decode(), "size": int(v.size)}
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return repr(v)


def _find_file(suffix: str, roots: list[str]) -> str | None:
    for root in roots:
        cand = os.path.join(root, suffix.replace("/", os.sep))
        if os.path.isfile(cand):
            return cand
    return None


def extract_layout(src_roots: list[str] | None = None,
                   overrides: dict[str, str] | None = None) -> dict:
    """``{section: {"version": int|None, "consts": {...}, "env": _Eval}}``.

    ``overrides`` maps a section name to an alternate file path — the
    drift test points one section at a mutated scratch copy.
    """
    if src_roots is None:
        src_roots = [os.path.join(_HERE, os.pardir, os.pardir)]
    out: dict[str, dict] = {}
    for sec, spec in SECTIONS.items():
        path = (overrides or {}).get(sec) or _find_file(spec["file"], src_roots)
        if path is None:
            out[sec] = {"version": None, "consts": {}, "error":
                        f"source file {spec['file']} not found"}
            continue
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        ev = _Eval()
        ev.run_module(tree)
        consts = {}
        missing = []
        for name in spec["consts"]:
            if name in ev.env:
                consts[name] = _canon(ev.env[name])
            else:
                missing.append(name)
        out[sec] = {"version": ev.env.get(spec["version"]),
                    "consts": consts, "missing": missing, "path": path,
                    "env": ev.env}
    return out


def _fingerprint(consts: dict) -> str:
    blob = json.dumps(consts, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def compute_lock(src_roots: list[str] | None = None) -> dict:
    ext = extract_layout(src_roots)
    return {sec: {"version": d["version"],
                  "fingerprint": _fingerprint(d["consts"])}
            for sec, d in ext.items()}


def _func_source_tokens(path: str, func: str) -> list[str] | None:
    """Normalized token stream of one function's body (AST dump minus
    location info) — used to pin deliberate cross-module duplicates."""
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func:
            return [ast.dump(s) for s in node.body
                    if not isinstance(s, ast.Expr)  # skip docstrings
                    or not isinstance(s.value, ast.Constant)]
    return None


def check_layout(src_roots: list[str] | None = None,
                 lock_path: str | None = None,
                 overrides: dict[str, str] | None = None) -> list[Finding]:
    """Run the drift check plus all internal-consistency cross-checks.
    Returns findings (empty = clean)."""
    findings: list[Finding] = []
    ext = extract_layout(src_roots, overrides)

    def bad(rule: str, sec: str, msg: str) -> None:
        d = ext.get(sec, {})
        findings.append(Finding(rule, d.get("path") or sec, 0, msg))

    # -- extraction sanity ----------------------------------------------------
    for sec, d in ext.items():
        if d.get("error"):
            bad("AGNO-LAYOUT-002", sec, d["error"])
            continue
        if d.get("missing"):
            bad("AGNO-LAYOUT-002", sec,
                f"layout constants not statically extractable: {d['missing']}"
                " (the verifier must keep up with the source)")
        if d.get("version") is None:
            bad("AGNO-LAYOUT-002", sec,
                f"version constant {SECTIONS[sec]['version']} missing or "
                "not a literal")

    # -- drift vs the checked-in lock ----------------------------------------
    lock_path = lock_path or LOCK_PATH
    if not os.path.isfile(lock_path):
        findings.append(Finding("AGNO-LAYOUT-001", lock_path, 0,
                                "layout lock missing: run "
                                "scripts/agnolint_torch.py --update-layout-lock"))
    else:
        with open(lock_path, "r", encoding="utf-8") as fh:
            lock = json.load(fh)
        for sec, d in ext.items():
            cur_fp = _fingerprint(d["consts"])
            rec = lock.get(sec)
            if rec is None:
                bad("AGNO-LAYOUT-001", sec,
                    f"section {sec!r} absent from layout lock: regenerate "
                    "with --update-layout-lock")
            elif d["version"] == rec.get("version") \
                    and cur_fp != rec.get("fingerprint"):
                bad("AGNO-LAYOUT-001", sec,
                    f"layout constants of section {sec!r} changed but the "
                    f"version constant ({SECTIONS[sec]['version']}) did not "
                    "— bump it (cf. the v5->v6 magic bump) and regenerate "
                    "the lock")
            elif d["version"] != rec.get("version"):
                if cur_fp == rec.get("fingerprint"):
                    bad("AGNO-LAYOUT-001", sec,
                        f"version constant of section {sec!r} bumped with "
                        "no layout change — revert or regenerate the lock")
                else:
                    bad("AGNO-LAYOUT-001", sec,
                        f"section {sec!r} layout changed with a version "
                        "bump: regenerate the lock (--update-layout-lock) "
                        "so the new baseline is reviewed")

    # -- cross-checks ---------------------------------------------------------
    reg = ext.get("registry", {}).get("env", {})
    if reg:
        def dt(name) -> np.dtype | None:
            v = reg.get(name)
            return v if isinstance(v, np.dtype) else None

        topic, entry, journal = dt("TOPIC_DT"), dt("ENTRY_DT"), dt("JOURNAL_DT")
        max_subs, max_topics = reg.get("MAX_SUBS"), reg.get("MAX_TOPICS")
        hash_cap = reg.get("HASH_CAP")
        if isinstance(max_subs, int) and max_subs > 64:
            bad("AGNO-LAYOUT-002", "registry",
                f"MAX_SUBS={max_subs} > 64: sub bitmasks are u64")
        if isinstance(hash_cap, int):
            if hash_cap & (hash_cap - 1):
                bad("AGNO-LAYOUT-002", "registry",
                    f"HASH_CAP={hash_cap} not a power of two (open "
                    "addressing wraps with % HASH_CAP)")
            if isinstance(max_topics, int) and hash_cap < 2 * max_topics:
                bad("AGNO-LAYOUT-002", "registry",
                    f"HASH_CAP={hash_cap} < 2*MAX_TOPICS={2 * max_topics}: "
                    "load factor > 0.5 degenerates the advisory probe")
        if entry is not None and isinstance(max_subs, int):
            shape = entry.fields["released"][0].shape \
                if "released" in (entry.names or ()) else None
            if shape != (max_subs,):
                bad("AGNO-LAYOUT-002", "registry",
                    f"ENTRY_DT['released'] shape {shape} != (MAX_SUBS,)="
                    f"({max_subs},): one lock-free byte per subscriber")
        if topic is not None and isinstance(max_subs, int):
            for f in ("sub_pids", "sub_lease_ns"):
                shape = topic.fields[f][0].shape if f in topic.names else None
                if shape != (max_subs,):
                    bad("AGNO-LAYOUT-002", "registry",
                        f"TOPIC_DT[{f!r}] shape {shape} != (MAX_SUBS,)")
        if journal is not None:
            for img, row in (("topic_img", topic), ("entry_img", entry)):
                if row is None or img not in (journal.names or ()):
                    continue
                have = journal.fields[img][0].itemsize
                if have != row.itemsize:
                    bad("AGNO-LAYOUT-002", "registry",
                        f"JOURNAL_DT[{img!r}] is {have} bytes but the row "
                        f"dtype is {row.itemsize}: before-images would "
                        "truncate")

    tr = ext.get("trace", {}).get("env", {})
    if tr:
        rec, hdr = tr.get("_REC"), tr.get("_HDR")
        if isinstance(rec, struct.Struct):
            if rec.size != 24:
                bad("AGNO-LAYOUT-002", "trace",
                    f"trace record is {rec.size} bytes, documented as 24")
            if tr.get("REC_SIZE") not in (None, rec.size):
                bad("AGNO-LAYOUT-002", "trace",
                    f"REC_SIZE={tr.get('REC_SIZE')} != _REC.size={rec.size}")
        if isinstance(hdr, struct.Struct) and isinstance(tr.get("_HDR_SIZE"),
                                                         int):
            if hdr.size > tr["_HDR_SIZE"]:
                bad("AGNO-LAYOUT-002", "trace",
                    f"_HDR.size={hdr.size} > _HDR_SIZE={tr['_HDR_SIZE']}: "
                    "records would overlap the header")

    tp = ext.get("transport", {}).get("env", {})
    if tp:
        kinds = {k: tp.get(k) for k in
                 ("K_PUB", "K_SUB", "K_CTRL", "K_ACK", "K_FANOUT")}
        vals = [v for v in kinds.values() if isinstance(v, int)]
        if len(set(vals)) != len(vals):
            bad("AGNO-LAYOUT-002", "transport",
                f"frame kinds collide: {kinds}")

    magics = {sec: d.get("version") for sec, d in ext.items()
              if isinstance(d.get("version"), int) and d["version"] > 0xFFFF}
    if len(set(magics.values())) != len(magics):
        findings.append(Finding("AGNO-LAYOUT-002", "(cross)", 0,
                                f"shm segment magics collide: {magics} — "
                                "attach would mistake one segment kind for "
                                "another"))

    # registry.py's module docstring documents the trace record wire
    # format next to the shm layout docs; the prose must not drift from
    # trace.py's actual structs
    rpath = ext.get("registry", {}).get("path")
    if rpath and tr:
        import re as _re
        with open(rpath, "r", encoding="utf-8") as fh:
            doc = ast.get_docstring(ast.parse(fh.read())) or ""
        rec = tr.get("_REC")
        m = _re.search(r"``'(<[A-Za-z]+)'``", doc)
        if m and isinstance(rec, struct.Struct) and m.group(1) != rec.format:
            bad("AGNO-LAYOUT-002", "registry",
                f"registry docstring quotes trace record format "
                f"{m.group(1)!r} but trace._REC is {rec.format!r}")
        m = _re.search(r"records (\d+) bytes", doc)
        if m and isinstance(rec, struct.Struct) and int(m.group(1)) != rec.size:
            bad("AGNO-LAYOUT-002", "registry",
                f"registry docstring says trace records are {m.group(1)} "
                f"bytes but _REC.size is {rec.size}")
        m = _re.search(r"pad`` \((\d+) bytes", doc)
        if m and isinstance(tr.get("_HDR_SIZE"), int) \
                and int(m.group(1)) != tr["_HDR_SIZE"]:
            bad("AGNO-LAYOUT-002", "registry",
                f"registry docstring says the trace header is {m.group(1)} "
                f"bytes but _HDR_SIZE is {tr['_HDR_SIZE']}")

    # the metrics module deliberately duplicates trace._domain_hash to
    # avoid an import cycle; the two must stay token-identical or the
    # export/trace segment names for one domain diverge silently
    tpath = ext.get("trace", {}).get("path")
    mpath = ext.get("metrics", {}).get("path")
    if tpath and mpath:
        a = _func_source_tokens(tpath, "_domain_hash")
        b = _func_source_tokens(mpath, "_domain_hash")
        if a is None or b is None:
            findings.append(Finding("AGNO-LAYOUT-002", mpath or "(cross)", 0,
                                    "_domain_hash missing from trace.py or "
                                    "metrics.py (the deliberate duplicate "
                                    "must exist in both)"))
        elif a != b:
            findings.append(Finding("AGNO-LAYOUT-002", mpath, 0,
                                    "metrics._domain_hash diverged from "
                                    "trace._domain_hash: ring and export "
                                    "names for one domain would no longer "
                                    "agree"))
    return findings


def write_lock(src_roots: list[str] | None = None,
               lock_path: str | None = None) -> str:
    lock = compute_lock(src_roots)
    path = lock_path or LOCK_PATH
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(lock, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path
