#!/usr/bin/env python
"""agnolint over the port — concurrency-protocol static analyzer for the
shm registry of ``src/repro_torch``, the counterpart of ``scripts/agnolint.py``
(which reads ``src/repro`` and its lock).

The registry's crash-consistency story rests on invariants no unit test
can see from the outside: which shm stores need the topic lock, the
domain->topic lock order, what may run between a seqlock's odd and even
counter bumps, and which byte-granular stores are *licensed* to skip
the lock (the documented single-writer columns).  agnolint checks them
as code properties, in three passes:

1. **AST lint** (``repro_torch.analysis.lint``) — lock discipline over shm
   stores (AGNO-LOCK-001), lock acquisition order (AGNO-LOCK-002),
   blocking calls under a held lock (AGNO-LOCK-003), hot-path purity
   (AGNO-HOT-001..003), and bare cross-thread counters (AGNO-CNT-001).
   Suppressions are inline directives that must carry a justification::

       e["released"][sidx] = 1  # agnolint: allow[AGNO-LOCK-001] -- why...
       # agnolint: locked-context -- caller holds the topic lock
       # agnolint: single-writer -- one producer by construction

2. **Layout verifier** (``repro_torch.analysis.layout``) — extracts every shm
   dtype/struct constant statically, fingerprints the canonical layout,
   and fails when the layout changed without bumping the section's
   version constant (AGNO-LAYOUT-001; the v5->v6 ``_MAGIC`` bump rule),
   plus cross-file consistency checks (AGNO-LAYOUT-002: docstring
   numbers vs code, duplicated helpers staying identical, struct sizes).
   The port's lock, ``src/repro_torch/analysis/layout_lock.json``, equals
   the reference's: the two packages share their shm and wire layouts.

3. **Bounded interleaving checker** (``repro_torch.analysis.model``) —
   an executable model of publish/take/release/rollback/sweep explored
   exhaustively with SIGKILL injected at every step, asserting the
   registry docstring's convergence invariants (no lost release, no
   double-take, no lost wakeup, seqlock parity restored, rollback
   idempotent).  Its fold is the port's: a read step and a zero step that
   zeroes only the bytes it read.

Usage:

    scripts/agnolint_torch.py --strict                     # CI gate
    scripts/agnolint_torch.py --strict --model fast        # + model check
    scripts/agnolint_torch.py --list-rules                 # rule catalogue
    scripts/agnolint_torch.py --update-layout-lock         # after a
        deliberate layout change WITH its version/_MAGIC bump (writes
        only the port's lock)
    scripts/agnolint_torch.py --json report.json           # CI artifact

Exit status: 0 clean, 1 findings (or model violation), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.analysis import layout, lint  # noqa: E402


def _list_rules() -> None:
    from repro_torch.analysis.lint import RULES
    rules = dict(RULES)
    rules.update({
        "AGNO-LAYOUT-001": "shm layout changed without a version/_MAGIC "
                           "bump (or lock file missing/stale)",
        "AGNO-LAYOUT-002": "cross-file layout consistency (docstring "
                           "numbers, duplicated helpers, struct sizes)",
        "AGNO-MODEL": "interleaving-checker invariants: no lost release, "
                      "no double-take, no lost wakeup, parity restored, "
                      "rollback idempotent",
    })
    w = max(len(k) for k in rules)
    for key in sorted(rules):
        print(f"  {key:<{w}}  {rules[key]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="agnolint_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="any finding is fatal (exit 1); without it, "
                    "findings print but only layout drift is fatal")
    ap.add_argument("--model", choices=("off", "fast", "full"),
                    default="off",
                    help="also run the bounded interleaving checker "
                    "(fast: 2-proc exhaustive + wakeup race + the fold's "
                    "race with a lock-free release, a few seconds)")
    ap.add_argument("--json", metavar="FILE",
                    help="write a machine-readable report (CI artifact)")
    ap.add_argument("--update-layout-lock", action="store_true",
                    help="regenerate src/repro_torch/analysis/layout_lock.json "
                    "from the port's tree (use together with the version "
                    "bump that justified the change)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0

    src_roots = [os.path.join(_ROOT, "src")]
    if args.update_layout_lock:
        path = layout.write_lock(src_roots)
        print(f"agnolint_torch: layout lock regenerated: "
              f"{os.path.relpath(path, _ROOT)}")
        return 0

    paths = args.paths or [os.path.join(_ROOT, "src", "repro_torch")]
    t0 = time.monotonic()
    rep = lint.lint_paths(paths, root=_ROOT)
    active, suppressed = rep.findings, rep.suppressions
    layout_findings = layout.check_layout(src_roots)

    report = {
        "paths": [os.path.relpath(p, _ROOT) if os.path.isabs(p) else p
                  for p in paths],
        "lint": rep.to_dict(),
        "layout": [f.to_dict() for f in layout_findings],
        "model": None,
    }

    for f in active + layout_findings:
        print(str(f))

    model_failed = False
    if args.model != "off":
        from repro_torch.analysis import model
        try:
            stats = model.run_profile(args.model)
            report["model"] = {"ok": True, "profile": args.model,
                              "results": stats}
            for r in stats:
                print(f"agnolint_torch: model[{r['scenario']}]: {r['states']} "
                      f"states, {r['terminals']} terminals -- OK")
        except model.Violation as v:
            model_failed = True
            report["model"] = {"ok": False, "profile": args.model,
                              "kind": v.kind, "detail": v.detail,
                              "schedule": v.schedule()}
            print(f"agnolint_torch: model VIOLATION [{v.kind}] {v.detail}")
            print(f"agnolint_torch: schedule: {v.schedule()}")

    dt = time.monotonic() - t0
    print(f"agnolint_torch: {len(active)} finding(s), {len(suppressed)} "
          f"justified suppression(s), {len(layout_findings)} layout "
          f"issue(s) in {dt:.1f}s")

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"agnolint_torch: report written to {args.json}")

    if layout_findings or model_failed:
        return 1
    if args.strict and active:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
