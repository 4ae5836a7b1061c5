"""repro_torch.analysis — agnolint over the port: concurrency-protocol
static analysis, a copy of ``repro.analysis`` aimed at ``src/repro_torch``.

Three cooperating checkers, run together by ``scripts/agnolint_torch.py``:

* :mod:`repro_torch.analysis.lint` — AST passes over ``src/repro_torch``
  enforcing the registry's lock discipline (AGNO-LOCK-*), hot-path purity
  (AGNO-HOT-*) and metrics-counter hygiene (AGNO-CNT-*).
* :mod:`repro_torch.analysis.layout` — extracts every hand-maintained shm /
  wire layout constant of the port and fails on drift without a version
  bump (AGNO-LAYOUT-*); its lock equals the reference's.
* :mod:`repro_torch.analysis.model` — a bounded interleaving checker for
  the publish/take/release/rollback/sweep protocol with SIGKILL injection
  (AGNO-MODEL-*), whose fold is the port's: a read step and a zero step
  that zeroes only the bytes it read.

The rule IDs are documented in ``scripts/agnolint_torch.py --list-rules``
and cross-referenced from the "Invariants" section of
``repro_torch/core/registry.py``'s module docstring.
"""

from .lint import Finding, lint_paths, lint_source  # noqa: F401
from .layout import check_layout  # noqa: F401

__all__ = ["Finding", "lint_paths", "lint_source", "check_layout"]
