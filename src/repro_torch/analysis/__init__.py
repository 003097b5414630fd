"""Machine-checked concurrency contracts for the port's threaded stack, the
twin of ``repro/analysis/`` (DESIGN.md §12), standard library only except
where ``lockdep.instrument`` patches ``torch.cuda`` and the kernel backend.

- ``contracts``    — the annotation grammar (``# guarded-by: <lock>`` et
  al.), the per-class shared-state registry, the waiver ledger, and the
  CUDA dispatch and blocking tables the checkers consult.
- ``static_check`` — an AST pass over ``src/repro_torch`` enforcing
  guarded-by, swap-publish, and no-blocking-under-lock, where device work
  is any ``torch.`` call, a kernel wrapper or a device path, and blocking
  includes ``synchronize()`` and subprocess waits.
- ``lockdep``      — a test-time instrumented ``threading.Lock`` /
  ``RLock`` / ``Condition`` that records the acquisition graph (the kernel
  backend's launch locks included), fails on lock-order cycles, and
  catches held-lock blocking calls (CUDA host waits included) the static
  pass can't see.

Run the static pass with ``python -m repro_torch.analysis``.
"""

from repro_torch.analysis.contracts import (
    Directive,
    Violation,
    parse_directives,
)
from repro_torch.analysis.static_check import check_path, check_source

__all__ = [
    "Directive",
    "Violation",
    "parse_directives",
    "check_path",
    "check_source",
]
