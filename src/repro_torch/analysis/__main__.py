"""Machine-checked concurrency contracts over the port's threaded stack.

Runs the DESIGN.md §12 static analyzer (guarded-by / swap-publish /
no-blocking-under-lock / unannotated-shared-state), with CUDA's dispatch and
blocking tables, over ``src/repro_torch`` and exits non-zero on any
violation.

    python -m repro_torch.analysis              # check the tree
    python -m repro_torch.analysis --self-test  # prove each contract class
                                                # and each CUDA case still
                                                # detects a seeded violation
    python -m repro_torch.analysis --explain    # code legend
"""
import argparse
import os
import sys

from repro_torch.analysis.contracts import CODES
from repro_torch.analysis.static_check import check_path, check_source

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One deliberately-broken snippet per contract class. The self-test seeds
# each through the analyzer and fails if the expected code is NOT reported —
# the analyzer itself is under test, so a refactor that quietly blinds a
# pass cannot land green.
_SEEDED = {
    "GB01": """
import threading

class Meter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0  # guarded-by: _lock

    def add(self, n):
        self.total += n  # store outside the lock
""",
    "SP01": """
import threading

class Table:
    def __init__(self):
        self._lock = threading.Lock()
        # swap-published
        self.state = {"v": 0}

    def bump(self):
        self.state["v"] = 1  # in-place element write, not a rebind
""",
    "BL01": """
import threading
import time

class Worker:
    def __init__(self):
        self._lock = threading.Lock()

    def step(self):
        with self._lock:
            time.sleep(0.1)
""",
    "SH01": """
import threading

class Runner:
    def __init__(self):
        self.count = 0

    def start(self):
        t = threading.Thread(target=self.body)
        t.start()

    def body(self):
        self.count += 1

    def read(self):
        self.count += 1
        return self.count
""",
    "CT01": """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.v = 0  # hogwild-race: maybe
""",
}

# The CUDA cases: name -> (snippet, the code it must report, or None for a
# snippet that must stay clean).
_SEEDED_CUDA = {
    "kernel-under-lock": ("""
import threading

from repro_torch.kernels.embedding_bag.ops import embedding_bag_op

class Lookup:
    def __init__(self):
        self._lock = threading.Lock()

    def step(self, table, idx):
        with self._lock:
            return embedding_bag_op(table, idx)
""", "BL01"),
    "synchronize-under-lock": ("""
import threading

import torch

class Publisher:
    def __init__(self):
        self._lock = threading.Lock()

    def publish(self):
        with self._lock:
            torch.cuda.synchronize()
""", "BL01"),
    "current-stream-under-lock": ("""
import threading

import torch

class Readers:
    def __init__(self):
        self._lock = threading.Lock()
        self.last = {}  # guarded-by: _lock

    def done(self, ev):
        with self._lock:
            self.last[torch.cuda.current_stream().cuda_stream] = ev
""", None),
}


def self_test() -> int:
    failed = []
    for code, src in sorted(_SEEDED.items()):
        got = {v.code for v in check_source(src, f"<seeded-{code}>")}
        status = "detected" if code in got else "MISSED"
        print(f"  {code}: seeded violation {status} (reported: {sorted(got)})")
        if code not in got:
            failed.append(code)
    for name, (src, want) in sorted(_SEEDED_CUDA.items()):
        got = {v.code for v in check_source(src, f"<seeded-{name}>")}
        ok = (want in got) if want is not None else not got
        expect = f"reports {want}" if want is not None else "stays clean"
        print(f"  {name}: {expect}: {'yes' if ok else 'NO'} (reported: {sorted(got)})")
        if not ok:
            failed.append(name)
    if failed:
        print(f"self-test FAILED: {failed}")
        return 1
    print(f"self-test passed: all {len(_SEEDED)} contract classes detect, and the "
          f"{len(_SEEDED_CUDA)} CUDA cases hold")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=[_PACKAGE],
                    help="files or directories to check (default: src/repro_torch)")
    ap.add_argument("--self-test", action="store_true",
                    help="seed one violation per contract class and the CUDA cases, and "
                         "verify the analyzer reports each")
    ap.add_argument("--explain", action="store_true",
                    help="print the violation-code legend and exit")
    args = ap.parse_args(argv)
    if args.explain:
        for code, what in sorted(CODES.items()):
            print(f"  {code}  {what}")
        return 0
    if args.self_test:
        return self_test()
    violations = []
    for path in args.paths:
        violations.extend(check_path(path))
    for v in violations:
        print(v.render())
    if violations:
        print(f"{len(violations)} concurrency-contract violation(s)")
        return 1
    print("concurrency contracts: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
