"""The port's static concurrency checker (``repro_torch.analysis``), held
against the JAX package's on the same sources, and the port's tree clean
under it.

Every source snippet that ``tests/test_analysis.py`` hands to the JAX
checker, and every seeded violation of ``scripts/check_concurrency.py``,
goes through both checkers: the port must report the same (code, line,
message) list. The snippets are collected by running the reference's tests
with ``check_source`` / ``parse_directives`` spied on (the files are read
as data; neither is edited). Then the CUDA cases (a kernel wrapper or
``torch.cuda.synchronize()`` under a lock is BL01, ``current_stream()`` is
not), and the port's tree: no violation, every waiver and every port-only
field's contract has its reason in the ledger, and every field the JAX
tree annotates carries the same directive in the port, unless
``REFERENCE_DEVIATIONS`` says why not.
"""
import ast
import importlib.util
import inspect
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.analysis import contracts as jcontracts  # noqa: E402
from repro.analysis import static_check as jstatic  # noqa: E402
from repro_torch.analysis import contracts, static_check  # noqa: E402
from repro_torch.analysis.__main__ import _SEEDED, _SEEDED_CUDA  # noqa: E402
from repro_torch.analysis.contracts import (  # noqa: E402
    CODES,
    KERNEL_CALLS,
    REFERENCE_DEVIATIONS,
    SHARED_CLASSES,
    TORCH_ALLOWED,
    WAIVER_JUSTIFICATIONS,
    parse_directives,
)
from repro_torch.analysis.static_check import check_path, check_source  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TREE = os.path.join(_REPO, "src", "repro_torch")
_REF_TREE = os.path.join(_REPO, "src", "repro")


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_calls():
    """(test id, source, path) of every ``check_source`` call and (test id,
    source) of every ``parse_directives`` call that tests/test_analysis.py
    makes, in order; its tree-level tests (``TestTreeIsClean``) are left
    out, they check the JAX tree."""
    mod = _load("tests/test_analysis.py", "_reference_test_analysis")
    checks, parses, current = [], [], [""]
    real_check, real_parse = mod.check_source, mod.parse_directives

    def spy_check(source, path="<string>", registered=None):
        checks.append((current[0], source, path))
        return real_check(source, path, registered)

    def spy_parse(source, path="<string>"):
        parses.append((current[0], source))
        return real_parse(source, path)

    mod.check_source, mod.parse_directives = spy_check, spy_parse
    for cname, cls in vars(mod).items():
        if not (isinstance(cls, type) and cname.startswith("Test")) or cname == "TestTreeIsClean":
            continue
        for mname, fn in vars(cls).items():
            if mname.startswith("test_") and len(inspect.signature(fn).parameters) == 1:
                current[0] = f"{cname}.{mname}"
                fn(cls())
    return checks, parses


def _numbered(calls):
    """Test ids made unique: a test that checks several sources gets -0, -1..."""
    seen = {}
    out = []
    for call in calls:
        k = seen[call[0]] = seen.get(call[0], -1) + 1
        out.append((f"{call[0]}-{k}", *call[1:]))
    return out


_CHECKS, _PARSES = (_numbered(c) for c in _reference_calls())
_REF_SEEDED = _load("scripts/check_concurrency.py", "_reference_check_concurrency")._SEEDED


def _rows(violations):
    return [(v.code, v.line, v.message) for v in violations]


# ---------------------------------------------------------------------------
# The same violations as the JAX checker on the reference's corpus
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tid, source, path", _CHECKS, ids=[c[0] for c in _CHECKS])
def test_reference_snippet_gives_the_same_violations(tid, source, path):
    want = _rows(jstatic.check_source(source, path))
    assert _rows(check_source(source, path)) == want


@pytest.mark.parametrize("tid, source", _PARSES, ids=[c[0] for c in _PARSES])
def test_reference_directives_parse_alike(tid, source):
    def fields(ds):
        return [(d.kind, d.arg, d.line, d.trailing, d.reason) for d in ds]

    assert fields(parse_directives(source)) == fields(jcontracts.parse_directives(source))


@pytest.mark.parametrize("code", sorted(_REF_SEEDED))
def test_seeded_violation_gives_the_same_violations(code):
    src = _REF_SEEDED[code]
    got = _rows(check_source(src, f"<{code}>"))
    assert got == _rows(jstatic.check_source(src, f"<{code}>"))
    assert code in {c for c, _, _ in got}


def test_the_corpus_is_the_reference_corpus():
    assert len(_CHECKS) >= 25 and len(_PARSES) >= 8
    assert _SEEDED == _REF_SEEDED  # the port keeps its own copy, unchanged


def test_the_grammar_and_codes_are_the_reference_s():
    assert CODES == jcontracts.CODES and contracts.KINDS == jcontracts.KINDS
    assert set(SHARED_CLASSES) == set(jcontracts.SHARED_CLASSES)


# ---------------------------------------------------------------------------
# CUDA: dispatch and host waits under a lock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(_SEEDED_CUDA))
def test_seeded_cuda_case(name):
    src, want = _SEEDED_CUDA[name]
    got = {v.code for v in check_source(src, f"<{name}>")}
    assert got == ({want} if want else set()), got


_UNDER_LOCK = """
import subprocess
import threading

import torch

from repro_torch.core import streams

_MODULE_LOCK = threading.Lock()

class Worker:
    def __init__(self):
        self._lock = threading.Lock()

    def step(self, t, ev, p, stream):
        with self._lock:
            {stmt}

def module_step(t):
    with _MODULE_LOCK:
        {stmt}
"""


@pytest.mark.parametrize("stmt, blocks", [
    ("x = torch.zeros(4, device='cuda')", True),  # any torch. call is device work
    ("x = t.index_select(0, t)", False),  # a tensor method is not in the table
    ("stream.synchronize()", True),
    ("ev.synchronize()", True),
    ("out, _ = p.communicate()", True),
    ("subprocess.run(['nvcc'])", True),
    ("x = t.item()", True),
    ("x = t.tolist()", True),
    ("x = t.cpu()", True),
    ("x = t.numpy()", True),
    ("x = float(t)", False),  # not reported (contracts.HOST_READBACKS)
    ("streams.wait(ev)", False),  # the stream waits, not the host
    ("ev.wait()", True),
    ("x = torch.cuda.current_stream().cuda_stream", False),
    ("x = torch.from_numpy(t)", False),
    ("x = self_store.prefetch([1])", True),
    ("x = replica_mean_rows_op(t, t)", True),
])
def test_cuda_dispatch_and_blocking_table(stmt, blocks):
    src = _UNDER_LOCK.replace("{stmt}", stmt)
    got = [v for v in check_source(src, "<t>") if v.code == "BL01"]
    # once in the method (a class lock), once in the function (a module lock)
    assert len(got) == (2 if blocks else 0), [v.render() for v in got]


def test_torch_allow_list_gives_reasons():
    assert {"torch.cuda.current_stream", "torch.cuda.is_available", "torch.device"} <= set(
        TORCH_ALLOWED)
    for name, why in {**TORCH_ALLOWED, **contracts.WAIT_ALLOWED,
                      **contracts.HOST_READBACKS}.items():
        assert why.strip(), name


def test_every_kernel_wrapper_is_dispatch():
    """Every public function of kernels/*/ops.py is in KERNEL_CALLS."""
    kdir = os.path.join(_TREE, "kernels")
    wrappers = set()
    for name in sorted(os.listdir(kdir)):
        ops = os.path.join(kdir, name, "ops.py")
        if os.path.exists(ops):
            with open(ops) as f:
                tree = ast.parse(f.read())
            wrappers |= {n.name for n in tree.body
                         if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}
    assert len(wrappers) >= 15 and wrappers <= KERNEL_CALLS, wrappers - KERNEL_CALLS


# The spots of the tree the CUDA-aware pass must see: each waiver or fix
# removed from the real source brings its BL01 back.
@pytest.mark.parametrize("rel, old, new", [
    ("core/runners.py", "# holds-lock: _state_lock; lock-blocking: ok — admission must be atomic",
     "# holds-lock: _state_lock"),
    ("kernels/backend.py", "# holds-lock: _BUILD_LOCK; lock-blocking: ok — the build is what",
     "# holds-lock: _BUILD_LOCK; the build is what"),
    ("core/runners.py", "                        store.prefetch(horizons[s])\n",
     "                        with prefetch_lock:\n"
     "                            store.prefetch(horizons[s])\n"),
    ("kernels/backend.py", "    new = torch.tensor(key[1], dtype=torch.int32).to(device)\n",
     "    with _INDEX_LOCK:\n        new = torch.tensor(key[1], dtype=torch.int32).to(device)\n"),
], ids=["bootstrap_join", "nvcc", "prefetch", "index_tensor"])
def test_the_pass_sees_the_tree_s_spots(rel, old, new):
    path = os.path.join(_TREE, *rel.split("/"))
    with open(path) as f:
        src = f.read()
    assert src.count(old) == 1
    assert not check_source(src, path)
    assert "BL01" in {v.code for v in check_source(src.replace(old, new), path)}


def test_readmit_reason_lock_free_read_needs_its_contract():
    """The trainer's lock-free check of its own re-admission slot is GB01
    under ``guarded-by``; the tree declares ``guarded-by-writes``."""
    path = os.path.join(_TREE, "core", "runners.py")
    with open(path) as f:
        src = f.read()
    old = "        # guarded-by-writes: _state_lock — a trainer checks its own slot\n"
    assert src.count(old) == 1
    bad = src.replace(old, "        # guarded-by: _state_lock — a trainer checks its own slot\n")
    got = [v for v in check_source(bad, path) if v.code == "GB01"]
    assert len(got) == 1 and "_readmit_reason" in got[0].message


# ---------------------------------------------------------------------------
# The port's tree and its ledgers
# ---------------------------------------------------------------------------
def _py_files(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "analysis")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _analyses(pkg_static, pkg_contracts, root):
    """{module stem: analysis with scopes built and directives bound}."""
    out = {}
    for path in _py_files(root):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        fa = pkg_static._FileAnalysis(src, path, pkg_contracts.SHARED_CLASSES)
        fa.build()
        fa.bind_directives()
        if any(c.contracts for c in fa.classes.values()) or any(
                sc.var_contracts for sc in fa.scopes):
            stem = os.path.basename(path)[:-3]
            assert stem not in out, f"two files named {stem} carry contracts"
        out.setdefault(os.path.basename(path)[:-3], fa)
    return out


def _field_contracts(analyses):
    """{"<module>.<Class>.<field>" or "<module>.<scope>.<var>": FieldContract}."""
    out = {}
    for mod, fa in analyses.items():
        for cname, ci in fa.classes.items():
            for name, fc in ci.contracts.items():
                out[f"{mod}.{cname}.{name}"] = fc
        for sc in fa.scopes:
            for name, fc in sc.var_contracts.items():
                out[f"{mod}.{sc.qual}.{name}"] = fc
    return out


def _fields(analyses):
    """Every attribute a class binds on self, and every local of a scope."""
    out = set()
    for mod, fa in analyses.items():
        for node in ast.walk(fa.tree):
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store)
                            and isinstance(sub.value, ast.Name) and sub.value.id == "self"):
                        out.add(f"{mod}.{node.name}.{sub.attr}")
        for sc in fa.scopes:
            out |= {f"{mod}.{sc.qual}.{name}" for name in sc.local_names}
    return out


def _waived_scopes(analyses):
    return {f"{mod}.{sc.qual}" for mod, fa in analyses.items() for sc in fa.scopes
            if sc.block_waived}


_PORT = _analyses(static_check, contracts, _TREE)
_REF = _analyses(jstatic, jcontracts, _REF_TREE)


def _shape(key, fc):
    locks = contracts.LOCK_COUNTERPARTS.get(key.rsplit(".", 1)[0], {})
    return (locks.get(fc.guarded_by, fc.guarded_by),
            locks.get(fc.guarded_writes, fc.guarded_writes),
            fc.swap_published, fc.swap_elements, fc.hogwild_ok)


def _port_shape(fc):
    return (fc.guarded_by, fc.guarded_writes, fc.swap_published, fc.swap_elements,
            fc.hogwild_ok)


class TestTreeIsClean:
    def test_src_repro_torch_has_no_violations(self):
        violations = check_path(_TREE)
        assert violations == [], "\n".join(v.render() for v in violations)

    def test_cli_checks_the_tree_and_self_tests(self):
        env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
        for args, said in (([], "concurrency contracts: clean"), (["--self-test"],
                                                                  "self-test passed")):
            out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                                 capture_output=True, text=True, timeout=120, env=env)
            assert out.returncode == 0 and said in out.stdout, out.stdout + out.stderr

    def test_cli_fails_on_a_violation(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text(_SEEDED["GB01"])
        env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
        out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", str(bad)],
                             capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 1 and "GB01" in out.stdout, out.stdout

    def test_every_waiver_in_tree_carries_a_reason(self):
        missing = []
        for path in _py_files(_TREE):
            with open(path, encoding="utf-8") as f:
                src = f.read()
            for d in parse_directives(src, path):
                if d.kind in ("hogwild-race", "lock-blocking") and not d.reason:
                    missing.append(f"{path}:{d.line}: {d.kind}: {d.arg}")
        assert missing == [], "waivers without a reason:\n" + "\n".join(missing)

    def test_waiver_ledger_is_well_formed(self):
        for table in (WAIVER_JUSTIFICATIONS, REFERENCE_DEVIATIONS):
            for key, why in table.items():
                assert why.strip(), f"empty justification for {key}"
                assert re.fullmatch(r"\w+(\.\w+)+", key), f"ledger key {key!r} is not qualified"

    def test_every_waiver_and_port_only_contract_is_in_the_ledger(self):
        """Each ``hogwild-race: ok`` field, each ``lock-blocking: ok`` scope,
        and the contract of each field the JAX tree does not have, has its
        reason in WAIVER_JUSTIFICATIONS; and each entry there names one."""
        port = _field_contracts(_PORT)
        ref = _field_contracts(_REF)
        need = {k for k, fc in port.items() if fc.hogwild_ok or k not in ref}
        need |= _waived_scopes(_PORT)
        assert need - set(WAIVER_JUSTIFICATIONS) == set(), sorted(need - set(
            WAIVER_JUSTIFICATIONS))
        assert set(WAIVER_JUSTIFICATIONS) - need == set(), sorted(set(
            WAIVER_JUSTIFICATIONS) - need)

    def test_reference_contracts_carry_over(self):
        """Every field the JAX tree annotates, whose class and name exist in
        the port, carries the same directive there (lock names mapped by
        LOCK_COUNTERPARTS), or a different one that REFERENCE_DEVIATIONS
        explains; no deviation is listed that is not one."""
        port, ref, fields = _field_contracts(_PORT), _field_contracts(_REF), _fields(_PORT)
        shared = [k for k in ref if k in fields]
        assert len(shared) >= 60, len(shared)
        wrong = {}
        for key in shared:
            want = _shape(key, ref[key])
            got = _port_shape(port[key]) if key in port else None
            if key in REFERENCE_DEVIATIONS:
                assert got is not None and got != want, f"{key} no longer deviates"
            elif got != want:
                wrong[key] = (want, got)
        assert wrong == {}, wrong
        assert set(REFERENCE_DEVIATIONS) <= set(shared)

    def test_shared_class_registry_matches_tree(self):
        defined = set()
        for path in _py_files(_TREE):
            with open(path, encoding="utf-8") as f:
                defined.update(re.findall(r"^class\s+(\w+)", f.read(), re.M))
        orphaned = set(SHARED_CLASSES) - defined
        assert orphaned == set(), f"registered but undefined: {orphaned}"

    def test_module_locks_are_found(self):
        """The kernel backend's module-level locks are locks to the pass."""
        fa = _PORT["backend"]
        assert {"_BUILD_LOCK", "_COUNT_LOCK", "_INDEX_LOCK"} <= fa.module_locks

    def test_violation_codes_have_legends(self):
        assert set(CODES) == {"GB01", "SP01", "BL01", "SH01", "CT01"}
