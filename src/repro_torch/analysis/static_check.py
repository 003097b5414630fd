"""AST static analysis enforcing the DESIGN.md §12 concurrency contracts over
the port, the twin of ``repro/analysis/static_check.py``.

Three passes over every function in a file, sharing one scope model:

1. **guarded-by / swap-publish** — every access to an annotated field is
   classified (load / store / elem-store / elem-aug / attr-mutate /
   deep-mutate / mutate-call / aug) and checked against its contract and
   the set of locks held at that point (``with`` blocks, linear
   ``acquire()``/``release()`` tracking, and ``# holds-lock`` caller
   obligations).
2. **no-blocking-under-lock** — inside any held-lock region, calls that
   dispatch device work (any ``torch.`` path not in ``TORCH_ALLOWED``, the
   ``KERNEL_CALLS`` registry) or block (``time.sleep``, thread ``join``,
   ``wait`` on anything but the held condition, ``synchronize()`` on a
   device, stream or event, subprocess waits, a tensor read back to the
   host) are violations.
3. **unannotated shared state** — thread entry points are discovered from
   ``Thread(target=...)`` / supervisor-callback call sites (plus, for
   ``SHARED_CLASSES``, every public method); a mutable attribute or
   closure variable reachable from >= 2 entry points with no contract is
   a violation.

Locks are found where they are built: ``self.<attr>`` in a class, a local
of a function, and (the port's kernel backend has them) a name bound at
module level to ``threading.Lock``/``RLock``/``Condition``.

Known, documented limitations (the lockdep runtime harness covers the
gap): only ``self.<attr>`` and closure-variable accesses are tracked —
mutation through a local alias (``st = self._slots[i]; st.state = x``)
is invisible; blocking detection is registry-based, not effect-inferred;
"freshly built" for swap-publish rebinds is convention, not checked; the
pass cannot see on which device a tensor lives (``HOST_READBACKS``).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.contracts import (
    BLOCKING_QUALNAMES,
    CALLABLE_KWARGS,
    HOST_READBACKS,
    KERNEL_CALLS,
    MUTATOR_METHODS,
    SHARED_CLASSES,
    TORCH_ALLOWED,
    WAIT_ALLOWED,
    FieldContract,
    Violation,
    parse_directives,
)

# threading constructors that make a with-able lock, and the wider set of
# internally-synchronized primitives exempt from the shared-state check.
_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})
_SYNC_CTORS = _LOCK_CTORS | frozenset(
    {"Event", "Semaphore", "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue"}
)

_NONLOAD = frozenset(
    {"store", "aug", "elem-store", "elem-aug", "attr-mutate", "deep-mutate", "mutate-call"}
)
# Kinds that mutate *through* the field value rather than rebinding it.
_IN_PLACE = frozenset({"attr-mutate", "deep-mutate", "mutate-call"})


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _norm(name: str) -> str:
    return name[5:] if name.startswith("self.") else name


@dataclass
class Access:
    name: str
    kind: str
    line: int
    held: Tuple[str, ...]
    scope: "_Scope"
    stmt_span: Tuple[int, int]
    is_self: bool
    owner: Optional["_Scope"] = None  # resolved later for closure vars


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.locks: Set[str] = set()  # attr names bound to Lock/RLock/Condition
        self.sync_attrs: Set[str] = set()  # any threading/queue primitive attr
        self.thread_attrs: Set[str] = set()  # attrs bound from threading.Thread(...)
        self.methods: Dict[str, "_Scope"] = {}
        self.contracts: Dict[str, FieldContract] = {}
        self.decl_spans: Dict[str, Set[Tuple[int, int]]] = {}
        self.creates_threads = False


class _Scope:
    """One function (method, nested function, or module-level def)."""

    def __init__(self, node, qual: str, cls: Optional[_ClassInfo], parent: Optional["_Scope"],
                 module_locks: Set[str]):
        self.node = node
        self.module_locks = module_locks  # the file's module-level locks (shared set)
        self.qual = qual
        self.cls = cls
        self.parent = parent
        self.children: Dict[str, "_Scope"] = {}
        self.assumed: Tuple[str, ...] = ()  # holds-lock
        self.block_waived = False  # lock-blocking: ok on the def
        self.local_locks: Set[str] = set()
        self.local_sync: Set[str] = set()
        self.local_threads: Set[str] = set()
        self.local_names: Set[str] = set()
        self.nonlocals: Set[str] = set()
        self.calls: Set["_Scope"] = set()
        self.thread_refs: List["_Scope"] = []  # resolved thread-entry callables
        self.accesses: List[Access] = []
        self.var_contracts: Dict[str, FieldContract] = {}
        self.var_decl_spans: Dict[str, Set[Tuple[int, int]]] = {}

    @property
    def is_method(self) -> bool:
        return self.cls is not None and self.parent is None

    def resolve_var(self, name: str) -> Optional["_Scope"]:
        """Owning function scope for a Name access made inside this scope."""
        if name in self.local_names and name not in self.nonlocals:
            return self
        s = self.parent
        while s is not None:
            if name in s.local_names and name not in s.nonlocals:
                return s
            s = s.parent
        return None

    def known_lock(self, name: str) -> bool:
        if self.cls and name in self.cls.locks:
            return True
        if name in self.module_locks:
            return True
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.local_locks:
                return True
            s = s.parent
        return False


class _FileAnalysis:
    def __init__(self, source: str, path: str, registered: Dict[str, str]):
        self.source = source
        self.path = path
        self.registered = registered
        self.violations: List[Violation] = []
        self.classes: Dict[str, _ClassInfo] = {}
        self.scopes: List[_Scope] = []
        self.module_funcs: Dict[str, _Scope] = {}
        self.module_locks: Set[str] = set()
        self.hogwild_spans: List[Tuple[int, int]] = []
        self.blocking_spans: List[Tuple[int, int]] = []
        self.stmt_scope: Dict[int, Tuple[ast.stmt, Optional[_ClassInfo], Optional[_Scope]]] = {}
        self.all_stmts: List[Tuple[ast.stmt, Optional[_ClassInfo], Optional[_Scope]]] = []

    # -- helpers ----------------------------------------------------------

    def err(self, code: str, line: int, msg: str) -> None:
        self.violations.append(Violation(code, self.path, line, msg))

    def _span(self, node: ast.AST) -> Tuple[int, int]:
        return (node.lineno, getattr(node, "end_lineno", node.lineno))

    def waived(self, line: int, spans: List[Tuple[int, int]]) -> bool:
        return any(a <= line <= b for a, b in spans)

    # -- phase 1: build scopes --------------------------------------------

    def build(self) -> None:
        try:
            tree = ast.parse(self.source)
        except SyntaxError as e:  # pragma: no cover - tree is syntax-clean in CI
            self.err("CT01", e.lineno or 1, f"syntax error: {e.msg}")
            return
        self.tree = tree
        for node in tree.body:
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and (_dotted(node.value.func) or "").rsplit(".", 1)[-1] in _LOCK_CTORS):
                self.module_locks.update(t.id for t in node.targets if isinstance(t, ast.Name))
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._build_func(node, node.name, None, None)
            elif isinstance(node, ast.ClassDef):
                ci = _ClassInfo(node.name)
                self.classes[node.name] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        sc = self._build_func(sub, f"{node.name}.{sub.name}", ci, None)
                        ci.methods[sub.name] = sc

    def _build_func(
        self,
        node,
        qual: str,
        cls: Optional[_ClassInfo],
        parent: Optional[_Scope],
    ) -> _Scope:
        sc = _Scope(node, qual, cls, parent, self.module_locks)
        self.scopes.append(sc)
        if parent is not None:
            parent.children[node.name] = sc
        elif cls is None:
            self.module_funcs[node.name] = sc
        for arg in (node.args.posonlyargs + node.args.args + node.args.kwonlyargs):
            sc.local_names.add(arg.arg)
        if node.args.vararg:
            sc.local_names.add(node.args.vararg.arg)
        if node.args.kwarg:
            sc.local_names.add(node.args.kwarg.arg)
        self._index_stmts(node.body, cls, sc)
        for stmt in ast.walk(node):
            if stmt is node:
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # direct children only; deeper ones are built recursively
                if self._enclosing_func(stmt, node) is node:
                    self._build_func(stmt, f"{qual}.{stmt.name}", cls, sc)
        self._collect_bindings(sc)
        return sc

    def _enclosing_func(self, target: ast.AST, root: ast.AST) -> Optional[ast.AST]:
        """The innermost def in ``root`` that contains ``target`` (not target)."""
        found: List[ast.AST] = []

        def rec(n: ast.AST, stack: List[ast.AST]) -> None:
            if n is target:
                found.extend(stack)
                return
            is_def = isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if is_def:
                stack = stack + [n]
            for c in ast.iter_child_nodes(n):
                rec(c, stack)

        rec(root, [root] if isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef)) else [])
        return found[-1] if found else None

    def _index_stmts(self, body: Iterable[ast.stmt], cls, sc) -> None:
        for s in body:
            self.all_stmts.append((s, cls, sc))
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # inner statements indexed when that scope is built
            for sub_body in (
                getattr(s, "body", None),
                getattr(s, "orelse", None),
                getattr(s, "finalbody", None),
            ):
                if isinstance(sub_body, list):
                    self._index_stmts(sub_body, cls, sc)
            for h in getattr(s, "handlers", []) or []:
                self._index_stmts(h.body, cls, sc)

    def _collect_bindings(self, sc: _Scope) -> None:
        """Locals, nonlocals, lock/thread bindings for one scope."""
        own = self._own_statements(sc)
        for s in own:
            if isinstance(s, ast.Nonlocal):
                sc.nonlocals.update(s.names)
            elif isinstance(s, ast.Global):
                sc.nonlocals.update(s.names)  # treat like non-local: not ours
            for sub in self._walk_no_defs(s):
                targets: List[ast.expr] = []
                value: Optional[ast.expr] = None
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets, value = [sub.target], sub.value
                elif isinstance(sub, (ast.For, ast.comprehension)):
                    targets = [sub.target]
                elif isinstance(sub, ast.withitem) and sub.optional_vars is not None:
                    targets = [sub.optional_vars]
                elif isinstance(sub, ast.ExceptHandler) and sub.name:
                    sc.local_names.add(sub.name)
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            sc.local_names.add(n.id)
                if value is None or not isinstance(value, ast.Call):
                    continue
                ctor = _dotted(value.func) or ""
                tail = ctor.rsplit(".", 1)[-1]
                for t in targets:
                    name = _dotted(t)
                    if name is None:
                        continue
                    if name.startswith("self.") and sc.cls is not None:
                        attr = _norm(name)
                        if "." in attr:
                            continue
                        if tail in _LOCK_CTORS:
                            sc.cls.locks.add(attr)
                        if tail in _SYNC_CTORS:
                            sc.cls.sync_attrs.add(attr)
                        if tail == "Thread":
                            sc.cls.thread_attrs.add(attr)
                    elif isinstance(t, ast.Name):
                        if tail in _LOCK_CTORS:
                            sc.local_locks.add(t.id)
                        if tail in _SYNC_CTORS:
                            sc.local_sync.add(t.id)
                        if tail == "Thread":
                            sc.local_threads.add(t.id)

    def _own_statements(self, sc: _Scope) -> List[ast.stmt]:
        """Statements lexically in ``sc`` but not in a nested def."""
        out: List[ast.stmt] = []

        def rec(body: Iterable[ast.stmt]) -> None:
            for s in body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                out.append(s)
                for sub_body in (
                    getattr(s, "body", None),
                    getattr(s, "orelse", None),
                    getattr(s, "finalbody", None),
                ):
                    if isinstance(sub_body, list):
                        rec(sub_body)
                for h in getattr(s, "handlers", []) or []:
                    rec(h.body)

        rec(sc.node.body)
        return out

    def _walk_no_defs(self, node: ast.AST) -> Iterable[ast.AST]:
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                stack.append(c)

    # -- phase 2: bind directives -----------------------------------------

    def bind_directives(self) -> None:
        directives = parse_directives(self.source, self.path)
        # map: every def line -> scope, for holds-lock / lock-blocking on defs
        def_by_line = {sc.node.lineno: sc for sc in self.scopes}
        for d in directives:
            target = self._stmt_for(d)
            sc_def = def_by_line.get(target[0].lineno) if target else None
            if d.kind == "holds-lock":
                if sc_def is None:
                    self.err("CT01", d.line, "holds-lock must annotate a def line")
                else:
                    sc_def.assumed = sc_def.assumed + (d.lock,)
                continue
            if d.kind == "lock-blocking":
                if not d.is_ok():
                    self.err("CT01", d.line, f"lock-blocking must say 'ok', got '{d.arg}'")
                elif sc_def is not None:
                    sc_def.block_waived = True
                elif target is not None:
                    self.blocking_spans.append(self._span(target[0]))
                else:
                    self.err("CT01", d.line, "lock-blocking bound to no statement")
                continue
            # field-shaped directives
            decl = self._as_declaration(target) if target else None
            if decl is not None:
                fc_map, span_map, key = decl
                fc = fc_map.setdefault(key, FieldContract(key))
                conflict = fc.merge(d)
                if conflict:
                    self.err("CT01", d.line, conflict)
                span_map.setdefault(key, set()).add(self._span(target[0]))
            elif d.kind == "hogwild-race":
                if target is None:
                    self.err("CT01", d.line, "hogwild-race waiver bound to no statement")
                elif not d.is_ok():
                    self.err("CT01", d.line, f"hogwild-race must say 'ok', got '{d.arg}'")
                else:
                    self.hogwild_spans.append(self._span(target[0]))
            else:
                self.err(
                    "CT01",
                    d.line,
                    f"'{d.kind}' must annotate a simple assignment to a field "
                    "(self.<attr> or a local variable declaration)",
                )

    def _stmt_for(self, d) -> Optional[Tuple[ast.stmt, Optional[_ClassInfo], Optional[_Scope]]]:
        if d.trailing:
            best = None
            for item in self.all_stmts:
                s = item[0]
                a, b = self._span(s)
                if a <= d.line <= b:
                    if best is None or (b - a) < (self._span(best[0])[1] - self._span(best[0])[0]):
                        best = item
            # a directive trailing a def line binds to the def statement
            if best is None:
                for sc in self.scopes:
                    a, b = self._span(sc.node)
                    if a <= d.line <= b:
                        return (sc.node, sc.cls, sc.parent)
            return best
        nxt = None
        for item in self.all_stmts:
            if item[0].lineno > d.line:
                if nxt is None or item[0].lineno < nxt[0].lineno:
                    nxt = item
        for sc in self.scopes:
            if sc.node.lineno > d.line and (nxt is None or sc.node.lineno < nxt[0].lineno):
                nxt = (sc.node, sc.cls, sc.parent)
        return nxt

    def _as_declaration(self, item):
        """If the statement is a simple single-target assignment, return the
        (contract-map, decl-span-map, field-name) triple it declares into."""
        s, cls, sc = item
        target: Optional[ast.expr] = None
        if isinstance(s, ast.Assign) and len(s.targets) == 1:
            target = s.targets[0]
        elif isinstance(s, ast.AnnAssign):
            target = s.target
        if target is None:
            return None
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            owner_cls = cls if cls is not None else (sc.cls if sc else None)
            if owner_cls is None:
                return None
            return (owner_cls.contracts, owner_cls.decl_spans, target.attr)
        if isinstance(target, ast.Name) and sc is not None:
            return (sc.var_contracts, sc.var_decl_spans, target.id)
        return None

    # -- phase 3: walk function bodies ------------------------------------

    def walk_all(self) -> None:
        for sc in self.scopes:
            _BodyWalker(self, sc).run()

    # -- phase 4: contract enforcement ------------------------------------

    def enforce(self) -> None:
        seen: Set[Tuple[str, int, str]] = set()
        for sc in self.scopes:
            for acc in sc.accesses:
                fc = self._contract_for(acc)
                if fc is None:
                    continue
                if acc.stmt_span in self._decl_spans_for(acc):
                    continue  # the annotated declaration/publish site itself
                if acc.scope.is_method and acc.scope.node.name in ("__init__", "__post_init__"):
                    continue  # constructor runs before the object is published
                if fc.swap_published and acc.kind in _IN_PLACE:
                    self.err(
                        "SP01",
                        acc.line,
                        f"'{acc.name}' is swap-published but mutated in place "
                        f"({acc.kind}); rebind it to a freshly built value",
                    )
                    continue
                if fc.swap_published and not fc.swap_elements and acc.kind in (
                    "elem-store",
                    "elem-aug",
                ):
                    self.err(
                        "SP01",
                        acc.line,
                        f"'{acc.name}' is swap-published (whole-value): element "
                        "assignment is in-place mutation; declare "
                        "'swap-published: elements' if slots are the publish unit",
                    )
                    continue
                if fc.hogwild_ok:
                    continue  # deliberately lock-free (SP01 above still applies)
                lock = fc.guarded_by
                write_lock = fc.guarded_writes
                needs = None
                if lock is not None:
                    needs = lock
                elif write_lock is not None and acc.kind in _NONLOAD:
                    needs = write_lock
                if needs is not None and needs not in acc.held:
                    if self.waived(acc.line, self.hogwild_spans):
                        continue
                    key = ("GB01", acc.line, acc.name)
                    if key in seen:
                        continue
                    seen.add(key)
                    self.err(
                        "GB01",
                        acc.line,
                        f"'{acc.name}' requires lock '{needs}' "
                        f"(held: {list(acc.held) or 'none'}) for {acc.kind}",
                    )

    def _contract_for(self, acc: Access) -> Optional[FieldContract]:
        if acc.is_self:
            cls = acc.scope.cls
            return cls.contracts.get(acc.name) if cls else None
        if acc.owner is not None:
            return acc.owner.var_contracts.get(acc.name)
        return None

    def _decl_spans_for(self, acc: Access) -> Set[Tuple[int, int]]:
        if acc.is_self and acc.scope.cls:
            return acc.scope.cls.decl_spans.get(acc.name, set())
        if acc.owner is not None:
            return acc.owner.var_decl_spans.get(acc.name, set())
        return set()

    # -- phase 5: shared-state check --------------------------------------

    def shared_check(self) -> None:
        roots: Dict[_Scope, str] = {}
        for sc in self.scopes:
            for ref in sc.thread_refs:
                roots[ref] = ref.qual
                if sc.cls is not None:
                    sc.cls.creates_threads = True
        for cls in self.classes.values():
            if cls.name in self.registered:
                for name, m in cls.methods.items():
                    roots.setdefault(m, m.qual)
        reach: Dict[str, Set[_Scope]] = {}
        for root_sc, label in roots.items():
            reach[label] = self._closure({root_sc})
        # the "<main>" context: anything callable from outside a thread —
        # public surface = top-level methods and module-level functions.
        mains = {m for c in self.classes.values() for m in c.methods.values()}
        mains |= set(self.module_funcs.values())
        mains -= set(roots)  # a pure thread body isn't main-callable
        reach["<main>"] = self._closure(mains)

        def contexts_of(scopes: Iterable[_Scope]) -> Set[str]:
            out: Set[str] = set()
            for label, r in reach.items():
                if any(s in r for s in scopes):
                    out.add(label)
            return out

        # self attributes, grouped per class
        by_field: Dict[Tuple[str, str], List[Access]] = {}
        for sc in self.scopes:
            for acc in sc.accesses:
                if acc.is_self and sc.cls is not None:
                    by_field.setdefault((sc.cls.name, acc.name), []).append(acc)
        for (cls_name, fname), accs in sorted(by_field.items()):
            cls = self.classes[cls_name]
            if not (cls.creates_threads or cls_name in self.registered):
                continue
            if fname in cls.sync_attrs or fname in cls.thread_attrs:
                continue
            fc = cls.contracts.get(fname)
            if fc is not None and fc.annotated:
                continue
            mutating = [
                a
                for a in accs
                if a.kind in _NONLOAD
                and not (
                    a.scope.is_method and a.scope.node.name in ("__init__", "__post_init__")
                )
            ]
            if not mutating:
                continue
            ctx = contexts_of({a.scope for a in accs})
            if len(ctx) >= 2:
                first = min(a.line for a in mutating)
                self.err(
                    "SH01",
                    first,
                    f"'{cls_name}.{fname}' is mutated and reached from "
                    f"{sorted(ctx)} but has no concurrency annotation "
                    "(guarded-by / swap-published / hogwild-race: ok)",
                )
        # closure variables, grouped per owning function
        by_var: Dict[Tuple[_Scope, str], List[Access]] = {}
        for sc in self.scopes:
            for acc in sc.accesses:
                if not acc.is_self and acc.owner is not None:
                    by_var.setdefault((acc.owner, acc.name), []).append(acc)
        for (owner, vname), accs in by_var.items():
            if vname in owner.local_locks or vname in owner.local_sync:
                continue
            if vname in owner.local_threads:
                continue
            fc = owner.var_contracts.get(vname)
            if fc is not None and fc.annotated:
                continue
            nested_mut = [a for a in accs if a.scope is not owner and a.kind in _NONLOAD]
            if not nested_mut:
                continue
            ctx = contexts_of({a.scope for a in accs})
            if len(ctx) >= 2:
                first = min(a.line for a in nested_mut)
                self.err(
                    "SH01",
                    first,
                    f"closure variable '{vname}' of {owner.qual}() is mutated "
                    f"from a nested thread body and reached from {sorted(ctx)} "
                    "but has no concurrency annotation",
                )

    def _closure(self, start: Set[_Scope]) -> Set[_Scope]:
        seen = set(start)
        work = list(start)
        while work:
            sc = work.pop()
            for callee in sc.calls:
                if callee not in seen:
                    seen.add(callee)
                    work.append(callee)
        return seen

    # -- the passes in order ---------------------------------------------

    def run(self) -> List[Violation]:
        self.build()
        if not hasattr(self, "tree"):
            return self.violations
        self.bind_directives()
        self.walk_all()
        # resolve closure-var owners now that all scopes exist
        for sc in self.scopes:
            for acc in sc.accesses:
                if not acc.is_self:
                    acc.owner = sc.resolve_var(acc.name)
        self.enforce()
        self.shared_check()
        self.violations.sort(key=lambda v: (v.path, v.line, v.code))
        return self.violations


class _BodyWalker:
    """Walk one function body tracking held locks; record accesses + BL01."""

    def __init__(self, fa: _FileAnalysis, sc: _Scope):
        self.fa = fa
        self.sc = sc
        self.held: List[str] = list(sc.assumed)
        self.manual: List[str] = []

    def run(self) -> None:
        self._body(self.sc.node.body)

    def _all_held(self) -> Tuple[str, ...]:
        return tuple(self.held + self.manual)

    def _body(self, stmts: Iterable[ast.stmt]) -> None:
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(s, ast.With):
            acquired: List[str] = []
            for item in s.items:
                self._exprs(item.context_expr, s)
                name = _dotted(item.context_expr)
                if name is not None:
                    norm = _norm(name)
                    if self.sc.known_lock(norm):
                        acquired.append(norm)
            self.held.extend(acquired)
            try:
                self._body(s.body)
            finally:
                if acquired:
                    del self.held[-len(acquired) :]
            return
        if isinstance(s, ast.If):
            self._exprs(s.test, s)
            self._scan_acquire(s.test)
            self._body(s.body)
            self._body(s.orelse)
            return
        if isinstance(s, ast.While):
            self._exprs(s.test, s)
            self._scan_acquire(s.test)
            self._body(s.body)
            self._body(s.orelse)
            return
        if isinstance(s, ast.For):
            self._exprs(s.iter, s)
            self._target(s.target, s, aug=False)
            self._body(s.body)
            self._body(s.orelse)
            return
        if isinstance(s, ast.Try):
            self._body(s.body)
            for h in s.handlers:
                self._body(h.body)
            self._body(s.orelse)
            self._body(s.finalbody)
            return
        # simple statement
        self._collect(s)
        self._scan_acquire(s)

    # -- access collection -------------------------------------------------

    def _collect(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            for t in s.targets:
                self._target(t, s, aug=False)
            self._exprs(s.value, s)
        elif isinstance(s, ast.AugAssign):
            self._target(s.target, s, aug=True)
            self._exprs(s.value, s)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._target(s.target, s, aug=False)
                self._exprs(s.value, s)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                self._target(t, s, aug=False)
        else:
            self._exprs(s, s)

    def _rec(self, name: str, kind: str, line: int, stmt: ast.stmt, is_self: bool) -> None:
        self.sc.accesses.append(
            Access(
                name=name,
                kind=kind,
                line=line,
                held=self._all_held(),
                scope=self.sc,
                stmt_span=self.fa._span(stmt),
                is_self=is_self,
            )
        )

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _target(self, t: ast.expr, stmt: ast.stmt, aug: bool) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e, stmt, aug)
            return
        if isinstance(t, ast.Starred):
            self._target(t.value, stmt, aug)
            return
        attr = self._self_attr(t)
        if attr is not None:
            self._rec(attr, "aug" if aug else "store", t.lineno, stmt, True)
            return
        if isinstance(t, ast.Name):
            self._rec(t.id, "aug" if aug else "store", t.lineno, stmt, False)
            return
        if isinstance(t, ast.Subscript):
            base = t.value
            battr = self._self_attr(base)
            if battr is not None:
                self._rec(battr, "elem-aug" if aug else "elem-store", t.lineno, stmt, True)
            elif isinstance(base, ast.Name):
                self._rec(base.id, "elem-aug" if aug else "elem-store", t.lineno, stmt, False)
            else:
                root = self._mutation_root(base)
                if root is not None:
                    self._rec(root[0], "deep-mutate", t.lineno, stmt, root[1])
                self._exprs(base, stmt)
            self._exprs(t.slice, stmt)
            return
        if isinstance(t, ast.Attribute):
            base = t.value
            battr = self._self_attr(base)
            if battr is not None:
                self._rec(battr, "attr-mutate", t.lineno, stmt, True)
            elif isinstance(base, ast.Name):
                self._rec(base.id, "attr-mutate", t.lineno, stmt, False)
            else:
                root = self._mutation_root(base)
                if root is not None:
                    self._rec(root[0], "deep-mutate", t.lineno, stmt, root[1])
                self._exprs(base, stmt)
            return
        self._exprs(t, stmt)

    def _mutation_root(self, node: ast.AST) -> Optional[Tuple[str, bool]]:
        """Peel subscripts/attrs down to a self.<f> or Name root."""
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            attr = self._self_attr(node)
            if attr is not None:
                return (attr, True)
            node = node.value
        if isinstance(node, ast.Name):
            if node.id == "self":
                return None
            return (node.id, False)
        return None

    def _exprs(self, node: ast.AST, stmt: ast.stmt) -> None:
        for n in self.fa._walk_no_defs(node):
            if isinstance(n, ast.Call):
                self._call(n, stmt)
            attr = self._self_attr(n)
            if attr is not None and isinstance(n.ctx, ast.Load):
                # skip if this load is the receiver of a mutator call —
                # _call already recorded the mutation
                self._rec(attr, "load", n.lineno, stmt, True)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                self._rec(n.id, "load", n.lineno, stmt, False)

    def _call(self, call: ast.Call, stmt: ast.stmt) -> None:
        func = call.func
        dotted = _dotted(func) or ""
        tail = dotted.rsplit(".", 1)[-1] if dotted else ""
        # thread entry points + call-graph edges
        self._edges(call, dotted, tail)
        # mutation through a mutator method
        if isinstance(func, ast.Attribute) and func.attr in MUTATOR_METHODS:
            root = self._mutation_root(func.value)
            if root is not None:
                name, is_self = root
                direct = self._self_attr(func.value)
                kind = "mutate-call" if (direct or isinstance(func.value, ast.Name)) else (
                    "deep-mutate"
                )
                self._rec(name, kind, call.lineno, stmt, is_self)
        # no-blocking-under-lock
        if self._all_held() and not self.sc.block_waived:
            if not self.fa.waived(call.lineno, self.fa.blocking_spans):
                self._check_blocking(call, dotted, tail)

    def _edges(self, call: ast.Call, dotted: str, tail: str) -> None:
        sc = self.sc

        def resolve(ref: ast.expr) -> Optional[_Scope]:
            if isinstance(ref, ast.Name):
                s: Optional[_Scope] = sc
                while s is not None:
                    if ref.id in s.children:
                        return s.children[ref.id]
                    s = s.parent
                return self.fa.module_funcs.get(ref.id)
            rattr = self._self_attr(ref)
            if rattr is not None and sc.cls is not None:
                return sc.cls.methods.get(rattr)
            return None

        callee = resolve(call.func)
        if callee is not None:
            sc.calls.add(callee)
        grab_all = tail in ("Thread", "register")
        for kw in call.keywords:
            if kw.arg in CALLABLE_KWARGS or (grab_all and kw.arg is not None):
                ref = resolve(kw.value)
                if ref is not None:
                    sc.thread_refs.append(ref)
        if grab_all:
            for a in call.args:
                ref = resolve(a)
                if ref is not None:
                    sc.thread_refs.append(ref)

    def _check_blocking(self, call: ast.Call, dotted: str, tail: str) -> None:
        held = self._all_held()
        line = call.lineno

        def hit(why: str) -> None:
            self.fa.err(
                "BL01",
                line,
                f"{why} while holding {list(held)} — move it outside the "
                "critical section or waive with '# lock-blocking: ok — <why>'",
            )

        if dotted in BLOCKING_QUALNAMES:
            hit(f"blocking call {dotted}()")
            return
        base = None
        if isinstance(call.func, ast.Attribute):
            base = call.func.value
        if tail == "wait":
            if dotted in WAIT_ALLOWED:
                return  # a wait the card does, not the host
            bname = _norm(_dotted(base) or "") if base is not None else ""
            if bname and bname == held[-1]:
                return  # Condition.wait on the held condition releases it
            hit(f"wait on '{bname or dotted}'")
            return
        if tail == "join":
            if isinstance(base, ast.Constant):
                return  # str.join
            bname = _norm(_dotted(base) or "") if base is not None else ""
            if bname.startswith("os.path"):
                return
            is_thread = False
            if bname and self.sc.cls is not None and bname in self.sc.cls.thread_attrs:
                is_thread = True
            s: Optional[_Scope] = self.sc
            while s is not None and not is_thread:
                if bname in s.local_threads:
                    is_thread = True
                s = s.parent
            if is_thread:
                hit(f"thread join on '{bname}'")
            return
        if tail == "synchronize" and base is not None:
            hit(f"host wait on the card {dotted or tail}()")
            return
        if tail == "communicate" and base is not None:
            hit(f"subprocess wait {dotted or tail}()")
            return
        if tail in HOST_READBACKS and base is not None and not call.args:
            hit(f"host read-back {dotted or tail}() (waits for the card on a CUDA tensor)")
            return
        if dotted.startswith("torch."):
            if dotted not in TORCH_ALLOWED:
                hit(f"device dispatch {dotted}()")
            return
        if tail in KERNEL_CALLS:
            first = dotted.split(".", 1)[0]
            if first in ("np", "numpy", "math", "os", "meta", "info", "total", "d"):
                return
            hit(f"kernel/device call {dotted or tail}()")
            return

    def _scan_acquire(self, node: ast.AST) -> None:
        for n in self.fa._walk_no_defs(node):
            if not isinstance(n, ast.Call) or not isinstance(n.func, ast.Attribute):
                continue
            if n.func.attr not in ("acquire", "release"):
                continue
            name = _dotted(n.func.value)
            if name is None:
                continue
            norm = _norm(name)
            if not self.sc.known_lock(norm):
                continue
            if n.func.attr == "acquire":
                self.manual.append(norm)
            elif norm in self.manual:
                self.manual.remove(norm)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def check_source(
    source: str,
    path: str = "<string>",
    registered: Optional[Dict[str, str]] = None,
) -> List[Violation]:
    """Run all contract passes over one source string."""
    reg = SHARED_CLASSES if registered is None else registered
    return _FileAnalysis(source, path, reg).run()


def check_path(
    root: str,
    registered: Optional[Dict[str, str]] = None,
) -> List[Violation]:
    """Run the checker over every .py file under ``root``.

    ``src/repro_torch/analysis`` itself is excluded: the checker toolkit is
    not part of the threaded training stack (its own concurrency is
    exercised by the lockdep test suite instead).
    """
    out: List[Violation] = []
    if os.path.isfile(root):
        with open(root, encoding="utf-8") as f:
            return check_source(f.read(), root, registered)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "analysis")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                src = f.read()
            out.extend(check_source(src, path, registered))
    out.sort(key=lambda v: (v.path, v.line, v.code))
    return out
