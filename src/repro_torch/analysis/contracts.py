"""Concurrency-contract grammar and registries of the port, the twin of
``repro/analysis/contracts.py`` (DESIGN.md §12).

The static checker reads *directives* — structured trailing / standalone
comments — out of each source file and binds them to fields, statements,
or functions:

    # guarded-by: <lock>         every access to the field must hold <lock>
    # guarded-by-writes: <lock>  stores/mutations must hold <lock>; lock-free
                                 reads are part of the contract (Hogwild)
    # swap-published             the field is only ever REBOUND to a freshly
                                 built immutable value — never mutated in place
    # swap-published: elements   fixed-slot container: elements are wholesale
                                 rebound (x[i] = fresh); deeper mutation is a
                                 violation
    # hogwild-race: ok — <why>   on a field declaration: deliberately lock-free
                                 by design; on any other statement: waive the
                                 guarded-by check for that one statement
    # holds-lock: <lock>         on a def: every caller holds <lock>; the body
                                 is analyzed as if inside `with <lock>`
    # lock-blocking: ok — <why>  on a def or statement: waive the
                                 no-blocking-under-lock check there

Several directives may share one comment, separated by ';'. Lock names are
the dotted source text of the lock expression with a leading ``self.``
stripped, so ``with self._state_lock:`` discharges ``guarded-by:
_state_lock``, and a closure or module lock (``ex_lock``, ``_BUILD_LOCK``)
is named literally. The grammar is the reference's, unchanged.

The registries are the port's own. ``SHARED_CLASSES`` marks the classes
whose instances are handed across threads though they spawn none;
``WAIVER_JUSTIFICATIONS`` gives the reason for every waiver and for the
contract of every field the reference does not have; ``REFERENCE_DEVIATIONS``
names each field whose contract differs from its counterpart's in the JAX
package, and why. The dispatch and blocking tables are CUDA's: every call
rooted at ``torch.`` is device work unless ``TORCH_ALLOWED`` says why it is
not, every public kernel wrapper and the port's device paths are in
``KERNEL_CALLS``, and ``synchronize()`` (on a device, a stream or an
event), subprocess waits and host read-backs of a tensor block the host.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Directive model
# ---------------------------------------------------------------------------

# Directive kinds, as they appear in source. `hogwild-race` and
# `lock-blocking` take an "ok" argument (with optional " — reason" tail);
# the guarded/holds kinds take a lock name; swap-published takes an
# optional "elements".
KINDS = (
    "guarded-by",
    "guarded-by-writes",
    "swap-published",
    "hogwild-race",
    "holds-lock",
    "lock-blocking",
)

_DIRECTIVE_RE = re.compile(
    r"(?P<kind>guarded-by-writes|guarded-by|swap-published|hogwild-race"
    r"|holds-lock|lock-blocking)"
    r"(?:\s*:\s*(?P<arg>[^;#]*))?"
)


@dataclass(frozen=True)
class Directive:
    """One parsed annotation, bound to the physical line it sits on."""

    kind: str
    arg: str  # lock name, "elements", "ok", or "ok — reason"
    line: int  # 1-based physical line of the comment token
    trailing: bool  # True: shares the line with code; False: standalone
    reason: str = ""  # text after an em/double dash in the arg, if any

    @property
    def lock(self) -> str:
        """The lock name for guarded-by / guarded-by-writes / holds-lock."""
        return self.arg

    def is_ok(self) -> bool:
        return self.arg.split("—")[0].split("--")[0].strip().lower() == "ok"


@dataclass(frozen=True)
class Violation:
    """One contract violation. ``code`` is stable for tests/CI grepping."""

    code: str  # GB01 | SP01 | BL01 | SH01 | CT01
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


# Human-readable legend, used by ``python -m repro_torch.analysis --explain``.
CODES: Dict[str, str] = {
    "GB01": "guarded field accessed outside its declared lock",
    "SP01": "swap-published field mutated in place (must be rebound wholesale)",
    "BL01": "blocking call / kernel dispatch while holding a lock",
    "SH01": "shared mutable attribute with no concurrency annotation",
    "CT01": "malformed or misplaced contract annotation",
}


def _split_reason(raw: str) -> Tuple[str, str]:
    """Split "ok — reason" / "ok -- reason" into (head, reason)."""
    for sep in ("—", "--"):
        if sep in raw:
            head, _, tail = raw.partition(sep)
            return head.strip(), tail.strip()
    return raw.strip(), ""


def parse_directives(source: str, path: str = "<string>") -> List[Directive]:
    """Extract every contract directive from ``source``.

    Uses the tokenizer (not regexes over raw lines) so directives inside
    string literals are never picked up, and so we can tell trailing
    comments (code precedes them on the line) from standalone ones.
    """
    out: List[Directive] = []
    code_lines: set[int] = set()
    comments: List[Tuple[int, str]] = []
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return out
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            comments.append((tok.start[0], tok.string))
        elif tok.type not in (
            tokenize.NL,
            tokenize.NEWLINE,
            tokenize.INDENT,
            tokenize.DEDENT,
            tokenize.ENDMARKER,
        ):
            for ln in range(tok.start[0], tok.end[0] + 1):
                code_lines.add(ln)
    for line, text in comments:
        body = text.lstrip("#").strip()
        for part in body.split(";"):
            m = _DIRECTIVE_RE.match(part.strip())
            if not m or m.start() != 0:
                continue
            kind = m.group("kind")
            raw_arg = (m.group("arg") or "").strip()
            arg, reason = _split_reason(raw_arg)
            out.append(
                Directive(
                    kind=kind,
                    arg=arg,
                    line=line,
                    trailing=line in code_lines,
                    reason=reason,
                )
            )
    return out


# ---------------------------------------------------------------------------
# Field contracts (what a directive resolves to once bound to a field)
# ---------------------------------------------------------------------------


@dataclass
class FieldContract:
    """Resolved concurrency contract for one attribute / closure variable."""

    name: str
    guarded_by: Optional[str] = None  # all accesses under this lock
    guarded_writes: Optional[str] = None  # stores under this lock, reads free
    swap_published: bool = False
    swap_elements: bool = False  # "swap-published: elements"
    hogwild_ok: bool = False
    decl_lines: List[int] = field(default_factory=list)

    def merge(self, d: Directive) -> Optional[str]:
        """Fold one more directive in; return an error string on conflict."""
        if d.kind == "guarded-by":
            if self.guarded_by not in (None, d.lock):
                return f"conflicting guarded-by locks for '{self.name}'"
            self.guarded_by = d.lock
        elif d.kind == "guarded-by-writes":
            if self.guarded_writes not in (None, d.lock):
                return f"conflicting guarded-by-writes locks for '{self.name}'"
            self.guarded_writes = d.lock
        elif d.kind == "swap-published":
            self.swap_published = True
            if d.arg == "elements":
                self.swap_elements = True
            elif d.arg not in ("", "elements"):
                return f"swap-published takes no argument or 'elements', got '{d.arg}'"
        elif d.kind == "hogwild-race":
            if not d.is_ok():
                return f"hogwild-race directive must say 'ok', got '{d.arg}'"
            self.hogwild_ok = True
        else:
            return f"directive '{d.kind}' cannot annotate a field"
        self.decl_lines.append(d.line)
        return None

    @property
    def annotated(self) -> bool:
        return bool(
            self.guarded_by or self.guarded_writes or self.swap_published or self.hogwild_ok
        )


# ---------------------------------------------------------------------------
# Per-class contract table
# ---------------------------------------------------------------------------

# Classes whose instances are shared across threads even though the class
# itself spawns none: the runners hand them to trainer / shadow / monitor /
# supervisor / stager threads. For these, every public method is treated as
# a distinct thread entry point, so any mutable attribute reached from >= 2
# methods needs an annotation. Classes that DO spawn threads
# (ThreadedShadowRunner, Supervisor, StepPipeline's owner) are picked up
# from their Thread(...) call sites.
SHARED_CLASSES: Dict[str, str] = {
    "Membership": "slot status table read by every thread, mutated via _transition",
    "EPSMeter": "global examples/s meter: trainers add, monitor/scheduler read",
    "SlotEPS": "per-slot pace meters: owner slot ticks, scheduler reads",
    "StragglerPolicy": "scheduler observed from monitor + supervision ticks, read by trainers",
    "Supervisor": "heartbeats arrive from every supervised thread",
    "EmbeddingShards": "PS shard table: trainers and stagers look up, trainers update, the "
    "shadow snapshots, the supervision tick fails and heals",
    "CachedStore": "two-tier store: trainer and stager lookups race the prefetcher's migrations",
    "StepPipeline": "staged-lookup double buffer: the owning trainer stages/consumes, "
    "the stager thread publishes entries via per-entry Events",
    "ModeController": "mode state machine: shadow round + supervision tick both "
    "observe, trainers read .mode lock-free",
}

# The reason for every waiver on the port's tree (``hogwild-race: ok`` on a
# field, ``lock-blocking: ok`` on a scope), and for the contract of every
# field the JAX package does not have. Keys are "<module>.<Class>.<field>",
# "<module>.<scope>.<variable>" for a closure variable, or "<module>.<scope>"
# for a scope waiver.
WAIVER_JUSTIFICATIONS: Dict[str, str] = {
    # --- hogwild-race: ok fields, as in the reference ----------------------
    "runners.ThreadedShadowRunner._w0": "written once before any thread starts; read-only after",
    "runners.ThreadedShadowRunner.emb": "bound pre-spawn in run(); rebinding after spawn is a bug",
    "runners.ThreadedShadowRunner.iter_count": "slot-owned counters; cross-slot reads are pacing "
    "hints where staleness is tolerable",
    "runners.ThreadedShadowRunner._shadow_rounds": "single logical writer (generation-fenced "
    "shadow incarnation); reads are post-join or advisory",
    "runners.ThreadedShadowRunner._sync_excs": "append-only post-mortem log; list.append is "
    "atomic under the GIL",
    "runners.ThreadedShadowRunner._sync_degraded": "single bool store from the give-up hook; "
    "read post-join",
    "runners.ThreadedShadowRunner._sync_stalled": "same single-store post-join contract as "
    "_sync_degraded",
    "runners.ThreadedShadowRunner._sync_crash_t": "same single-store post-join contract as "
    "_sync_degraded",
    "runners.ThreadedShadowRunner._sync_count_at_restart": "restart hook (one supervision "
    "thread) appends; read post-join",
    "runners.ThreadedShadowRunner._ps_injected": "only the supervision tick callback touches "
    "it, and ticks are serialized by the single supervisor thread",
    "runners.ThreadedShadowRunner._tick_count": "same single-tick-owner contract as "
    "_ps_injected",
    "runners.ThreadedShadowRunner.slot_eps": "slot-owned meters: owner slot ticks its cell, "
    "scheduler reads are pacing hints (SlotEPS is itself in SHARED_CLASSES)",
    "runners.ThreadedShadowRunner._pipes": "slot-owned cells: each trainer binds and drives "
    "only its own pipeline; no cross-slot access",
    "runners.ThreadedShadowRunner._pipe_stats": "slot-owned cells written in the slot's "
    "finally; merged after join",
    "runners.ThreadedShadowRunner._loss_ema": "slot-owned cells: each trainer writes only its "
    "own; the policy and the controller read a coherent latest float",
    "runners.ThreadedShadowRunner.run.losses": "slot-owned lists; merged only after join",
    "runners.ThreadedShadowRunner.run.trainer_wall": "slot-owned wall-clock cells; read after "
    "join",
    "elp.EPSMeter._buckets": "single-writer deque; eps() snapshots via list(deque) which is "
    "atomic under the GIL (documented thread model in elp.py)",
    "elp.SlotEPS._busy": "slot-owned virtual clocks: only the owner slot ticks its cell",
    "elp.SlotEPS._meters": "fixed list of per-slot meters: only owner slot i mutates "
    "_meters[i]; scheduler reads others' eps() as a pacing hint",
    "supervision.Supervisor.events": "single supervision thread appends; readers snapshot "
    "post-run",
    "supervision.Supervisor._thread": "start/stop are caller-serialized lifecycle methods",
    "shards.EmbeddingShards.dropped_updates": "lossy-by-design failure counters; element += "
    "races only ever under-count",
    "shards.EmbeddingShards.stale_lookups": "same lossy counter contract as dropped_updates",
    "shards.EmbeddingShards.states": "the per-shard slots are never rebound after init; the "
    "kernels update their tensors in place on the trainers' streams (Hogwild at row "
    "granularity), and try_update re-checks shard health after the launch",
    "cache.CachedStore._pinned": "prefetcher rebinds a fresh mask wholesale; trainers read "
    "whichever mask is current (stale pin set costs one extra cold fetch, never correctness)",
    "cache.CachedStore.stats": "hit/miss counters are diagnostic; torn increments tolerated",
    "pipeline.StepPipeline._buf": "owner-thread-confined: stage/consume/drain all run on "
    "the one trainer thread that owns the pipeline; the stager never touches the dict",
    "pipeline.StepPipeline._prep_memo": "worker-thread-confined peek memo: only the stager "
    "thread reads/writes it",
    # --- lock-blocking: ok scopes, as in the reference ---------------------
    "runners.ThreadedShadowRunner._bootstrap_join": "admission must be atomic with the "
    "membership transition; joins are rare and bounded (one stack + the join hook over the "
    "live cohort, enqueued on the joiner's stream; no host wait)",
    # --- the port's own waivers --------------------------------------------
    "runners.ThreadedShadowRunner.opt": "an Optimizer of pure functions, bound in the "
    "constructor: update() returns new state and mutates nothing (its name is a mutator's)",
    "cache.CachedStore.cold": "written only by a migration, which holds the gate alone (no "
    "reader share is out and new readers wait); merged() and the promotions read it under a "
    "reader share or the gate, so no reader sees a torn writeback",
    "shards.EmbeddingShards._streams": "bound once by share_with before any thread starts; "
    "read-only after (recover_shard records a new store on the same streams)",
    "backend._build": "the build is what _BUILD_LOCK serializes: a thread that needs the "
    "library waits for it either way, and warmup() builds every kernel of the threaded path "
    "before any thread starts, so no runner lock is held across nvcc",
    # --- contracts of fields the reference does not have -------------------
    "runners.ThreadedShadowRunner._readmit_reason": "guarded-by-writes: _state_lock. Each "
    "trainer checks only its own slot lock-free once an iteration; _take_readmit re-reads "
    "and clears it under the lock before acting, so a stale read costs one iteration",
    "runners.ThreadedShadowRunner.run.peek_memo": "guarded-by: peek_lock (the reference's "
    "_peek_memo under _prefetch_gate): the prefetch horizon and the stagers both draw ids",
    "runners.ThreadedShadowRunner.run.prefetch_busy": "guarded-by: prefetch_lock. The "
    "reference's try-lock gate held across the prefetch; here a flag claimed under a lock "
    "that is never held across device work or a host wait",
    "shards.EmbeddingShards._readers": "guarded-by: _lock; the last event each stream "
    "recorded after reading a snapshot buffer, which a snapshot waits on before reuse",
    "shards.EmbeddingShards._snap_slot": "guarded-by: _lock; which of a shard's two snapshot "
    "buffers is published, moved with snapshots[s]",
    "cache.CachedStore._readers": "guarded-by: _cond; the reader shares of the gate",
    "cache.CachedStore._migrating": "guarded-by: _cond; the gate's writer claim",
    "cache.CachedStore._uses": "guarded-by: _cond; the last event of each stream that "
    "launched on the tier, which a migration waits on",
    "runners.HogwildSim.run.gid_memo": "guarded-by: gid_lock; the sim's host ids shared by "
    "the prefetch horizon, the stager and the cached step",
    "tracing.Collector._agg": "guarded-by: _lock; the spans' counts and seconds by name, "
    "added to on the training thread and on the autograd engine's (a backward span)",
    "tracing.Collector._pending": "guarded-by: _lock; the unresolved event pairs, appended "
    "as spans close on either thread; query() and elapsed_time() run outside the lock",
}

# Fields whose contract in the port differs from their counterpart's in the
# JAX package ("<module>.<Class>.<field>" -> why). Every other counterpart
# carries the same directive (lock names mapped by LOCK_COUNTERPARTS).
REFERENCE_DEVIATIONS: Dict[str, str] = {
    "cache.CachedStore.freq": "guarded-by: _cond where the reference is hogwild-race: ok. "
    "The port counts and ages the LFU signal under the gate's lock, so a decay never "
    "races a count and a staged lookup is counted by the step that consumes it",
    "cache.CachedStore.cold": "hogwild-race: ok where the reference is guarded-by: _lock. "
    "The port's migration writes the cold store outside the lock while it holds the gate "
    "alone (the gate is a flag under _cond, which the checker cannot follow)",
}

# Reference lock names and their counterparts in the port, by "<module>.<Class>".
LOCK_COUNTERPARTS: Dict[str, Dict[str, str]] = {
    "cache.CachedStore": {"_lock": "_cond"},
}

# ---------------------------------------------------------------------------
# Dispatch and blocking tables (CUDA)
# ---------------------------------------------------------------------------

# Callables treated as kernel dispatch / device work by the
# no-blocking-under-lock pass, beyond any call rooted at ``torch.``. Matched
# on the final attribute / name segment of the call.
KERNEL_CALLS = frozenset(
    {
        # the public wrappers of the hand-written kernels (kernels/*/ops.py)
        "embedding_bag_op",
        "sparse_adagrad_op",
        "sort_occurrences",
        "easgd_round_op",
        "easgd_pair_op",
        "easgd_pair_flat_op",
        "replica_mean_op",
        "replica_mean_rows_op",
        "ma_sync_op",
        "ma_sync_rows_op",
        "bmuf_sync_op",
        "bmuf_sync_rows_op",
        "gossip_pair_flat_op",
        "gossip_round_op",
        "interaction_op",
        "gqa_attention_op",
        # PS shard device paths
        "shard_lookup",
        "shard_update",
        "try_update",
        "lookup_shard",
        "cached_lookup",
        "cached_update",
        # tiered-cache device paths
        "prefetch",
        "merged",
        "lookup",
        "update",
        # algorithm lifecycle hooks that stack / launch on device planes
        "on_join",
        "on_join_flat",
        "join_plane_flat",
        "land_flat",
        "land_elastic",
        "_shadow_round",
        # a whole background sync round is kernel dispatch wholesale
        "_round_over_active",
        # building a CachedStore copies whole tables device -> host
        "CachedStore",
    }
)

# Calls rooted at ``torch.`` that launch nothing and do not wait, each with
# the reason. Any other ``torch.`` call under a lock is device work.
TORCH_ALLOWED: Dict[str, str] = {
    "torch.cuda.current_stream": "returns the current stream's handle; enqueues nothing",
    "torch.cuda.is_available": "asks the CUDA runtime whether a card exists; no stream work",
    "torch.device": "a device descriptor; no allocation",
    "torch.cuda.Event": "constructs an event object; nothing is enqueued until record()",
    "torch.cuda.stream": "a context manager that selects the current stream",
    "torch.cuda.device": "a context manager that selects the current device",
    "torch.from_numpy": "wraps host memory as a CPU tensor: no copy, no device",
}

# Calls the pass would otherwise count as blocking, and why they are not.
WAIT_ALLOWED: Dict[str, str] = {
    "streams.wait": "the current stream waits on an event on the device; the host does "
    "not block (core/streams.py)",
}

# Blocking primitives: sleeping, joining a thread, waiting on a barrier or
# condition (waiting on the *held* condition is legal — Condition.wait
# releases its lock while blocked), a subprocess, or the card.
BLOCKING_QUALNAMES = frozenset(
    {
        "time.sleep",
        "subprocess.run",
        "subprocess.call",
        "subprocess.check_call",
        "subprocess.check_output",
    }
)
# ``synchronize()`` on a device (torch.cuda.synchronize), a stream or an
# event waits on the host until the card gets there; ``communicate()`` waits
# for a subprocess (nvcc).
BLOCKING_METHODS = frozenset({"join", "wait", "synchronize", "communicate"})

# Tensor reads back to the host. Each waits for the card when the tensor
# lives there, and the pass cannot see where it lives, so under a lock each
# is reported as a host wait; a receiver known to be a host array is waived
# at the statement with its reason.
HOST_READBACKS: Dict[str, str] = {
    "item": "one element to a Python number: waits for the producing stream",
    "tolist": "the whole tensor to Python numbers: waits for the producing stream",
    "cpu": "a copy to host memory: waits for the producing stream",
    "numpy": "a host view; a CUDA tensor must be copied back first (cpu()), which waits",
}
# float(t), int(t) and bool(t) also wait for a CUDA tensor, but their
# argument is almost always a host number: the pass does not report them.
# The port reads a loss back that way once an iteration, on the trainer's
# thread with no lock held (core/runners.py).

# Method names that mutate their receiver in place. Used both to decide a
# field is "mutable" for the unannotated-shared check and to flag in-place
# mutation through swap-published fields. `put`/`get`/`join` (queue.Queue)
# and `note`/`observe` (domain verbs) are deliberately absent.
MUTATOR_METHODS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "remove",
        "pop",
        "popleft",
        "clear",
        "add",
        "discard",
        "update",
        "setdefault",
        "set",
        "sort",
        "reverse",
    }
)

# Keyword names whose callable arguments become thread entry points
# (Supervisor.register(..., restart=..., on_give_up=...),
# SupervisorConfig(tick=...), Thread(target=...)).
CALLABLE_KWARGS = frozenset({"target", "restart", "tick", "on_give_up"})
