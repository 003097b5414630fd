"""The port's runtime lockdep harness (``repro_torch.analysis.lockdep``):
cycle detection, blocking-under-lock (the CUDA host waits and subprocess
waits included), the kernel backend's locks instrumented, the
demote-mid-wait barrier regression, and the port's ThreadedShadowRunner
under the harness on the CPU in the two configurations ``chip_smoke.py``'s
``lockdep_path`` runs on the card.

The stall detector is proven the honest way: a barrier with an arrival
COUNTER (readiness checked only on arrival) is replayed under the harness,
which reports the wedged cohort; the per-slot-flag barrier of the runners
runs the same schedule clean.
"""
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch.analysis import lockdep  # noqa: E402
from repro_torch.analysis.lockdep import (  # noqa: E402
    BACKEND_LOCKS,
    BlockedUnderLockError,
    DepCondition,
    DepLock,
    DepRLock,
    LockGraph,
    LockOrderError,
    instrument,
)
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402

pytestmark = pytest.mark.timeout(120)


# ---------------------------------------------------------------------------
# Lock-order cycles
# ---------------------------------------------------------------------------
class TestLockOrder:
    def test_inversion_detected_without_deadlock(self):
        """A->B then B->A raises in ONE thread, no hung interleaving needed."""
        g = LockGraph()
        a = DepLock(g, site="a")
        b = DepLock(g, site="b")
        with a:
            with b:
                pass
        with pytest.raises(LockOrderError, match="cycle"):
            with b:
                with a:
                    pass
        assert g.violations

    def test_consistent_order_is_clean(self):
        g = LockGraph()
        a = DepLock(g, site="a")
        b = DepLock(g, site="b")
        for _ in range(3):
            with a:
                with b:
                    pass
        g.assert_clean()
        g.assert_acyclic()

    def test_cross_thread_inversion(self):
        """t1 takes A->B, the main thread B->A: the cycle closes across
        threads even though no actual deadlock occurs."""
        g = LockGraph()
        a = DepLock(g, site="a")
        b = DepLock(g, site="b")

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join()
        with pytest.raises(LockOrderError):
            with b:
                with a:
                    pass

    def test_same_creation_site_instances_collapse(self):
        """Per-instance locks of N stores share a creation site, so an
        inversion between two *instances* is still a cycle."""
        g = LockGraph()

        class Store:
            def __init__(self):
                self.lock = DepLock(g, site="store.py:1")

        s1, s2 = Store(), Store()
        other = DepLock(g, site="other")
        with s1.lock:
            with other:
                pass
        with pytest.raises(LockOrderError):
            with other:
                with s2.lock:
                    pass

    def test_rlock_reentry_adds_no_edge(self):
        """The backend's build lock is re-entered (c_function -> load ->
        build): a re-entry is no self-cycle and adds no edge."""
        g = LockGraph()
        build = DepRLock(g, site="build")
        count = DepLock(g, site="count")
        with build:
            with build:
                with build:
                    with count:
                        pass
        assert set(g.edges) == {("build", "count")}
        g.assert_clean()
        g.assert_acyclic()
        assert g.held() == []

    def test_rlock_inversion_is_a_cycle(self):
        g = LockGraph()
        build = DepRLock(g, site="build")
        state = DepLock(g, site="state")
        with state:
            with build:
                pass
        with pytest.raises(LockOrderError):
            with build:
                with build:
                    with state:
                        pass

    def test_rlock_excludes_other_threads(self):
        g = LockGraph()
        lk = DepRLock(g, site="r")
        got = []
        with lk:
            th = threading.Thread(target=lambda: got.append(lk.acquire(timeout=0.05)))
            th.start()
            th.join()
        assert got == [False]
        with pytest.raises(RuntimeError):
            lk.release()  # not held by this thread


# ---------------------------------------------------------------------------
# Blocking under a held lock
# ---------------------------------------------------------------------------
class TestBlockedUnderLock:
    def test_sleep_under_lock_raises(self):
        with instrument() as g:
            lk = threading.Lock()
            with pytest.raises(BlockedUnderLockError):
                with lk:
                    time.sleep(0.01)
        assert g.violations

    def test_join_under_lock_raises(self):
        with instrument() as g:
            lk = threading.Lock()
            th = threading.Thread(target=lambda: None)
            th.start()
            with pytest.raises(BlockedUnderLockError):
                with lk:
                    th.join()
            th.join()
        assert g.violations and not LockGraph().violations

    def test_sleep_outside_lock_is_fine(self):
        with instrument() as g:
            lk = threading.Lock()
            with lk:
                pass
            time.sleep(0.001)
        g.assert_clean()

    def test_wait_on_held_condition_is_legal(self):
        """Condition.wait releases its own lock — never a blocking call."""
        with instrument() as g:
            cond = threading.Condition()
            with cond:
                cond.wait(timeout=0.01)
        g.assert_clean()

    @pytest.mark.parametrize("wait", [
        lambda: torch.cuda.synchronize(),
        lambda: torch.cuda.Stream.synchronize(object()),
        lambda: torch.cuda.Event.synchronize(object()),
    ], ids=["device", "stream", "event"])
    def test_cuda_host_wait_under_lock_raises(self, wait):
        """The check runs before the wait itself, so it needs no card."""
        with instrument() as g:
            lk = threading.Lock()
            with pytest.raises(BlockedUnderLockError, match="synchronize"):
                with lk:
                    wait()
        assert len(g.violations) == 1

    @pytest.mark.parametrize("method", ["communicate", "wait"])
    def test_subprocess_wait_under_lock_raises(self, method):
        """nvcc under a lock: ``Popen.communicate``/``wait`` are checked."""
        with instrument() as g:
            lk = threading.Lock()
            p = subprocess.Popen([sys.executable, "-c", "pass"], stdout=subprocess.PIPE)
            with pytest.raises(BlockedUnderLockError, match=method):
                with lk:
                    getattr(p, method)()
            p.communicate()  # outside the lock: fine
        assert p.returncode == 0 and len(g.violations) == 1

    def test_a_build_under_the_build_lock_would_be_caught(self):
        """The backend runs nvcc with ``_BUILD_LOCK`` held: under the
        harness, a first build is a held-lock wait (the smoke builds every
        kernel before it instruments a run)."""
        with instrument() as g:
            with pytest.raises(BlockedUnderLockError, match="_BUILD_LOCK"):
                with backend._BUILD_LOCK:
                    subprocess.run([sys.executable, "-c", "pass"], check=True)
        assert g.violations


# ---------------------------------------------------------------------------
# The kernel backend's locks
# ---------------------------------------------------------------------------
class TestBackendLocks:
    def test_backend_locks_are_swapped_and_report_their_sites(self):
        with instrument() as g:
            assert isinstance(backend._BUILD_LOCK, DepRLock)
            assert isinstance(backend._COUNT_LOCK, DepLock)
            assert isinstance(backend._INDEX_LOCK, DepLock)
            runner_lock = threading.Lock()

            def op():
                pass

            op.launches = 0
            with runner_lock:  # a launch under a runner lock adds the edges
                with backend._BUILD_LOCK:
                    with backend._BUILD_LOCK:  # c_function -> load
                        pass
                backend.count_launch(op)
            backend.index_tensor([0, 1, 2], torch.device("cpu"))
        assert op.launches == 1
        assert set(BACKEND_LOCKS.values()) <= g.sites
        assert {(runner_lock.site, "backend._BUILD_LOCK"),
                (runner_lock.site, "backend._COUNT_LOCK")} == set(g.edges)
        g.assert_clean()
        g.assert_acyclic()

    def test_instrument_restores_everything(self):
        orig = (threading.Lock, threading.Condition, time.sleep, threading.Thread.join)
        orig_backend = {name: getattr(backend, name) for name in BACKEND_LOCKS}
        orig_cuda = (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
                     torch.cuda.Event.synchronize)
        orig_sub = (subprocess.Popen.communicate, subprocess.Popen.wait)
        with instrument():
            assert threading.Lock is not orig[0]
            assert torch.cuda.synchronize is not orig_cuda[0]
            assert subprocess.Popen.communicate is not orig_sub[0]
            assert backend._COUNT_LOCK is not orig_backend["_COUNT_LOCK"]
        assert (threading.Lock, threading.Condition, time.sleep, threading.Thread.join) == orig
        assert {name: getattr(backend, name) for name in BACKEND_LOCKS} == orig_backend
        assert (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
                torch.cuda.Event.synchronize) == orig_cuda
        assert (subprocess.Popen.communicate, subprocess.Popen.wait) == orig_sub

    def test_instrument_restores_after_an_error(self):
        orig = backend._BUILD_LOCK, torch.cuda.synchronize
        with pytest.raises(ValueError):
            with instrument():
                raise ValueError("boom")
        assert (backend._BUILD_LOCK, torch.cuda.synchronize) == orig

    def test_without_blocking_patch_only_locks_change(self):
        orig = time.sleep, torch.cuda.synchronize
        with instrument(patch_blocking=False):
            assert (time.sleep, torch.cuda.synchronize) == orig
            assert isinstance(backend._BUILD_LOCK, DepRLock)


# ---------------------------------------------------------------------------
# The demote-mid-wait regression
# ---------------------------------------------------------------------------
class _BuggyCounterBarrier:
    """A barrier with a party count + arrival counter. Readiness is
    evaluated only on ARRIVAL, so shrinking the cohort while waiters are
    parked (a policy demotion of a straggler mid-round) leaves everyone
    waiting on a predicate nothing will ever satisfy."""

    def __init__(self, parties: int):
        self.cond = threading.Condition()  # DepCondition under instrument()
        self.parties = parties
        self.arrived = 0
        self.gen = 0

    def remove_party(self) -> None:
        with self.cond:
            self.parties -= 1
            self.cond.notify_all()  # wakes waiters; they re-check gen only

    def wait(self) -> None:
        with self.cond:
            gen = self.gen
            self.arrived += 1
            if self.arrived >= self.parties:
                self.arrived = 0
                self.gen += 1
                self.cond.notify_all()
                return
            while self.gen == gen:
                self.cond.wait(timeout=0.05)


class _FixedFlagBarrier:
    """The shape the runners use (core/runners.py ``_fr_sync_point``):
    per-slot registration + arrival flags, readiness re-evaluated by every
    waiter on every wake over the slots that REMAIN registered."""

    def __init__(self, n: int):
        self.cond = threading.Condition()
        self.registered = [True] * n
        self.arrived = [False] * n
        self.gen = 0

    def _ready(self) -> bool:
        regs = [j for j, r in enumerate(self.registered) if r]
        return bool(regs) and all(self.arrived[j] for j in regs)

    def deregister(self, i: int) -> None:
        with self.cond:
            self.registered[i] = False
            self.cond.notify_all()

    def wait(self, i: int) -> None:
        with self.cond:
            if not self.registered[i]:
                return
            gen = self.gen
            self.arrived[i] = True
            while self.gen == gen and self.registered[i] and not self._ready():
                self.cond.wait(timeout=0.05)
            if self.gen == gen and not self.registered[i]:
                self.arrived[i] = False
                self.cond.notify_all()
                return
            if self.gen == gen:
                for j in range(len(self.arrived)):
                    self.arrived[j] = False
                self.gen += 1
                self.cond.notify_all()


class TestDemoteMidWaitRegression:
    def test_harness_catches_the_counter_barrier(self):
        """3 registered slots, 2 arrive and park, the 3rd is demoted before
        arriving: the counter barrier only checks on arrival, so the cohort
        is wedged, and stalled() sees it despite the 50 ms timed re-waits."""
        with instrument(patch_blocking=False) as g:
            barrier = _BuggyCounterBarrier(parties=3)
            threads = [threading.Thread(target=barrier.wait, name=f"trainer-{i}")
                       for i in range(2)]
            for t in threads:
                t.start()
            time.sleep(0.3)  # both waiters parked
            barrier.remove_party()  # the demotion, mid-wait
            time.sleep(0.9)
            stuck = g.stalled(min_seconds=0.8)
            names = {name for name, _, _ in stuck}
            assert {"trainer-0", "trainer-1"} <= names, f"harness missed the cohort: {stuck}"
            with barrier.cond:  # un-wedge so the test itself exits cleanly
                barrier.gen += 1
                barrier.cond.notify_all()
            for t in threads:
                t.join(timeout=5)
            assert not any(t.is_alive() for t in threads)
        assert g.stalled(min_seconds=0.1) == []  # the wait epochs went with the release

    def test_flag_barrier_survives_the_same_schedule(self):
        with instrument(patch_blocking=False) as g:
            barrier = _FixedFlagBarrier(3)
            threads = [threading.Thread(target=barrier.wait, args=(i,), name=f"trainer-{i}")
                       for i in range(2)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            barrier.deregister(2)  # the same mid-wait demotion
            for t in threads:
                t.join(timeout=5)
            assert not any(t.is_alive() for t in threads)
            assert g.stalled(min_seconds=0.8) == []
        g.assert_clean()


# ---------------------------------------------------------------------------
# The port's threaded runner under the harness (lockdep_path's two runs)
# ---------------------------------------------------------------------------
CFG = dlrm_ctr.tiny()


def _fixed_rate_cached_pipelined():
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", mode="fixed_rate", gap=3), n_trainers=3,
        batch_size=16, optimizer=optim.adagrad(0.02),
        cache=CacheConfig(hot_frac=0.3, lookahead=2), pipeline=PipelineConfig(depth=2),
        device="cpu")
    r.warmup()
    out = r.run(12)
    assert out["iter_count"] == [12, 12, 12] and out["sync_count"] == 12
    assert out["cache_stats"]["prefetch_rows"] > 0 and out["cache_stats"]["evict_rows"] > 0
    assert out["pipeline_stats"]["worker_errors"] == 0 and out["sync_rounds"] == 0
    return out


def _shadow_straggler_policy():
    # the numbers of test_torch_scheduler.py's live policy scenario (LIVE,
    # LIVE_ITERS, one intra-op thread), whose replays show why a loaded host
    # needs them
    policy = sched.StragglerPolicy(sched.PolicyConfig(
        eps_floor_frac=0.5, readmit_frac=0.75, window_s=2.0, probation_s=0.1, min_active=2),
        n_slots=3)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", alpha=0.5, mode="shadow", gap=3), n_trainers=3,
        batch_size=32, optimizer=optim.adagrad(0.02), sync_sleep_s=0.01, eps_window_s=1.0,
        fault_spec=FaultSpec(straggler_sleep_s={2: 1.0}, straggler_until={2: 3}),
        straggler_policy=policy, device="cpu")
    r.warmup()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as there: the trainers are the parallelism
    try:
        out = r.run(400)
    finally:
        torch.set_num_threads(n_threads)
    kinds = [(e.kind, e.slot) for e in out["membership_events"]]
    assert kinds[:3] == [("leave", 2), ("join", 2), ("activate", 2)], kinds
    assert out["iter_count"] == [400, 400, 400] and out["sync_count"] > 0
    return out


@pytest.mark.parametrize("run", [_fixed_rate_cached_pipelined, _shadow_straggler_policy],
                         ids=["fixed_rate-cached-pipelined", "shadow-policy"])
def test_threaded_runner_under_lockdep(run):
    """The runner built and run inside the block, with the blocking calls
    patched (the CUDA host waits included) and the backend's locks
    instrumented: no finding, no ordering cycle, no stall left behind. The
    cache's gate, the barrier, the state and shard locks, the membership and
    the supervisor report into the graph."""
    with instrument() as g:
        run()
    g.assert_clean()
    g.assert_acyclic()
    assert g.stalled(min_seconds=0.1) == []
    files = {site.split(":")[0] for site in g.sites}
    assert {"runners.py", "shards.py", "membership.py", "supervision.py"} <= files, g.sites
    assert g.edges


class TestLockdepSelfConsistency:
    def test_dep_lock_is_context_manager_and_lockable(self):
        g = LockGraph()
        lk = DepLock(g, site="x")
        assert not lk.locked()
        with lk:
            assert lk.locked()
        assert not lk.locked()

    def test_dep_condition_notify_roundtrip(self):
        g = LockGraph()
        cond = DepCondition(graph=g)
        hits = []

        def waiter():
            with cond:
                while not hits:
                    cond.wait(timeout=0.05)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.1)
        with cond:
            hits.append(1)
            cond.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        g.assert_clean()

    def test_nonblocking_acquire_failure_not_counted_blocked(self):
        g = LockGraph()
        lk = DepLock(g, site="gate")
        with lk:
            assert lk.acquire(blocking=False) is False
        assert g.snapshot_blocked() == []

    def test_nested_real_primitives_stay_real(self):
        """Event/Queue internals are not instrumented (recursion + graph
        noise): an Event built under instrument() contributes no sites."""
        with instrument() as g:
            ev = threading.Event()
            ev.set()
            assert ev.wait(timeout=0.1)
        assert g.sites == set()

    def test_lockdep_module_exports(self):
        for name in lockdep.__all__:
            assert hasattr(lockdep, name)
