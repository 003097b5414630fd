"""The port's closed-loop straggler scheduling (``repro_torch/core/scheduler.py``)
against the JAX package's ``repro/core/scheduler.py``.

* ``StragglerPolicy``: the same observation sequences (the reference
  tests' scenarios, and seeded random ones with the quality knobs on) give
  the same actions, with their reasons, and the same transitions, exactly.
* ``StragglerSchedule``: the same (kind, slot, reason) events.
* ``HogwildSim`` under a ``StragglerSchedule`` follows the JAX sim at the
  trajectory tolerance, with identical membership events.
* ``ThreadedShadowRunner`` with the policy live: an injected straggler is
  demoted, then re-admitted after probation, in shadow and in fixed_rate
  (where the monitor thread drives it); the launcher's ``--auto-demote``.
"""
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import elp as jelp  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import elp, runners, sync  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.data import ctr  # noqa: E402
from repro_torch.launch import train  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()
BASE = dict(eps_floor_frac=0.5, readmit_frac=0.75, window_s=2.0, probation_s=2.0, min_active=2)


# ---------------------------------------------------------------------------
# StragglerPolicy, observation for observation
# ---------------------------------------------------------------------------

def _obs(t, eps, active=(True, True, True), eligible=None, loss=None, stale=None):
    return (float(t), dict(eps), list(active), None if eligible is None else list(eligible),
            loss, stale)


A3, DOWN = (True, True, False), (True, True, False)
SLOW = {0: 100, 1: 100, 2: 10}
SCENARIOS = {
    # a single dip never demotes; recovery clears the suspicion
    "single_dip": (3, {}, [_obs(0, SLOW), _obs(1, {0: 100, 1: 100, 2: 90})]),
    "sustained_breach": (3, {}, [_obs(t, SLOW) for t in (0, 1, 2)]),
    "never_blind": (3, {}, [_obs(t, {0: 0.0, 1: 0.0, 2: 0.0}) for t in range(10)]),
    "quorum": (2, {}, [_obs(t, {0: 100, 1: 1}, (True, True)) for t in range(10)]),
    "readmit_after_probation": (3, {}, [
        _obs(0, SLOW), _obs(2, SLOW), _obs(3, {0: 100, 1: 100, 2: 20}, DOWN),
        _obs(4, {0: 100, 1: 100, 2: 95}, DOWN), _obs(6, {0: 100, 1: 100, 2: 95}, DOWN)]),
    "relapse": (3, {}, [
        _obs(0, SLOW), _obs(2, SLOW), _obs(3, {0: 100, 1: 100, 2: 95}, DOWN),
        _obs(4, SLOW, DOWN), _obs(5, {0: 100, 1: 100, 2: 95}, DOWN),
        _obs(6, {0: 100, 1: 100, 2: 95}, DOWN), _obs(7, {0: 100, 1: 100, 2: 95}, DOWN)]),
    "hysteresis_parks": (3, {}, [_obs(0, SLOW), _obs(2, SLOW)]
                         + [_obs(t, {0: 100, 1: 100, 2: 60}, DOWN) for t in range(3, 30)]),
    "crashed_not_ours": (3, {}, [_obs(0, {0: 100, 1: 100, 2: 100})]
                         + [_obs(t, {0: 100, 1: 100, 2: 500}, DOWN) for t in range(1, 10)]),
    "lone_demoted": (3, {}, [_obs(0, SLOW), _obs(2, SLOW)]
                     + [_obs(t, {2: 10.0}, DOWN, (False, False, True)) for t in range(3, 10)]
                     + [_obs(10, {2: 95.0}, DOWN, (False, False, True)),
                        _obs(12, {2: 95.0}, DOWN, (False, False, True))]),
    "finished_not_straggler": (3, {}, [_obs(t, {0: 100, 1: 100, 2: 0.0}, A3, (True, True, False))
                                       for t in range(10)]),
    "two_stragglers_quorum2": (4, {}, [_obs(t, {0: 100, 1: 100, 2: 5, 3: 5}, (True,) * 4)
                                       for t in (0, 2)]),
    "two_stragglers_quorum3": (4, dict(min_active=3),
                               [_obs(t, {0: 100, 1: 100, 2: 5, 3: 5}, (True,) * 4)
                                for t in (0, 2)]),
    "loss_divergence": (3, dict(loss_div_frac=0.5, window_s=1.0, probation_s=1.0), [
        _obs(t, {0: 100, 1: 100, 2: 100}, loss={0: 0.5, 1: 0.5, 2: 2.0}) for t in range(4)]),
    "staleness": (3, dict(staleness_max=3.0, window_s=1.0, probation_s=1.0), [
        _obs(t, {0: 100, 1: 100, 2: 100}, stale={0: 0.0, 1: 0.0, 2: 5.0}) for t in range(4)]),
}


def _random_scenario(seed, n=4, steps=60):
    """A seeded stream of pace (and loss, staleness) readings with slots
    falling slow and recovering; each policy's membership mask follows its
    own actions, as in the runners."""
    rng = np.random.default_rng(seed)
    slow = np.zeros(n, bool)
    out = []
    for t in range(steps):
        flip = rng.random(n) < 0.08
        slow = slow ^ flip
        eps = {s: float(rng.uniform(10, 40) if slow[s] else rng.uniform(85, 115)) for s in range(n)}
        if rng.random() < 0.05:
            eps[int(rng.integers(n))] = 0.0
        loss = {s: float(rng.uniform(0.4, 0.6) * (3 if slow[s] else 1)) for s in range(n)}
        stale = {s: float(rng.uniform(0, 4)) for s in range(n)}
        eligible = [bool(x) for x in rng.random(n) > 0.03]
        out.append((float(t) * 0.5, eps, eligible, loss, stale))
    return out


def _run_policy(mod, n, cfg_kw, observations):
    pol = mod.StragglerPolicy(mod.PolicyConfig(**{**BASE, **cfg_kw}), n_slots=n)
    acts = [[(a.kind, a.slot, a.reason)
             for a in pol.observe(now, eps, active, eligible, loss_by_slot=loss,
                                  staleness_by_slot=stale)]
            for now, eps, active, eligible, loss, stale in observations]
    return acts, list(pol.transitions), [pol.state(s) for s in range(n)], pol.demoted_slots()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_matches_jax_on_scenario(name):
    n, cfg_kw, observations = SCENARIOS[name]
    port = _run_policy(sched, n, cfg_kw, observations)
    assert port == _run_policy(jsched, n, cfg_kw, observations)
    if name in ("sustained_breach", "readmit_after_probation", "loss_divergence", "staleness"):
        assert any(port[0]), port  # the scenario does act


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("knobs", [{}, dict(loss_div_frac=0.5, staleness_max=3.0,
                                            window_s=1.0, probation_s=1.5, min_active=1)],
                         ids=["pace", "quality"])
def test_policy_matches_jax_on_random_stream(seed, knobs):
    n = 4
    stream = _random_scenario(seed, n)
    runs = []
    for mod in (sched, jsched):
        pol = mod.StragglerPolicy(mod.PolicyConfig(**{**BASE, **knobs}), n_slots=n)
        active = [True] * n
        acts = []
        for now, eps, eligible, loss, stale in stream:
            got = pol.observe(now, eps, list(active), eligible, loss_by_slot=loss,
                              staleness_by_slot=stale)
            for a in got:
                active[a.slot] = a.kind == "readmit"
            acts.append([(a.kind, a.slot, a.reason) for a in got])
        runs.append((acts, list(pol.transitions)))
    assert runs[0] == runs[1]
    assert runs[0][1], "the stream never moved a slot"


@pytest.mark.parametrize("kw,match", [
    (dict(eps_floor_frac=0.0), "eps_floor_frac"), (dict(eps_floor_frac=0.6, readmit_frac=0.5),
                                                  "hysteresis"),
    (dict(window_s=0.0), "window_s"), (dict(min_active=0), "min_active"),
    (dict(loss_div_frac=0.0), "loss_div_frac"), (dict(staleness_max=-1.0), "staleness_max"),
])
def test_policy_config_refuses_as_jax_does(kw, match):
    for mod in (sched, jsched):
        with pytest.raises(ValueError, match=match):
            mod.PolicyConfig(**kw).validate()
    with pytest.raises(ValueError, match="n_slots"):
        sched.StragglerPolicy(sched.PolicyConfig(), n_slots=0)


def test_runner_refuses_a_policy_of_another_size():
    with pytest.raises(ValueError, match="slots"):
        runners.ThreadedShadowRunner(CFG, sync.SyncConfig(), n_trainers=3, batch_size=8,
                                     optimizer=optim.adagrad(0.02), device="cpu",
                                     straggler_policy=sched.StragglerPolicy(n_slots=2))


# ---------------------------------------------------------------------------
# StragglerSchedule
# ---------------------------------------------------------------------------

def _rates(t, s):
    return 20.0 if (s == 2 and t < 12) else 100.0


def _schedule(mod, **kw):
    pol = mod.StragglerPolicy(mod.PolicyConfig(**{**BASE, "window_s": 3, "probation_s": 2}),
                              n_slots=3)
    return mod.StragglerSchedule(pol, _rates, **kw)


def test_schedule_events_match_jax():
    port, ref = _schedule(sched), _schedule(jsched)
    ev = [port.events_at(t) for t in range(20)]
    assert ev == [ref.events_at(t) for t in range(20)]
    assert [(t, k, s) for t, evs in enumerate(ev) for k, s, _ in evs] == [(3, "leave", 2),
                                                                        (14, "join", 2)]
    assert list(port) == list(ref) and len(port) == len(ref) == 2
    assert port.events_at(3) == ev[3]  # re-reading replays
    assert "straggler" in ev[3][0][2] and "probation" in ev[14][0][2]


def test_schedule_skipped_iterations_are_evaluated():
    port = _schedule(sched)
    assert port.events_at(19) == []
    assert [k for _, k, _ in port] == ["leave", "join"]
    with pytest.raises(ValueError, match="slots"):
        _schedule(sched, start_active=[True])


# ---------------------------------------------------------------------------
# HogwildSim under a StragglerSchedule
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_stream(monkeypatch):
    """The port's batches from the JAX package's stream."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})


SIM = dict(n_trainers=3, n_threads=2, batch_size=16, seed=0)
SIM_ITERS = 18


def _events(out):
    return [(e.kind, e.slot, e.reason) for e in out["membership_events"]]


@functools.lru_cache(maxsize=None)
def _jax_sim(engine):
    sim = jrunners.HogwildSim(jcfg.tiny(), jsync.SyncConfig(algo="easgd", alpha=0.5, gap=3,
                                                             engine=engine),
                              optimizer=joptim.adagrad(0.02), schedule=_schedule(jsched), **SIM)
    st0 = sim.init_state()
    init = tuple(jax.tree.map(np.array, x) for x in (st0.w_stack, st0.opt_stack, st0.emb_state,
                                                     st0.algo_state))
    out = sim.run(SIM_ITERS, state=st0)
    return init, out["train_loss"], out["replica_losses"], _events(out), out["sync_count"]


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_sim_under_straggler_schedule_follows_jax(jax_stream, engine):
    init, j_loss, j_rep, j_events, j_syncs = _jax_sim(engine)
    sim = runners.HogwildSim(CFG, sync.SyncConfig(algo="easgd", alpha=0.5, gap=3, engine=engine),
                             optimizer=optim.adagrad(0.02), schedule=_schedule(sched),
                             device="cpu", **SIM)
    out = sim.run(SIM_ITERS, state=interop.sim_state_from_numpy(*init, device="cpu"))
    assert _events(out) == j_events
    assert [(k, s) for k, s, _ in j_events] == [("leave", 2), ("join", 2), ("activate", 2)]
    assert "straggler" in j_events[0][2]
    assert out["sync_count"] == j_syncs
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    np.testing.assert_allclose(out["replica_losses"], j_rep, **TRAJ)


# ---------------------------------------------------------------------------
# ThreadedShadowRunner with the policy live
# ---------------------------------------------------------------------------

# The live scenario's numbers: slot 2 sleeps ``sleep`` s in each of its first
# ``until`` iterations; ``eps_window_s`` is the busy-time meter's window and
# ``window_s`` how long a breach must last before a demotion. On a loaded
# host a healthy iteration runs for up to a second (its thread runnable or
# on a core throughout), so the meter's window must hold several healthy
# iterations, the policy's window must outlast the breach a healthy slot's
# slowest pair of iterations leaves, and the straggle must outlast the
# policy's window; the healthy trainers' ``LIVE_ITERS`` iterations (~8 ms each
# on an idle host) must outlast the straggle, so that the cohort it is
# judged against is still there. ``NARROW`` were the numbers before (with
# 200 iterations), which a loaded host broke both ways (the replays below).
LIVE = dict(sleep=1.0, until=3, eps_window_s=1.0, window_s=2.0)
NARROW = dict(sleep=0.3, until=4, eps_window_s=0.25, window_s=0.5)
LIVE_ITERS = 400
REPLAY_DT, REPLAY_OBSERVE, REPLAY_HEALTHY_S = 0.001, 20, 0.02


def _replay(elp_mod, sched_mod, numbers, mode, load, iters=LIVE_ITERS):
    """The threaded runner's policy loop on a scripted clock of
    REPLAY_DT-second steps: three trainers whose iterations take
    REPLAY_HEALTHY_S (slot 2 ``sleep`` more in its first ``until``) plus
    ``load[(slot, it)]`` seconds lost to the host, each ticking the busy-time
    meter as it ends one; in fixed_rate every member waits at a barrier each
    3 iterations, its busy clock still; the policy observes every
    REPLAY_OBSERVE steps and its actions move the membership mask. Returns
    the actions and the policy's transitions."""
    meter = elp_mod.SlotEPS(3, window_s=numbers["eps_window_s"])
    pol = sched_mod.StragglerPolicy(sched_mod.PolicyConfig(
        eps_floor_frac=0.5, readmit_frac=0.75, window_s=numbers["window_s"], probation_s=0.1,
        min_active=2), n_slots=3)

    def length(s, k):
        slept = numbers["sleep"] if s == 2 and k < numbers["until"] else 0.0
        return REPLAY_HEALTHY_S + slept + load.get((s, k), 0.0)

    active, done, parked = [True] * 3, [0] * 3, [False] * 3
    left = [round(length(s, 0) / REPLAY_DT) for s in range(3)]
    actions, step = [], 0
    while min(done) < iters:
        step += 1
        for s in range(3):
            if done[s] == iters or parked[s]:
                continue
            left[s] -= 1
            if left[s] == 0:
                meter.tick(s, length(s, done[s]))
                meter.add(s, 32)
                done[s] += 1
                left[s] = round(length(s, done[s]) / REPLAY_DT)
                parked[s] = mode == "fixed_rate" and active[s] and done[s] % 3 == 0
        if all(p or not a or d == iters for p, a, d in zip(parked, active, done)):
            parked = [False] * 3
        if step % REPLAY_OBSERVE == 0:
            alive = [d < iters for d in done]
            for a in pol.observe(step * REPLAY_DT, meter.eps_by_slot(), list(active), alive):
                active[a.slot] = a.kind == "readmit"
                parked[a.slot] = False
                actions.append((a.kind, a.slot))
    return actions, list(pol.transitions)


# Host load seen in loaded runs of the live test, as (slot, iteration):
# seconds beyond the iteration's own time. A healthy slot's slowest pair of
# iterations, placed mid-run (0.265 + 0.728 s under the suite's six workers,
# shadow; 0.283 + 0.475 s, fixed_rate; 1.00 + 1.06 s beside sixteen spinning
# processes), and a fixed_rate start where every trainer's first three
# iterations were slow.
LOADED = {
    "healthy_pair": ("shadow", {(0, 200): 0.245, (0, 201): 0.708}),
    "healthy_pair_fixed_rate": ("fixed_rate", {(0, 200): 0.263, (0, 201): 0.455}),
    "healthy_pair_oversubscribed": ("shadow", {(0, 200): 0.98, (0, 201): 1.04}),
    "slow_start_fixed_rate": ("fixed_rate", {
        (0, 0): 0.517, (0, 1): 0.081, (0, 2): 0.143, (1, 0): 0.165, (1, 1): 0.394,
        (1, 2): 0.07, (2, 0): 0.004, (2, 1): 0.14, (2, 2): 0.322}),
}


@pytest.mark.parametrize("numbers", ["LIVE", "NARROW"])
@pytest.mark.parametrize("case", sorted(LOADED))
def test_loaded_host_replay_follows_jax(case, numbers):
    """The policy and the busy-time meter on a scripted loaded host act as
    the JAX package's do, transition for transition; under LIVE the
    straggler alone is demoted and re-admitted, while NARROW demotes a
    healthy slot after its slow pair, or misses the straggler when the
    trainers start slow (the meter's 0.25 s window reads one iteration as
    128 examples/s, the healthy slots' two as 256: no reading falls below
    half of 256)."""
    mode, load = LOADED[case]
    nums = globals()[numbers]
    port = _replay(elp, sched, nums, mode, load)
    assert port == _replay(jelp, jsched, nums, mode, load)
    actions = port[0]
    if numbers == "LIVE":
        assert actions == [("demote", 2), ("readmit", 2)], port
    elif case.startswith("healthy_pair"):
        assert ("demote", 0) in actions, port
    else:
        assert ("demote", 2) not in actions, port


@pytest.fixture
def one_intra_op_thread():
    """The trainer threads are the live run's parallelism: each runs its
    ops on its own thread. With a team of two a trainer, a loaded host
    stretched healthy iterations to as much as 1.3 s, 0.30-0.35 s of it on
    the trainer's own core (0.005-0.02 s in a fast one); with one, none."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _threaded_auto(mode):
    # the straggle must outlast the policy's window (the sleep dominates
    # compute) while a healthy slot's slowest iterations on a loaded host
    # stay inside it, and the run must go on long enough after the straggle
    # for the busy-clock meter to refill (eps_window_s) and probation to pass
    policy = sched.StragglerPolicy(sched.PolicyConfig(
        eps_floor_frac=0.5, readmit_frac=0.75, window_s=LIVE["window_s"], probation_s=0.1,
        min_active=2), n_slots=3)
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", alpha=0.5, mode=mode, gap=3), n_trainers=3,
        batch_size=32, optimizer=optim.adagrad(0.02), sync_sleep_s=0.01,
        eps_window_s=LIVE["eps_window_s"],
        fault_spec=FaultSpec(straggler_sleep_s={2: LIVE["sleep"]},
                             straggler_until={2: LIVE["until"]}),
        straggler_policy=policy, device="cpu")
    r.warmup()
    admit = r._admit_slot
    r.admitted_on = []

    def spy(slot, reason=""):  # who carries each re-admission out
        r.admitted_on.append((slot, threading.current_thread().name))
        admit(slot, reason)

    r._admit_slot = spy
    return r, r.run(LIVE_ITERS)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
def test_threaded_policy_demotes_then_readmits(mode, one_intra_op_thread):
    r, out = _threaded_auto(mode)
    assert out["iter_count"] == [LIVE_ITERS] * 3
    kinds = [(e.kind, e.slot) for e in out["membership_events"]]
    assert kinds[:3] == [("leave", 2), ("join", 2), ("activate", 2)], out["membership_events"]
    assert "straggler" in out["membership_events"][0].reason
    assert "probation" in out["membership_events"][1].reason
    assert all(np.isfinite(x) for x in out["train_loss"])
    moves = [tr[2:] for tr in out["policy_transitions"] if tr[1] == 2]
    assert ("suspect", "demoted") in moves and ("probation", "healthy") in moves, moves
    # decided on the shadow or monitor thread, carried out by the slot's
    # trainer (a loaded host may see the slot demoted and re-admitted twice)
    assert r.admitted_on and set(r.admitted_on) == {(2, "trainer-2")}, r.admitted_on
    # the slept prefix is in its busy time
    assert r.slot_eps.busy(2) >= LIVE["until"] * LIVE["sleep"]
    if mode == "fixed_rate":
        assert out["sync_count"] > 0 and out["sync_rounds"] == 0  # no shadow thread


@pytest.mark.timeout(120)
def test_cli_auto_demote(capsys):
    train.main(["dlrm", "--threaded", "--device", "cpu", "--tiny", "--trainers", "3",
                "--iters", "200", "--batch-size", "32", "--auto-demote", "--eps-floor", "0.5",
                "--probation", "0.1", "--straggler", "2:0.3", "--straggler-until", "2:10"])
    printed = capsys.readouterr().out
    assert "membership: [('leave', 2, 'straggler:" in printed
