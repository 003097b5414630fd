"""The port's runtime mode switching (``repro_torch/core/modeswitch.py``)
against the JAX package's ``repro/core/modeswitch.py``.

* ``ModeController``: the same dispersion readings and the same decisions,
  with their reasons, on the reference tests' scenarios and on seeded random
  streams; ``ModeSchedule`` and ``ControllerModeSchedule`` give the same
  per-iteration modes and switch points.
* ``HogwildSim`` under a scripted ``ModeSchedule`` and a closed-loop
  ``ControllerModeSchedule`` follows the JAX sim at the trajectory
  tolerance, with identical ``mode_events`` and ``sync_count``.
* ``ThreadedShadowRunner`` with the controller live: a straggler under the
  fixed_rate barrier moves the cohort to shadow (alone, beside the
  straggler policy, and with pipelines and a PS failure); the launcher's
  ``--auto-mode``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import modeswitch as jmode  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import modeswitch as mode  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.core.membership import FaultSpec  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.core.scheduler import PolicyConfig, StragglerPolicy  # noqa: E402
from repro_torch.data import ctr  # noqa: E402
from repro_torch.launch import train  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()
BASE = dict(skew_high=2.0, skew_low=1.3, window_s=1.0, min_dwell_s=0.0, start_mode="fixed_rate")


# ---------------------------------------------------------------------------
# ModeConfig, dispersion, ModeController
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(start_mode="async"), "start_mode"), (dict(skew_low=0.9), "skew_low"),
    (dict(skew_high=1.3, skew_low=1.3), "hysteresis"), (dict(window_s=0.0), "window_s"),
    (dict(min_dwell_s=-1.0), "min_dwell_s"),
])
def test_config_refuses_as_jax_does(kw, match):
    for mod in (mode, jmode):
        with pytest.raises(ValueError, match=match):
            mod.ModeConfig(**kw).validate()
    assert mode.ModeConfig().validate() == mode.ModeConfig()
    assert mode.MODES == jmode.MODES


@pytest.mark.parametrize("seed", range(4))
def test_dispersion_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 6))
        eps = {s: float(rng.choice([0.0, rng.uniform(1, 500)])) for s in range(n)}
        active = [bool(x) for x in rng.random(n) > 0.2]
        eligible = [bool(x) for x in rng.random(n) > 0.2]
        assert (mode.ModeController.dispersion(eps, active, eligible)
                == jmode.ModeController.dispersion(eps, active, eligible))


SCENARIOS = {
    "single_spike": ({}, [(0.0, 3.0, 0.0)]),
    "full_window": ({}, [(0.0, 3.0, 0.0), (0.5, 3.0, 0.0), (1.0, 3.0, 0.0)]),
    "streak_reset": ({}, [(0.0, 3.0, 0.0), (0.5, 1.5, 0.0), (1.0, 3.0, 0.0), (1.9, 3.0, 0.0),
                          (2.0, 3.0, 0.0)]),
    "hysteresis_parks": (dict(start_mode="shadow"), [(float(t), 1.5, 0.0) for t in range(10)]),
    "min_dwell": (dict(min_dwell_s=5.0), [(0.0, 3.0, 0.0), (1.0, 3.0, 0.0), (5.0, 3.0, 0.0),
                                          (5.5, 1.0, 0.0), (6.5, 1.0, 0.0), (10.0, 1.0, 0.0)]),
    "no_signal_resets": ({}, [(0.0, 3.0, 0.0), (5.0, 0.0, 0.0), (6.0, 3.0, 0.0),
                              (7.0, 3.0, 0.0)]),
    "quality_skew": ({}, [(0.0, 1.0, 3.0), (1.0, 1.0, 3.0)]),
}


def _decide(mod, cfg_kw, observations):
    ctl = mod.ModeController(mod.ModeConfig(**{**BASE, **cfg_kw}))
    decisions = []
    for now, disp, q in observations:
        dec = ctl.observe(now, disp, quality_skew=q)
        decisions.append(None if dec is None else (dec.target, dec.reason))
    return decisions, list(ctl.transitions), ctl.mode


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_jax_on_scenario(name):
    cfg_kw, observations = SCENARIOS[name]
    port = _decide(mode, cfg_kw, observations)
    assert port == _decide(jmode, cfg_kw, observations)
    if name in ("full_window", "min_dwell", "quality_skew", "streak_reset"):
        assert port[1], port  # the scenario does switch


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dwell", [0.0, 2.0])
def test_controller_matches_jax_on_random_stream(seed, dwell):
    rng = np.random.default_rng(seed)
    obs, level = [], 1.0
    for t in range(120):
        if rng.random() < 0.1:
            level = float(rng.choice([0.0, 1.0, 1.2, 1.6, 2.5, 4.0]))
        obs.append((t * 0.25, level * float(rng.uniform(0.9, 1.1)) if level else 0.0,
                    float(rng.choice([0.0, 0.0, 0.0, 3.0]))))
    port = _decide(mode, dict(min_dwell_s=dwell), obs)
    assert port == _decide(jmode, dict(min_dwell_s=dwell), obs)
    assert port[1], "the stream never switched"


def test_mode_schedules_match_jax():
    events = [(9, "shadow"), (3, "fixed_rate"), (14, "fixed_rate")]
    port, ref = mode.ModeSchedule(events), jmode.ModeSchedule(events)
    assert [port.mode_at(t) for t in range(20)] == [ref.mode_at(t) for t in range(20)]
    assert port.switch_points() == ref.switch_points() == sorted(events)
    for mod in (mode, jmode):
        with pytest.raises(ValueError, match="unknown mode"):
            mod.ModeSchedule([(3, "async")])
        with pytest.raises(ValueError, match="start_mode"):
            mod.ModeSchedule([], start_mode="async")

    def rates(t, s):
        return 0.1 if (s == 2 and 5 <= t < 15) else 1.0

    def quality(t, s):
        return 2.5 if (s == 1 and 18 <= t) else 1.0

    scheds = [mod.ControllerModeSchedule(
        mod.ModeController(mod.ModeConfig(**{**BASE, "window_s": 2.0, "min_dwell_s": 3.0})),
        rates, n_slots=3, quality=quality) for mod in (mode, jmode)]
    assert ([scheds[0].mode_at(t) for t in range(30)]
            == [scheds[1].mode_at(t) for t in range(30)])
    assert scheds[0].switch_points() == scheds[1].switch_points()
    assert len(scheds[0].switch_points()) == 3
    with pytest.raises(ValueError, match="n_slots"):
        mode.ControllerModeSchedule(mode.ModeController(), rates, n_slots=0)


# ---------------------------------------------------------------------------
# HogwildSim under a mode schedule
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_stream(monkeypatch):
    """The port's batches from the JAX package's stream."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})


R_SIM, SIM_ITERS = 3, 20
SIM = dict(n_trainers=R_SIM, n_threads=2, batch_size=16, seed=0)
SCRIPTED = ((4, "fixed_rate"), (11, "shadow"))


def _sim_rates(t, s):
    # slot 2 at 10% pace for [5, 15): shadow soon after 5, fixed_rate after 15
    return 0.1 if (s == R_SIM - 1 and 5 <= t < 15) else 1.0


def _msched(mod, kind):
    if kind == "scripted":
        return mod.ModeSchedule(list(SCRIPTED), start_mode="shadow")
    ctl = mod.ModeController(mod.ModeConfig(skew_high=2.0, skew_low=1.3, window_s=2.0,
                                            min_dwell_s=3.0, start_mode="fixed_rate"))
    return mod.ControllerModeSchedule(ctl, _sim_rates, n_slots=R_SIM)


def _start(kind):
    return "shadow" if kind == "scripted" else "fixed_rate"


@functools.lru_cache(maxsize=None)
def _jax_sim(kind, algo, engine):
    sim = jrunners.HogwildSim(
        jcfg.tiny(), jsync.SyncConfig(algo=algo, mode=_start(kind), gap=4, alpha=0.5,
                                      engine=engine),
        optimizer=joptim.adagrad(0.02), mode_schedule=_msched(jmode, kind), **SIM)
    st0 = sim.init_state()
    init = tuple(jax.tree.map(np.array, x) for x in (st0.w_stack, st0.opt_stack, st0.emb_state,
                                                     st0.algo_state))
    out = sim.run(SIM_ITERS, state=st0)
    return (init, out["train_loss"], out["mode_events"], out["mode"], out["sync_count"],
            jax.tree.map(np.array, out["state"].w_stack))


@pytest.mark.parametrize("kind,algo,engine", [
    ("scripted", "easgd", "flat"), ("scripted", "easgd", "pytree"), ("controller", "easgd", "flat"),
    ("controller", "easgd", "pytree"), ("controller", "ma", "flat"), ("controller", "bmuf", "flat"),
    ("controller", "gossip", "flat"),
])
def test_sim_under_mode_schedule_follows_jax(jax_stream, kind, algo, engine):
    init, j_loss, j_events, j_mode, j_syncs, j_w = _jax_sim(kind, algo, engine)
    sim = runners.HogwildSim(CFG, sync.SyncConfig(algo=algo, mode=_start(kind), gap=4, alpha=0.5,
                                                  engine=engine),
                             optimizer=optim.adagrad(0.02), mode_schedule=_msched(mode, kind),
                             device="cpu", **SIM)
    out = sim.run(SIM_ITERS, state=interop.sim_state_from_numpy(*init, device="cpu", algo=algo))
    assert out["mode_events"] == j_events and out["mode"] == j_mode
    switches = [(a, b) for _, a, b in j_events]
    assert ("fixed_rate", "shadow") in switches and ("shadow", "fixed_rate") in switches
    assert out["sync_count"] == j_syncs
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    for a, b in zip(T.leaves(out["state"].w_stack), jax.tree.leaves(j_w)):
        np.testing.assert_allclose(a.numpy(), b, **TRAJ)


def test_sim_mode_schedule_replays_and_is_absent_without_one():
    def run(msched, m="shadow"):
        return runners.HogwildSim(CFG, sync.SyncConfig(mode=m, gap=4),
                                  optimizer=optim.adagrad(0.02), mode_schedule=msched,
                                  device="cpu", **SIM).run(12)

    a, b = run(list(SCRIPTED)), run(list(SCRIPTED))
    assert a["mode_events"] == b["mode_events"] == [(4, "shadow", "fixed_rate"),
                                                    (11, "fixed_rate", "shadow")]
    assert a["train_loss"] == b["train_loss"]
    assert "mode_events" not in run(None)
    with pytest.raises(ValueError, match="mode_schedule"):
        run(mode.ModeSchedule([], start_mode="fixed_rate"))


# ---------------------------------------------------------------------------
# ThreadedShadowRunner with the controller live
# ---------------------------------------------------------------------------

def _ctl(**kw):
    return mode.ModeController(mode.ModeConfig(**{
        "skew_high": 2.0, "skew_low": 1.2, "window_s": 0.15, "min_dwell_s": 0.3,
        "start_mode": "fixed_rate", **kw}))


def _threaded(fault, iters, **kw):
    r = runners.ThreadedShadowRunner(
        CFG, sync.SyncConfig(algo="easgd", alpha=0.5, mode="fixed_rate", gap=3), n_trainers=3,
        batch_size=32, optimizer=optim.adagrad(0.02), sync_sleep_s=0.01, fault_spec=fault,
        device="cpu", **kw)
    r.warmup()
    return r.run(iters)


def _handed_to_shadow(out, iters):
    assert out["iter_count"] == [iters] * 3
    assert all(np.isfinite(x) for x in out["train_loss"])
    trans = [(a, b) for _, a, b, _ in out["mode_transitions"]]
    assert trans and trans[0] == ("fixed_rate", "shadow"), out["mode_transitions"]
    notes = [e for e in out["membership_events"] if e.kind == "mode_switch"]
    assert notes and "shadow" in notes[0].reason


@pytest.mark.timeout(120)
def test_threaded_dispersion_hands_off_to_shadow():
    out = _threaded(FaultSpec(straggler_sleep_s={2: 0.4}), 8, mode_controller=_ctl())
    _handed_to_shadow(out, 8)
    assert out["mode"] == "shadow" and out["sync_rounds"] > 0


@pytest.mark.timeout(120)
def test_threaded_switch_beside_the_policy():
    """The controller (short window) hands off first; the policy (long
    window) then demotes the straggler; nothing deadlocks."""
    policy = StragglerPolicy(PolicyConfig(eps_floor_frac=0.5, readmit_frac=0.75, window_s=1.0,
                                          probation_s=0.1, min_active=2), n_slots=3)
    out = _threaded(FaultSpec(straggler_sleep_s={2: 0.4}, straggler_until={2: 6}), 300,
                    mode_controller=_ctl(), straggler_policy=policy, eps_window_s=1.0)
    _handed_to_shadow(out, 300)
    assert any(to == "demoted" for _, _, _, to in policy.transitions), policy.transitions


@pytest.mark.timeout(120)
def test_threaded_switch_with_pipelines_and_a_ps_failure():
    fault = FaultSpec(straggler_sleep_s={2: 0.4}, ps_fail_at={0: 3}, ps_recover_after_s=0.2)
    out = _threaded(fault, 8, mode_controller=_ctl(), pipeline=PipelineConfig(depth=2))
    _handed_to_shadow(out, 8)
    kinds = [(e.kind, e.shard) for e in out["shard_events"]]
    assert ("ps_fail", 0) in kinds and ("ps_recover", 0) in kinds
    ps = out["pipeline_stats"]
    assert ps["drains"] >= 1 and ps["worker_errors"] == 0, ps


def test_threaded_controller_must_agree_with_the_mode():
    with pytest.raises(ValueError, match="mode_controller"):
        runners.ThreadedShadowRunner(CFG, sync.SyncConfig(mode="fixed_rate"), n_trainers=2,
                                     batch_size=8, optimizer=optim.adagrad(0.02), device="cpu",
                                     mode_controller=_ctl(start_mode="shadow"))
    # an auto-mode run keeps a shadow thread, so sync chaos is accepted
    runners.ThreadedShadowRunner(CFG, sync.SyncConfig(mode="fixed_rate"), n_trainers=2,
                                 batch_size=8, optimizer=optim.adagrad(0.02), device="cpu",
                                 fault_spec=FaultSpec(sync_crash_at=1), mode_controller=_ctl())


@pytest.mark.timeout(120)
def test_cli_auto_mode(capsys):
    train.main(["dlrm", "--threaded", "--device", "cpu", "--tiny", "--trainers", "3",
                "--iters", "10", "--batch-size", "32", "--auto-mode", "--mode-window", "0.15",
                "--mode-dwell", "0.3", "--straggler", "2:0.4"])
    printed = capsys.readouterr().out
    assert "mode: final=shadow switches=[(" in printed and "'fixed_rate->shadow')]" in printed
