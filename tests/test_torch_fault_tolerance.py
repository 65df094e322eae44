"""The port's straggler monitor and restart policy (fleet-scale logic,
synthetic timings): the twin of tests/test_fault_tolerance.py (all 4).
Plus the cross-package case: both packages give the same flags, advice
and restart decisions on the same seeded timings (compared exactly)."""
import numpy as np

from repro_torch.training.fault_tolerance import (RestartPolicy,
                                                  StragglerMonitor)


def test_straggler_detected_after_warmup():
    mon = StragglerMonitor(num_hosts=8, warmup_steps=3, threshold=1.5)
    for _ in range(2):
        mon.observe([1.0] * 8)
        assert mon.stragglers() == []      # warmup: no flags
    for _ in range(10):
        times = [1.0] * 8
        times[5] = 3.0                      # persistent straggler
        mon.observe(times)
    assert mon.stragglers() == [5]
    adv = mon.advice()
    assert adv["action"] == "checkpoint_and_replace"
    assert adv["hosts"] == [5]
    assert adv["expected_step_gain"] > 1.0


def test_transient_blip_not_flagged():
    mon = StragglerMonitor(num_hosts=4, warmup_steps=2, alpha=0.2)
    for i in range(20):
        times = [1.0] * 4
        if i == 10:
            times[2] = 5.0                 # one-off hiccup
        mon.observe(times)
    assert mon.stragglers() == []
    assert mon.advice()["action"] == "none"


def test_restart_policy_backoff_and_abort():
    pol = RestartPolicy(max_retries=3, backoff_base_s=1.0, stable_steps=100)
    delays = []
    for k in range(3):
        adv = pol.on_failure(step=10 + k)
        assert adv["action"] == "restart"
        delays.append(adv["backoff_s"])
    assert delays == [1.0, 2.0, 4.0]
    assert pol.on_failure(step=14)["action"] == "abort"


def test_restart_policy_resets_after_stable_progress():
    pol = RestartPolicy(max_retries=2, stable_steps=50)
    assert pol.on_failure(step=10)["action"] == "restart"
    assert pol.on_failure(step=20)["action"] == "restart"
    # long stable stretch -> counter resets
    adv = pol.on_failure(step=200)
    assert adv["action"] == "restart"
    assert adv["attempt"] == 1


def test_decisions_equal_jax():
    from repro.training.fault_tolerance import RestartPolicy as JRestart
    from repro.training.fault_tolerance import StragglerMonitor as JMonitor

    rng = np.random.default_rng(4)
    kw = dict(num_hosts=6, warmup_steps=3, threshold=1.4, alpha=0.3)
    mon, jmon = StragglerMonitor(**kw), JMonitor(**kw)
    for i in range(30):
        times = (1.0 + 0.1 * rng.standard_normal(6)).tolist()
        if i >= 12:
            times[2] *= 2.5                 # host 2 turns slow
        mon.observe(times)
        jmon.observe(times)
        assert mon.stragglers() == jmon.stragglers()
        assert mon.advice() == jmon.advice()
    assert mon.stragglers() == [2]
    pol = RestartPolicy(max_retries=3, backoff_base_s=0.5, stable_steps=20)
    jpol = JRestart(max_retries=3, backoff_base_s=0.5, stable_steps=20)
    for step in (5, 9, 12, 40, 41, 43, 44, 45):
        assert pol.on_failure(step=step) == jpol.on_failure(step=step)
