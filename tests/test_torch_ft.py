"""The port's training-side fault tolerance (`repro_torch.train.ft`) against
the JAX package's `repro.train.ft`.

The module is framework-free code the port copies: one test holds the copy's
code equal to the reference's (docstrings aside), a hypothesis property
feeds both the same seeded step-time histories and compares every flag and
EWMA, and the reference's detector, timer and preemption tests run on the
copy. The fleet scheduler's stall detection stands on the detector, so its
edges (the strict threshold, the two-host median, the known-host gate,
`reset`) decide evictions.
"""

from __future__ import annotations

import ast
import inspect
import os
import subprocess
import sys
import textwrap

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.train import ft as jft
from repro_torch.train import ft
from repro_torch.train.ft import (PreemptionHandler, StepTimer,
                                  StragglerConfig, StragglerDetector)


def code_without_docstrings(module) -> str:
    """The module's AST with every docstring removed, dumped: two modules
    that differ only in their docstrings dump the same."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_the_copy_is_the_reference_code():
    assert code_without_docstrings(ft) == code_without_docstrings(jft)


@settings(max_examples=10, deadline=None)
@given(n_hosts=st.integers(1, 6), threshold=st.sampled_from([1.2, 1.5, 2.0]),
       patience=st.integers(1, 4), ewma=st.sampled_from([0.2, 0.5, 1.0]),
       steps=st.lists(st.lists(st.floats(0.1, 20.0), min_size=6,
                               max_size=6), min_size=1, max_size=25),
       resets=st.lists(st.integers(0, 24), max_size=3))
def test_detector_matches_the_reference(n_hosts, threshold, patience, ewma,
                                        steps, resets):
    """Seeded step-time histories, some hosts silent some steps and some
    reset: the flags and EWMAs of both detectors agree at every step."""
    cfgs = (StragglerConfig(threshold, patience, ewma),
            jft.StragglerConfig(threshold, patience, ewma))
    ours, ref = (StragglerDetector(n_hosts, cfgs[0]),
                 jft.StragglerDetector(n_hosts, cfgs[1]))
    for i, times in enumerate(steps):
        for h in range(n_hosts):
            if times[h] < 15.0:          # above: the host missed the step
                ours.record(h, times[h])
                ref.record(h, times[h])
        if i in resets:
            ours.reset(i % n_hosts)
            ref.reset(i % n_hosts)
        assert ours.update_flags() == ref.update_flags()
        assert ours._ewma == ref._ewma
        assert ours._slow_streak == ref._slow_streak


# ---------------------------------------------------------------------------
# the reference's detector edges, on the port's copy
# ---------------------------------------------------------------------------


def _detector(n_hosts: int, *, threshold: float = 1.5,
              patience: int = 3) -> StragglerDetector:
    return StragglerDetector(
        n_hosts, StragglerConfig(threshold=threshold, patience=patience))


def _prime(det: StragglerDetector, ewmas: dict[int, float]) -> None:
    for host, v in ewmas.items():
        det.record(host, v)


def test_patience_resets_on_recovery():
    det = _detector(3, patience=3)
    _prime(det, {0: 1.0, 1: 1.0, 2: 10.0})
    assert det.update_flags() == []
    assert det.update_flags() == []
    while det._ewma[2] > 1.5:
        det.record(2, 1.0)
    assert det.update_flags() == []
    det.record(2, 100.0)
    assert det.update_flags() == []
    assert det.update_flags() == []
    assert det.update_flags() == [2]


@pytest.mark.parametrize("slow,flagged", [(1.5, []), (1.5 + 1e-9, [2])])
def test_threshold_boundary_is_strict(slow, flagged):
    det = _detector(3, threshold=1.5, patience=1)
    _prime(det, {0: 1.0, 1: 1.0, 2: slow})
    assert det.update_flags() == flagged


def test_single_host_fleet_never_flags():
    det = _detector(1, patience=1)
    for _ in range(10):
        det.record(0, 1000.0)
        assert det.update_flags() == []


def test_two_host_straggler_is_detectable():
    """The true median of two hosts (the pair averaged): the slower flags
    once it exceeds 3x the faster."""
    det = _detector(2, threshold=1.5, patience=2)
    _prime(det, {0: 1.0, 1: 4.0})
    assert det.update_flags() == []
    assert det.update_flags() == [1]


def test_two_host_below_triple_stays_healthy():
    det = _detector(2, threshold=1.5, patience=1)
    _prime(det, {0: 1.0, 1: 3.0})
    for _ in range(5):
        assert det.update_flags() == []


def test_reset_clears_history():
    det = _detector(2, patience=1)
    _prime(det, {0: 1.0, 1: 100.0})
    assert det.update_flags() == [1]
    det.reset(1)
    assert det._ewma[1] is None
    assert det.update_flags() == []
    _prime(det, {1: 1.0})
    assert det.update_flags() == []


def test_unknown_hosts_gate():
    det = _detector(8, patience=1)
    for h in range(3):
        det.record(h, 1.0)
        assert det.update_flags() == []
    det.record(3, 100.0)
    assert det.update_flags() == [3]


def test_straggler_flagging():
    det = StragglerDetector(n_hosts=4)
    for _ in range(10):
        for h in range(4):
            det.record(h, 1.0 if h != 2 else 3.0)
        flags = det.update_flags()
    assert flags == [2]


def test_no_flags_when_uniform():
    det = StragglerDetector(n_hosts=4)
    for _ in range(10):
        for h in range(4):
            det.record(h, 1.0 + 0.01 * h)
        flags = det.update_flags()
    assert flags == []


def test_recovered_straggler_unflagged():
    det = StragglerDetector(n_hosts=2)
    for _ in range(6):
        det.record(0, 1.0)
        det.record(1, 5.0)
        det.update_flags()
    for _ in range(30):
        det.record(0, 1.0)
        det.record(1, 1.0)
        flags = det.update_flags()
    assert flags == []


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=1)
    for _ in range(3):
        t.start()
        t.stop()
    assert len(t.times) == 2
    assert t.mean >= 0.0


def test_preemption_handler_without_install_touches_no_signal():
    h = PreemptionHandler(install=False)
    assert not h.preempted and h._orig == {}
    h._handler(15, None)
    assert h.preempted


def test_sigterm_sets_preempted_flag():
    """A real SIGTERM, in a subprocess that imports only the port: the
    handler's flag flips instead of the process dying, and restore()
    reinstates the previous disposition."""
    script = textwrap.dedent("""
        import os, signal
        from repro_torch.train.ft import PreemptionHandler

        h = PreemptionHandler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.preempted, "flag not set by SIGTERM"
        h.restore()
        assert signal.getsignal(signal.SIGTERM) is not h._handler
        print("HANDLED")
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(__file__), "..", "src")}
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "HANDLED" in proc.stdout
