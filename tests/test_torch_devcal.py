"""The port's dispatch calibration (``sedef_tpu_torch.devcal``) against the
reference package's (``sedef_tpu.devcal``), one case per test of
``tests/test_devcal.py``, plus the port's own contract: a second measured
input (the host's DP rate), and floors installed per aligner instance.
Tolerance: exact equality (integer thresholds from the same arithmetic)."""

import dataclasses

import numpy as np
import pytest
import torch

from sedef_tpu import devcal as ref_devcal
from sedef_tpu_torch import devcal
from sedef_tpu_torch.devcal import (ANCHOR_BATCH_MIN, ANCHOR_BATCH_MIN_CELLS,
                                    ANCHOR_HOST_GCUPS,
                                    ANCHOR_PREFILTER_MIN_STEPS, CARD_FLOORS,
                                    Calibration)
from sedef_tpu_torch.models import seeder
from sedef_tpu_torch.models.pipeline import run_pipeline
from sedef_tpu_torch.ops import wavefront as wf

from test_pipeline import _make_genome

torch.set_num_threads(1)

LATENCIES = (0.05, 0.1, 1, 10, 30, 120, 10000)


# the seeder's process-wide stage-1 gates as this file found them
GATES = ("PREFILTER_ON", "PREFILTER_MIN_STEPS", "ROLL_DEVICE_MIN")
IMPORTED_GATES = {g: getattr(seeder, g) for g in GATES}


@pytest.fixture(autouse=True)
def _gates_left_as_imported(request):
    """Set up before the fixture below and so torn down after its
    monkeypatch: every test must leave the gates as imported (a gate left
    on sends a later default-device search to a card)."""
    yield
    left = {g: getattr(seeder, g) for g in GATES}
    assert left == IMPORTED_GATES, request.node.name


@pytest.fixture(autouse=True)
def _keep_prefilter_gates(monkeypatch):
    """``devcal.apply`` on a cuda aligner installs the process's stage-1
    prefilter gates: every test here gets them back as they were."""
    monkeypatch.setattr(seeder, "PREFILTER_ON", seeder.PREFILTER_ON)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS",
                        seeder.PREFILTER_MIN_STEPS)


def _cuda_aligner():
    """An aligner that says it is on the card (no card is touched: only
    ``apply`` looks at it)."""
    al = wf.WavefrontAligner(device="cpu")
    al.device = torch.device("cuda", 0)
    return al


@pytest.mark.parametrize("ms", LATENCIES)
def test_derive_at_the_anchors_equals_reference(ms):
    got = Calibration.derive(ms, measured=True)
    want = ref_devcal.Calibration.derive(ms, measured=True)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.host_gcups == ANCHOR_HOST_GCUPS


def test_anchor_reproduces_frozen_values():
    cal = Calibration.derive(30.0, measured=True)
    assert cal.prefilter_min_steps == ANCHOR_PREFILTER_MIN_STEPS
    assert cal.device_batch_min_cells == ANCHOR_BATCH_MIN_CELLS
    assert cal.device_batch_min == ANCHOR_BATCH_MIN
    assert cal.prefilter_on is False


def test_fast_dispatch_reaches_the_clamp_floors():
    cal = Calibration.derive(0.1, measured=True)
    assert cal.prefilter_on is True
    assert cal.prefilter_min_steps < ANCHOR_PREFILTER_MIN_STEPS // 16
    assert cal.device_batch_min_cells == 1 << 21
    assert cal.device_batch_min == 8
    card = Calibration.derive(0.001, measured=True, floors=CARD_FLOORS)
    assert (card.device_batch_min_cells, card.device_batch_min) == (
        128 * 128, 2)


def test_scaling_is_monotone_and_clamped():
    for rate in (ANCHOR_HOST_GCUPS, 2.5):
        prev = None
        for ms in LATENCIES:
            cal = Calibration.derive(ms, measured=True, host_gcups=rate,
                                     floors=CARD_FLOORS)
            if prev is not None:
                assert cal.prefilter_min_steps >= prev.prefilter_min_steps
                assert (cal.device_batch_min_cells
                        >= prev.device_batch_min_cells)
                assert cal.device_batch_min >= prev.device_batch_min
            prev = cal
        assert prev.device_batch_min_cells == 1 << 26
        assert prev.device_batch_min == 1024
    slow = Calibration.derive(1.0, True, host_gcups=0.5, floors=CARD_FLOORS)
    fast = Calibration.derive(1.0, True, host_gcups=2.0, floors=CARD_FLOORS)
    assert fast.device_batch_min_cells == 4 * slow.device_batch_min_cells


def test_injected_and_disabled_modes(monkeypatch):
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.setenv("SEDEF_DISPATCH_MS", "30")
    cal = devcal.get()
    assert cal.dispatch_ms == 30.0 and not cal.measured
    assert cal.device_batch_min_cells == ANCHOR_BATCH_MIN_CELLS
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.delenv("SEDEF_DISPATCH_MS")
    monkeypatch.setenv("SEDEF_NO_CALIBRATE", "1")
    cal = devcal.get()
    assert not cal.measured
    assert cal.prefilter_min_steps == ANCHOR_PREFILTER_MIN_STEPS
    assert (cal.device_batch_min_cells, cal.device_batch_min) == (
        wf.FROZEN_BATCH_MIN_CELLS, wf.FROZEN_BATCH_MIN)


def test_faked_measurements_give_hand_computed_floors(monkeypatch):
    """0.15 ms per launch group and 2.5 GCUPS on the host: 2^25 * (0.15 /
    30) * (2.5 / 0.5) = 838860.8 cells, 256 * 0.005 * 5 = 6.4 problems."""
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.delenv("SEDEF_DISPATCH_MS", raising=False)
    monkeypatch.delenv("SEDEF_NO_CALIBRATE", raising=False)
    monkeypatch.setattr(devcal, "measure_dispatch_ms", lambda device: 0.15)
    monkeypatch.setattr(devcal, "measure_host_gcups", lambda: 2.5)
    cal = devcal.get()
    assert cal.measured and cal.host_gcups == 2.5
    assert cal.device_batch_min_cells == 838860
    assert cal.device_batch_min == 6
    assert cal.prefilter_on is True
    assert devcal.get() is cal  # measured once per process


def test_failed_measurement_raises(monkeypatch):
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.delenv("SEDEF_DISPATCH_MS", raising=False)
    monkeypatch.delenv("SEDEF_NO_CALIBRATE", raising=False)

    def boom(device):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(devcal, "measure_dispatch_ms", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        devcal.get()
    assert devcal._CAL is None


def test_measure_host_gcups_runs_the_native_dp():
    from sedef_tpu_torch.native import lib as nlib
    if not nlib.has("align"):
        pytest.skip("native library unavailable")
    rate = devcal.measure_host_gcups(reps=1)
    assert 0.01 < rate < 1000


def test_measure_dispatch_times_the_aligners_launch_group(monkeypatch):
    """On the CPU the same launch group runs the plain versions: one
    warm-up and ``reps`` timed groups of 8 class-128 problems."""
    calls = []
    real = wf.WavefrontAligner._solve

    def spy(self, pairs, part, S_q, S_t, K, tile):
        calls.append((len(part), S_q, S_t, K, tile))
        return real(self, pairs, part, S_q, S_t, K, tile)

    monkeypatch.setattr(wf.WavefrontAligner, "_solve", spy)
    ms = devcal.measure_dispatch_ms("cpu", reps=1)
    assert ms > 0
    assert calls == [(8, 128, 128, 1, None)] * 2


def test_apply_sets_the_instance_only():
    cal = Calibration.derive(0.15, True, host_gcups=2.5, floors=CARD_FLOORS)
    al, other = _cuda_aligner(), _cuda_aligner()
    applied = devcal.apply(al, cal)
    assert applied["device_batch_min_cells"] == 838860
    assert applied["device_batch_min"] == 6
    assert (al.DEVICE_BATCH_MIN_CELLS, al.DEVICE_BATCH_MIN) == (838860, 6)
    assert (other.DEVICE_BATCH_MIN_CELLS, other.DEVICE_BATCH_MIN) == (
        wf.FROZEN_BATCH_MIN_CELLS, wf.FROZEN_BATCH_MIN)
    assert (wf.WavefrontAligner.DEVICE_BATCH_MIN_CELLS,
            wf.WavefrontAligner.DEVICE_BATCH_MIN) == (
        wf.FROZEN_BATCH_MIN_CELLS, wf.FROZEN_BATCH_MIN)
    # what is installed is then the aligner's own value and stays
    devcal.apply(al, Calibration.derive(30.0, True))
    assert (al.DEVICE_BATCH_MIN_CELLS, al.DEVICE_BATCH_MIN) == (838860, 6)


def test_apply_leaves_a_cpu_aligner_alone(monkeypatch):
    def never(*a, **k):
        raise AssertionError("nothing is measured for a cpu aligner")

    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.setattr(devcal, "measure_dispatch_ms", never)
    monkeypatch.setattr(devcal, "measure_host_gcups", never)
    al = wf.WavefrontAligner(device="cpu")
    assert devcal.apply(al) == {"device": "cpu", "calibrated": False}
    assert "DEVICE_BATCH_MIN" not in vars(al)
    assert "DEVICE_BATCH_MIN_CELLS" not in vars(al)


def test_apply_respects_env_and_caller_overrides():
    cal = Calibration.derive(0.15, True, host_gcups=2.5, floors=CARD_FLOORS)
    # the env override, undone before the rest (the autouse fixture's
    # patch of the seeder's gates stays in force: ``apply`` below writes
    # them)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEDEF_DEVICE_BATCH_MIN_CELLS", "777")
        mp.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN_CELLS", 777)
        al = _cuda_aligner()
        applied = devcal.apply(al, cal)
        assert "device_batch_min_cells" not in applied
        assert al.DEVICE_BATCH_MIN_CELLS == 777 and al.DEVICE_BATCH_MIN == 6
    # a value the caller set on the instance survives
    al = _cuda_aligner()
    al.DEVICE_BATCH_MIN_CELLS = 1 << 18
    devcal.apply(al, cal)
    assert al.DEVICE_BATCH_MIN_CELLS == 1 << 18 and al.DEVICE_BATCH_MIN == 6
    # and so does one patched on the class
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN", 1)
        mp.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN_CELLS", 0)
        al = _cuda_aligner()
        assert devcal.apply(al, cal)["calibrated"] is True
        assert (al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS) == (1, 0)


def test_apply_reaches_through_coalescing_aligner():
    cal = Calibration.derive(0.15, True, host_gcups=2.5, floors=CARD_FLOORS)
    base = _cuda_aligner()
    devcal.apply(wf.CoalescingAligner(base), cal)
    assert (base.DEVICE_BATCH_MIN_CELLS, base.DEVICE_BATCH_MIN) == (
        838860, 6)


def test_run_pipeline_keeps_the_callers_floors(tmp_path, monkeypatch):
    """With the class patched to (1, 0), as the parity tests do,
    ``run_pipeline`` still sends every gap DP through the injected
    aligner: the calibration inside it must not undo the patch."""
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN", 1)
    monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN_CELLS", 0)
    fa = _make_genome(tmp_path, np.random.default_rng(11))[0]
    al = wf.WavefrontAligner(device="cpu")
    seen = {"problems": 0, "calls": 0}
    real = al.align_batch

    def counting(pairs):
        seen["calls"] += 1
        seen["problems"] += sum(1 for q, t in pairs if len(q) and len(t))
        return real(pairs)

    al.align_batch = counting
    run_pipeline(fa, str(tmp_path / "out"), nbuckets=4, aligner=al)
    assert seen["calls"] > 0 and seen["problems"] > 0
    assert al.device_problems == seen["problems"]
    assert (al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS) == (1, 0)


@pytest.mark.parametrize("ms", ["0.25", "1.5", "2.5", "30"])
def test_apply_installs_the_prefilter_gates_as_the_reference(ms,
                                                             monkeypatch):
    """At an injected dispatch cost, a cuda aligner gets the seeder gates
    ``sedef_tpu.devcal.apply`` installs (on at <= 2 ms; a floor of planned
    roll steps linear in the cost), and the ``[devcal]`` dict reports
    them."""
    from sedef_tpu.models import seeder as ref_seeder
    from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
    for attr in ("DEVICE_BATCH_MIN", "DEVICE_BATCH_MIN_CELLS"):
        monkeypatch.setattr(RefAligner, attr, getattr(RefAligner, attr))
    for mod in (seeder, ref_seeder):
        monkeypatch.setattr(mod, "PREFILTER_ON", False)
        monkeypatch.setattr(mod, "PREFILTER_MIN_STEPS", 1 << 20)
    for name in ("SEDEF_PREFILTER", "SEDEF_PREFILTER_MIN_STEPS",
                 "SEDEF_NO_CALIBRATE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SEDEF_DISPATCH_MS", ms)
    monkeypatch.setattr(devcal, "_CAL", None)
    monkeypatch.setattr(ref_devcal, "_CAL", None)
    applied = devcal.apply(_cuda_aligner())
    ref_devcal.apply()
    assert (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS) == (
        ref_seeder.PREFILTER_ON, ref_seeder.PREFILTER_MIN_STEPS)
    assert seeder.PREFILTER_ON is (float(ms) <= 2.0)
    assert applied["prefilter_on"] == seeder.PREFILTER_ON
    assert applied["prefilter_min_steps"] == seeder.PREFILTER_MIN_STEPS


def test_apply_prefilter_env_overrides_and_cpu_aligner(monkeypatch):
    """``SEDEF_PREFILTER`` / ``SEDEF_PREFILTER_MIN_STEPS`` keep the
    seeder's values; a cpu aligner installs nothing."""
    cal = Calibration.derive(0.25, True)
    monkeypatch.setattr(seeder, "PREFILTER_ON", False)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 123)
    monkeypatch.setenv("SEDEF_PREFILTER", "")
    monkeypatch.setenv("SEDEF_PREFILTER_MIN_STEPS", "123")
    applied = devcal.apply(_cuda_aligner(), cal)
    assert "prefilter_on" not in applied
    assert "prefilter_min_steps" not in applied
    assert (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS) == (False, 123)
    monkeypatch.delenv("SEDEF_PREFILTER_MIN_STEPS")
    assert devcal.apply(_cuda_aligner(), cal)["prefilter_min_steps"] == \
        cal.prefilter_min_steps
    assert seeder.PREFILTER_ON is False  # SEDEF_PREFILTER is still set
    monkeypatch.delenv("SEDEF_PREFILTER")
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 123)
    assert devcal.apply(wf.WavefrontAligner(device="cpu"), cal) == {
        "device": "cpu", "calibrated": False}
    assert (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS) == (False, 123)

