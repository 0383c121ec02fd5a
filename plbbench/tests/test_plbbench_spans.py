"""`spans.reduce` on a synthetic profile of two steps: device time and host
waits go to the spans open at their launch (the runtime call with the
operation's correlation id) or start, nested spans included; an operation
whose launch the profile lacks is left unattributed; and `tracing.reduce`
reads the same numbers with and without the program's spans and their
mirrors on the device's timeline, its idle gaps now labelled by the spans."""
import pytest

import spans
import tracing


class _Ev:
    def __init__(self, name, start, end, device=False, tid=1, corr=0, linked=0,
                 annotation=False):
        self._v = (name, start, end, device, tid, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def _step(t, c):
    """One step from time t, correlation ids from c: (work, program spans)."""
    work = [
        _Ev(tracing.STEP, t, t + 1000),
        _Ev(tracing.STEP, t, t + 1000, device=True, annotation=True),
        # a custom kernel's launch, directly under the kernel span
        _Ev("cudaLaunchKernel", t + 40, t + 50, corr=c + 1),
        _Ev("p2g_kernel", t + 60, t + 200, device=True, corr=c + 1, linked=c + 500),
        # an aten op inside forward kinematics
        _Ev("aten::mul", t + 105, t + 140, corr=c + 501),
        _Ev("cudaLaunchKernel", t + 110, t + 120, corr=c + 2, linked=c + 501),
        _Ev("mul_kernel", t + 210, t + 230, device=True, corr=c + 2, linked=c + 501),
        _Ev("cudaStreamSynchronize", t + 300, t + 320),
        _Ev("aten::add", t + 400, t + 420, corr=c + 502),
        _Ev("cudaLaunchKernel", t + 405, t + 415, corr=c + 3, linked=c + 502),
        _Ev("add_kernel", t + 430, t + 450, device=True, corr=c + 3, linked=c + 502),
        _Ev("cudaLaunchKernel", t + 520, t + 530, corr=c + 4),
        _Ev("loss_kernel", t + 540, t + 560, device=True, corr=c + 4),
        _Ev("cudaDeviceSynchronize", t + 700, t + 710),
        # the fetch, outside every span, and an operation whose launch the
        # profile lacks
        _Ev("cudaMemcpyAsync", t + 910, t + 920, corr=c + 5),
        _Ev("Memcpy DtoH", t + 925, t + 935, device=True, corr=c + 5),
        _Ev("orphan_kernel", t + 940, t + 950, device=True, corr=c + 99),
    ]
    program = []
    for name, s, e in (("plb.env.step", 10, 900), ("plb.physics", 20, 500),
                       ("plb.kernel.p2g", 30, 80), ("plb.physics.fk", 100, 150),
                       ("plb.loss", 510, 600), ("plb.observe", 610, 880)):
        program += [_Ev(name, t + s, t + e),
                    _Ev(name, t + s, t + e, device=True, annotation=True)]
    return work, program


def _profile(with_spans=True):
    events = []
    for i in range(2):
        work, program = _step(2000 * i, 1000 * i)
        events += work + (program if with_spans else [])
    return events


def test_device_time_and_waits_go_to_the_spans_of_their_launch():
    r = spans.reduce(_profile())
    assert r.steps == 2
    ns = 1e-9
    assert r.host_s["plb.physics"] == pytest.approx(2 * 480 * ns)
    assert r.spans["plb.physics.fk"] == 2
    assert r.device_s["plb.kernel.p2g"] == pytest.approx(2 * 140 * ns)
    assert r.device_s["plb.physics.fk"] == pytest.approx(2 * 20 * ns)
    assert r.device_s["plb.physics"] == pytest.approx(2 * 180 * ns)   # its children too
    assert r.device_s["plb.loss"] == pytest.approx(2 * 20 * ns)
    assert r.device_s["plb.env.step"] == pytest.approx(2 * 200 * ns)
    assert "plb.observe" not in r.device_s
    assert r.syncs == {"plb.env.step": 4, "plb.physics": 2, "plb.observe": 2}
    assert r.busy_s == pytest.approx(2 * 220 * ns)
    assert r.attributed_s == pytest.approx(2 * 200 * ns)
    assert [n for n, _ in r.unattributed] == ["orphan_kernel"]

    m = spans.metrics(r)
    assert m["physics_host_ms"] == pytest.approx(480 * ns * 1e3)
    assert m["physics_device_ms"] == pytest.approx(180 * ns * 1e3)
    assert m["physics_syncs_per_step"] == 1.0
    assert m["kernel_host_ms"] == pytest.approx(50 * ns * 1e3)
    assert m["observe_host_ms"] == pytest.approx(270 * ns * 1e3)
    assert m["render_march_device_ms"] is None
    assert m["attributed_share"] == pytest.approx(100 * 200 / 220)


def test_tracing_reads_the_same_work_with_and_without_spans():
    plain, spanned = tracing.reduce(_profile(False)), tracing.reduce(_profile(True))
    for f in ("steps", "span_s", "busy_s", "device_ops", "syncs", "observe_device_s",
              "top_ops"):
        assert getattr(spanned, f) == getattr(plain, f), f
    assert spanned.device_ops == 2 * 6
    assert sum(t for _, t in spanned.idle_gaps) == pytest.approx(
        sum(t for _, t in plain.idle_gaps))
    outside = "host outside the profiled calls"
    assert dict(spanned.idle_gaps).get(outside, 0) < dict(plain.idle_gaps)[outside]
    assert any(n.startswith("plb.") for n, _ in spanned.idle_gaps)


def test_no_span_no_reading():
    r = spans.reduce(_profile(False))
    assert r.steps == 2 and not r.host_s and not r.device_s and r.attributed_s == 0
    assert spans.metrics(r)["physics_host_ms"] is None


def test_counters_per_step():
    before = {"cuda_transfer.p2g_batched": 10, "cuda_stress.stress_affine": 10,
              "render.march_iters": 5}
    after = {"cuda_transfer.p2g_batched": 48, "cuda_stress.stress_affine": 48,
             "cuda_voxelize.voxelize_batched": 2, "render.march_iters": 405}
    assert spans.counted(before, after, 2) == {"kernel_launches_per_step": 39.0,
                                               "render_march_iters_per_step": 200.0}
