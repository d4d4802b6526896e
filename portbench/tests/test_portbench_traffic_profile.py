"""The traffic generator and the reduction of a profiler trace, on
hand-made inputs."""
import json

import pytest

from portbench import spec
from portbench.harness import RunRecord
from portbench.loadgen import Traffic
from portbench.profiling import Profile


def test_closed_warms_one_bucket():
    t = Traffic.of({"kind": "closed", "refill_to": 256,
                    "buckets": [1, 4, 16, 64, 256], "pool": 8})
    assert t.wave_buckets() == (256,)
    t = Traffic.of({"kind": "closed", "refill_to": 100,
                    "buckets": [1, 64, 128], "pool": 8})
    assert t.wave_buckets() == (128,)


@pytest.mark.parametrize("bad", [{"kind": "x"}, {"kind": "closed"},
                                 {"kind": "poisson", "refill_to": 4}])
def test_bad_traffic_raises(bad):
    with pytest.raises(ValueError):
        Traffic.of({"buckets": [1], "pool": 1, **bad})


def _trace(tmp_path):
    ev = []
    def x(name, cat, ts, dur):
        ev.append({"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur})
    # two waves: host ranges, kernels, a copy; one gap in serve.complete,
    # one in loadgen.submit, one in serve.execute
    x("serve.wave", "user_annotation", 0, 100)
    x("serve.execute", "user_annotation", 10, 60)
    x("serve.complete", "user_annotation", 70, 30)
    x("loadgen.submit", "user_annotation", 100, 50)
    x("serve.enqueue", "user_annotation", 110, 5)
    x("serve.wave", "user_annotation", 150, 100)
    x("serve.execute", "user_annotation", 160, 60)
    x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 12, 4)
    x("im2col_kernel<double>", "kernel", 20, 10)
    x("void routing_q7_kernel<10, 6, true>", "kernel", 40, 20)
    x("squash_q7_d4_kernel", "kernel", 30, 5)
    x("im2col_kernel<double>", "kernel", 170, 10)
    x("void routing_q7_kernel<10, 6, true>", "kernel", 190, 20)
    x("squash_q7_d4_kernel", "kernel", 185, 5)
    x("aten::mm", "cpu_op", 0, 1000)
    # an outer range that opens with the first serve.wave
    x("ProfilerStep", "user_annotation", 0, 1000)
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return Profile.load(p, wall_s=250e-6, waves=[(256, 256), (256, 256)])


def test_profile_reduction(tmp_path):
    p = _trace(tmp_path)
    assert len(p.device_ops) == 7 and len(p.host_ranges) == 8
    assert p.busy_s() == pytest.approx(74e-6)
    assert p.calls("routing_q7") == pytest.approx([20e-6, 20e-6])
    assert p.top_ops(2)[0][0].startswith("void routing_q7")
    idle = dict(p.idle_by_host())
    # 16-20 and 35-40 in execute, then 60-170 (midpoint 115: enqueue),
    # 180-185 execute
    assert idle["serve.execute"] == pytest.approx(14e-6)
    assert idle["serve.enqueue"] == pytest.approx(110e-6)
    assert set(idle) == {"serve.execute", "serve.enqueue"}


def test_metric_readers_on_a_trace(tmp_path):
    cell = spec.cell("capsnet_mnist_L-bulk")
    rec = RunRecord(cell=cell, setup_s=3.0, window_s=2.0, completed=512,
                    image_ops=2 * 4_143_680, profile=_trace(tmp_path),
                    spans={"serve.execute": [0.004, 0.006]},
                    stretch={"wall_s": 0.02, "waves": [(256, 256)] * 2,
                             "completed": 512})
    r = lambda name: spec.reader(name)(rec)              # noqa: E731
    assert r("images_per_s") == 256.0
    assert r("wave.execute_ms.bulk") == pytest.approx(5.0)
    assert r("engine.host_ms_per_wave.bulk") == pytest.approx(5.0)
    assert r("layers.torch_ops_device_ms_per_wave.bulk") == pytest.approx(
        0.010)
    bound = 256 * (10 * 1024 * 6 + 60) / 3.35e12
    assert r("routing_q7_roofline.bulk") == pytest.approx(
        100 * 2 * bound / 40e-6)
    assert r("device.idle_pct.bulk") == pytest.approx(
        100 * (1 - (74e-6 / 2) / 0.01))
    assert r("mfu_int8.bulk") == pytest.approx(
        100 * 2 * 4_143_680 * 512 / 0.02 / 1979e12)
    rec.profile.waves = rec.profile.waves[:1]
    assert r("routing_q7_roofline.bulk") is None      # calls != waves
    assert r("ptq_s") is None
