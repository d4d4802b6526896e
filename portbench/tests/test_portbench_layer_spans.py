"""The readers of the wave's own spans: a CPU traced run of a tiny cell
reports the five host-span metrics, whose sum stays inside the wave's
`serve.execute`; the idle reader gives the exact ms on a hand-built
profile, and nothing where the trace has no layer range; every reader
gives nothing for a program that opens no such span."""
import pytest

from portbench import spec
from portbench.profiling import Profile
from portbench.harness import RunRecord
from portbench.tests.test_portbench_run import _cell, _run

HOST = ("wave.h2d_ms.bulk", "layers.conv_host_ms_per_wave.bulk",
        "layers.pcap_host_ms_per_wave.bulk",
        "layers.caps_host_ms_per_wave.bulk", "wave.device_wait_ms.bulk")
IDLE = "layers.device_idle_ms_per_wave.bulk"


@pytest.fixture(scope="module")
def traced():
    res, _ = _run(_cell(), trace=True)
    return res


def test_host_span_metrics_are_read(traced):
    assert traced["correct"]
    for name in HOST:
        assert traced["metrics"][name]["value"] > 0, name
        assert traced["metrics"][name]["unit"] == "ms"


def test_host_spans_sit_inside_execute(traced):
    m = traced["metrics"]
    assert sum(m[n]["value"] for n in HOST) <= \
        m["wave.execute_ms.bulk"]["value"]


def test_no_profile_on_the_cpu_reads_nothing(traced):
    assert IDLE not in traced["metrics"]


def _record(spans, waves, profile=None):
    return RunRecord(cell=_cell(), setup_s=1.0, window_s=1.0, completed=0,
                     image_ops=0, spans=spans,
                     stretch={"wall_s": 1.0, "waves": waves,
                              "completed": 0},
                     profile=profile)


def test_readers_take_the_stretchs_last_spans():
    """Warm-up waves open the wave function's spans first: the stretch's
    two waves are the last two of each name; two convs are summed."""
    spans = {"serve.execute": [0.010, 0.010],
             "wave.h2d": [9.0, 9.0, 0.001, 0.003],
             "layer.conv0": [9.0, 0.002, 0.004],
             "layer.conv1": [9.0, 9.0, 0.001, 0.001],
             "layer.pcap": [0.002, 0.002],
             "layer.caps": [9.0, 0.0005, 0.0015],
             "serve.d2h": [0.001, 0.003]}
    rec = _record(spans, [(256, 256)] * 2)
    got = {n: spec.reader(n)(rec) for n in HOST}
    assert got == pytest.approx({
        "wave.h2d_ms.bulk": 2.0, "layers.conv_host_ms_per_wave.bulk": 4.0,
        "layers.pcap_host_ms_per_wave.bulk": 2.0,
        "layers.caps_host_ms_per_wave.bulk": 1.0,
        "wave.device_wait_ms.bulk": 2.0})


@pytest.mark.parametrize("name", HOST)
def test_readers_read_nothing_without_their_spans(name):
    """A program without the spans (the parent of this change), a stretch
    whose waves do not match serve.execute, or too few spans: None."""
    read = spec.reader(name)
    assert read(_record({"serve.execute": [0.01]}, [(4, 4)])) is None
    full = {"serve.execute": [0.01], "wave.h2d": [0.001],
            "layer.conv0": [0.001], "layer.pcap": [0.001],
            "layer.caps": [0.001], "serve.d2h": [0.001]}
    assert read(_record(full, [(4, 4)])) > 0
    assert read(_record(full, [(4, 4)] * 2)) is None
    assert read(_record({**full, "serve.execute": [0.01] * 2},
                        [(4, 4)] * 2)) is None
    assert read(_record(None, [(4, 4)])) is None


def test_idle_reader_on_a_hand_built_profile():
    """Three device operations leave two gaps: 2 ms under layer.conv0 (in
    serve.execute) and 3 ms under serve.enqueue; two waves."""
    ms = 1e-3
    p = Profile(
        device_ops=[("im2col_kernel<double>", 0.0, 1 * ms, "kernel"),
                    ("routing_q7", 3 * ms, 1 * ms, "kernel"),
                    ("im2col_kernel<double>", 7 * ms, 1 * ms, "kernel")],
        host_ranges=[("serve.execute", 0.0, 4.5 * ms),
                     ("layer.conv0", 0.5 * ms, 3.5 * ms),
                     ("serve.enqueue", 4.5 * ms, 7.5 * ms)],
        wall_s=8 * ms, waves=[(256, 256)] * 2)
    read = spec.reader(IDLE)
    assert read(_record({}, [], profile=p)) == pytest.approx(1.0)
    assert read(_record({}, [])) is None
    # a trace without layer ranges (the parent's) reads nothing
    p.host_ranges = [r for r in p.host_ranges if r[0] != "layer.conv0"]
    assert read(_record({}, [], profile=p)) is None
