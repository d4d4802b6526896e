"""layers.pcap_host_ms_per_wave.bulk: the int8 forward's layer.pcap span
(the primary capsules: their conv on csrc/conv_q7.cu and squash_q7) a
wave, over the traced run's unprofiled stretch, in ms of the host's clock.
Set-up's warm-up waves open it first, so the stretch's are the last;
nothing is read where the program opens no such span."""

NAME = "layer.pcap"


def read(run):
    spans, st = run.spans or {}, run.stretch
    ex = spans.get("serve.execute")
    if not ex or st is None or len(ex) != len(st["waves"]):
        return None
    t = spans.get(NAME, [])
    if len(t) < len(ex):
        return None
    return sum(t[-len(ex):]) / len(ex) * 1e3
