"""layers.conv_host_ms_per_wave.bulk: the int8 forward's layer.conv<i>
spans, every conv before the primary capsules summed (MNIST one,
CIFAR-10 four), a wave, over the traced run's unprofiled stretch, in ms
of the host's clock.  Set-up's warm-up waves open them first, so the
stretch's are the last of each; nothing is read where the program opens
no such span."""
import re

NAME = re.compile(r"layer\.conv\d+")


def read(run):
    spans, st = run.spans or {}, run.stretch
    ex = spans.get("serve.execute")
    if not ex or st is None or len(ex) != len(st["waves"]):
        return None
    convs = [t for name, t in spans.items() if NAME.fullmatch(name)]
    if not convs or any(len(t) < len(ex) for t in convs):
        return None
    return sum(sum(t[-len(ex):]) for t in convs) / len(ex) * 1e3
