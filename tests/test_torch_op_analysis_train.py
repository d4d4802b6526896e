"""The trip-weighted count of a train step (forward, the backward
through every remat region and its recompute, the in-place AdamW whose
last chunk is ragged) on meta tensors equals the full count of the same
step on CPU tensors, in flops, bytes, the tally by op and the peak of
live bytes, on the reduced cell of every arch
(`test_torch_op_analysis.py` has the cells and the serving kinds).
"""
import pytest

from repro_torch.configs.base import ARCH_IDS
from test_torch_op_analysis import (assert_equal_counts, cell_config, counts,
                                    one_thread, short_chunks)  # noqa: F401


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weighted_meta_count_equals_full_cpu_count_train(arch, short_chunks):
    weighted, full = counts(cell_config(arch), "train", quant=False)
    assert_equal_counts(weighted, full)
    # every op the counter gives flops is one FlopCounterMode counts
    assert full.cost.flops == full.flop_counter
    # the skipped iterations' saved tensors and stacked gradients stand
    # tied to the weighted one's, and are freed with them
    assert weighted.peak_bytes == full.peak_bytes
