"""LM training in the port against the reference on the CPU, for the
recurrent and encoder-decoder families: xlstm_1_3b (mLSTM and sLSTM
blocks), jamba_v01_52b (mamba, attention and MoE) and
seamless_m4t_medium (the encoder and the cross-attending decoder).  The
dense, VLM and MoE families, and the helpers, are in
`test_torch_lm_train.py`.

Each runs one pattern cycle (two layers of seamless's one-block
pattern) at d_model 64 and B 2, in float32: the whole-model gradients
and one `make_train_step` step against `jax.value_and_grad` and the
reference's jitted step at rtol/atol 1e-4 of each leaf's largest
element (measured at most 4e-5, the xLSTM's), and the gradients with
remat on equal to those with it off, bit for bit.  xlstm and jamba run
at S 128, longer than the 64-step chunk of the sLSTM's and mamba's
scans, so `chunked_scan` rematerializes each chunk; seamless at S 32.
"""
import pytest

from test_torch_lm_train import (check_grads, check_remat_is_exact,
                                 check_step, family_case)

FAMILIES = {"ssm": ("xlstm_1_3b", 128), "hybrid": ("jamba_v01_52b", 128),
            "encdec": ("seamless_m4t_medium", 32)}


@pytest.fixture(scope="module")
def cases():
    return {fam: family_case(arch, S) for fam, (arch, S) in FAMILIES.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_whole_model_gradients_match_jax_grad(family, cases):
    check_grads(cases[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_on_and_off_give_the_same_gradients(family, cases):
    check_remat_is_exact(cases[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_train_step_matches_the_reference_float32(family, cases):
    check_step(cases[family], "f32")
