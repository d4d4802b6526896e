"""ptq_s.offline: seconds of the port's W8A8 quantization in set-up
(quant/lm_quant.py quantize_lm_params over each drawn part of the
tree), the sum of the harness's lm.ptq spans, the card synchronised
around each: the part of setup_s that PTQ takes."""


def read(run):
    return run.ptq_s if run.ptq_s > 0 else None
