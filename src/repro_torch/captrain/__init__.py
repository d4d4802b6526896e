"""Quantization-aware capsule training (see README.md here): the port of
the reference's `repro.captrain`.

CapsTrainer (margin + reconstruction loss, AdamW, ckpt/resume) over the
typed `repro_torch.nn` pipeline; fake-quant QAT on the exact plans PTQ
derives; train steps with a fixed microbatch reduction tree; the Table-2
float-vs-int8 accuracy harness.
"""
from repro_torch.captrain.decoder import ReconDecoder  # noqa: F401
from repro_torch.captrain.evalq import (Table2Row, eval_float,  # noqa: F401
                                        eval_q7, format_rows, table2_rows)
from repro_torch.captrain.losses import (accuracy,  # noqa: F401
                                         accuracy_count, class_lengths,
                                         margin_loss, predictions)
from repro_torch.captrain.steps import (make_train_step,  # noqa: F401
                                        pairwise_reduce, tree_pairwise_mean)
from repro_torch.captrain.trainer import CapsTrainer, TrainConfig  # noqa: F401
