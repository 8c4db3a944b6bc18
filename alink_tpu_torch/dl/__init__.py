"""DL subsystem of the port: the BERT family and KerasSequential as
``nn.Module``s, the train loop and batched inference, MLM pretraining, the
tokenizer and the shipped corpora (the reference's ``alink_tpu.dl`` surface
but its mesh sharding rules, which wait for ROADMAP A3).

- :mod:`modules`   — TransformerEncoder (BERT family), KerasSequential
- :mod:`attention` — full, blockwise (the flash kernel's route) and ring
  attention
- :mod:`train`     — the train loop (feed thread, accumulation, eval,
  checkpoints) and ``predict_model``
- :mod:`pretrain`  — MLM pretraining producing HF-layout checkpoints
- :mod:`tokenizer` — WordPiece-style tokenizer with corpus-built vocab
- :mod:`data`      — loaders for the shipped real-text corpora and the
  block-scheduled streaming corpus (:class:`~.data.CorpusStream`)
"""

from .attention import blockwise_attention, full_attention, ring_attention
from .data import (CorpusStream, load_reviews, load_sst2, scheduled_order,
                   sst2_split)
from .modules import (BertConfig, KerasSequential, TransformerEncoder,
                      parse_layers)
from .pretrain import pretrain_and_save, pretrain_mlm
from .tokenizer import Tokenizer
from .train import TrainConfig, predict_model, train_model

__all__ = [
    "BertConfig",
    "TransformerEncoder",
    "KerasSequential",
    "parse_layers",
    "blockwise_attention",
    "full_attention",
    "ring_attention",
    "TrainConfig",
    "train_model",
    "predict_model",
    "pretrain_mlm",
    "pretrain_and_save",
    "load_reviews",
    "load_sst2",
    "sst2_split",
    "CorpusStream",
    "scheduled_order",
    "Tokenizer",
]
