"""BERT text classify/regress prediction operators (port of the serving half
of ``alink_tpu/operator/batch/dl.py``).

A BERT model table — meta (``bertConfig``, vocab, labels, …) plus the flax
parameter tree as ``flax.serialization.to_bytes`` bytes — is the one that
``alink_tpu``'s ``BertText*TrainBatchOp`` writes. The mapper decodes those
bytes with :mod:`~alink_tpu_torch.common.flax_msgpack`, carries the weights
into the torch encoder (:mod:`~alink_tpu_torch.dl.convert`) and computes in
bf16, as the reference mapper does. The train operators and the
KerasSequential family are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ...common import flax_msgpack
from ...common.env import resolve_device
from ...common.model import table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import ParamInfo
from ...mapper import (HasPredictionCol, HasPredictionDetailCol,
                       HasReservedCols, RichModelMapper, detail_json,
                       np_labels, softmax_np)
from .utils import ModelMapBatchOp

PRECISION_KEY = "inferencePrecision"


def params_from_bytes(buf: np.ndarray) -> dict:
    """The model table's ``params`` entry (uint8 array of flax msgpack bytes)
    as a nested dict of numpy arrays."""
    return flax_msgpack.loads(np.asarray(buf, np.uint8).tobytes())


def params_to_bytes(tree: dict) -> np.ndarray:
    """The inverse of :func:`params_from_bytes`: bytes flax reads back."""
    return np.frombuffer(flax_msgpack.dumps(tree), dtype=np.uint8).copy()


class BertTextModelMapper(RichModelMapper):
    TEXT_COL = ParamInfo("textCol", str)
    TEXT_PAIR_COL = ParamInfo("textPairCol", str)

    def load_model(self, model: MTable):
        from ...dl.convert import flax_to_torch
        from ...dl.modules import BertConfig, TransformerEncoder
        from ...dl.tokenizer import Tokenizer

        self.meta, arrays = table_to_model(model)
        cfg = BertConfig(dtype=torch.bfloat16, **self.meta["bertConfig"])
        self.cfg = cfg
        self.model = TransformerEncoder(cfg)
        self.model.load_state_dict(
            flax_to_torch(params_from_bytes(arrays["params"])))
        self.model.to(resolve_device(self.device)).eval()
        # models serialized before the BERT-spec tokenizer carry no
        # doLowerCase key; serve them with the legacy \w+ tokenization their
        # vocab was built with
        self.tokenizer = Tokenizer.from_list(
            self.meta["vocab"], self.meta.get("doLowerCase", True),
            legacy="doLowerCase" not in self.meta)
        p = self.get_params()
        self._precision = p.get(PRECISION_KEY) if p.contains(PRECISION_KEY) \
            else None
        return self

    def _pred_type(self) -> str:
        if self.meta["regression"]:
            return AlinkTypes.DOUBLE
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_block(self, t: MTable):
        from ...dl.train import predict_model

        meta = self.meta
        text_col = self.get(self.TEXT_COL) or meta["textCol"]
        pair_col = self.get(self.TEXT_PAIR_COL) or meta.get("textPairCol")
        texts = [str(v) for v in t.col(text_col)]
        pairs = [str(v) for v in t.col(pair_col)] if pair_col else None
        enc = self.tokenizer.encode_batch(
            texts, pairs, max_len=int(meta["maxSeqLength"])
        )
        logits = predict_model(self.model, enc, device=self.device,
                               precision=self._precision)
        if meta["regression"]:
            return logits[:, 0].astype(np.float64), AlinkTypes.DOUBLE, None
        probs = softmax_np(logits)
        idx = probs.argmax(axis=1)
        labels = meta["labels"]
        pred = np_labels(labels, meta.get("labelType", AlinkTypes.STRING), idx)
        detail = None
        if self.get(HasPredictionDetailCol.PREDICTION_DETAIL_COL):
            detail = detail_json(labels, probs)
        return pred, self._pred_type(), detail


class BertTextClassifierPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                       HasPredictionDetailCol, HasReservedCols):
    mapper_cls = BertTextModelMapper


class BertTextRegressorPredictBatchOp(ModelMapBatchOp, HasPredictionCol,
                                      HasReservedCols):
    mapper_cls = BertTextModelMapper
