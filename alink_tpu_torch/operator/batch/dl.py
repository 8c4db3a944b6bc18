"""DL train and predict operators: KerasSequential and BERT text
classify/regress (port of ``alink_tpu/operator/batch/dl.py``).

A KerasSequential model table is the reference's: meta (``layers``,
``outDim``, ``labels``, ``dim``, …) plus the flax variables (``params``, and
``batch_stats`` with a BatchNorm) as flax msgpack bytes, carried by
:func:`~alink_tpu_torch.dl.convert.keras_torch_to_flax`; so each package
serves a KerasSequential model the other trained.

A BERT model table — meta (``bertConfig``, vocab, labels, …) plus the flax
parameter tree as ``flax.serialization.to_bytes`` bytes — is the one that
``alink_tpu``'s ``BertText*TrainBatchOp`` writes, and the port's train
operators write the same table (the weights carried into the flax layout by
:func:`~alink_tpu_torch.dl.convert.torch_to_flax`, encoded with
:mod:`~alink_tpu_torch.common.flax_msgpack`), so each package serves a model
the other trained. The mapper carries the weights into the torch encoder
and computes in bf16, as the reference mapper does, under the stamped
``inferencePrecision`` (fp32, bf16 or int8, see
:func:`~alink_tpu_torch.dl.train.predict_model`). Training runs on the
session's device (``self.env.device``). Not ported yet: ``seqShards > 1``
(ring attention, ROADMAP A3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...common import flax_msgpack
from ...common.env import resolve_device
from ...common.exceptions import (AkIllegalArgumentException,
                                  AkUnsupportedOperationException)
from ...common.linalg import DenseVector
from ...common.metrics import metrics
from ...common.model import decode_once, model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable
from ...common.params import InValidator, MinValidator, ParamInfo
from ...common.quant import PRECISION_KEY
from ...mapper import (HasFeatureCols, HasPredictionCol,
                       HasPredictionDetailCol, HasReservedCols, HasVectorCol,
                       RichModelMapper, detail_json, get_feature_block,
                       merge_feature_params, np_labels, resolve_feature_cols,
                       softmax_np)
from .base import BatchOperator
from .utils import ModelMapBatchOp, ModelTrainOpMixin


def params_from_bytes(buf: np.ndarray) -> dict:
    """The model table's ``params`` entry (uint8 array of flax msgpack bytes)
    as a nested dict of numpy arrays."""
    return flax_msgpack.loads(np.asarray(buf, np.uint8).tobytes())


def params_to_bytes(tree: dict) -> np.ndarray:
    """The inverse of :func:`params_from_bytes`: bytes flax reads back."""
    return np.frombuffer(flax_msgpack.dumps(tree), dtype=np.uint8).copy()


class HasDLTrainParams:
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=10, validator=MinValidator(1))
    BATCH_SIZE = ParamInfo("batchSize", int, default=32, validator=MinValidator(1))
    LEARNING_RATE = ParamInfo("learningRate", float, default=1e-3)
    VALIDATION_SPLIT = ParamInfo("validationSplit", float, default=0.0)
    EARLY_STOPPING_PATIENCE = ParamInfo("earlyStoppingPatience", int, default=0)
    RANDOM_SEED = ParamInfo("randomSeed", int, default=0)


# ---------------------------------------------------------------------------
# KerasSequential
# ---------------------------------------------------------------------------


class BaseKerasSequentialTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                      HasDLTrainParams,
                                      HasFeatureCols, HasVectorCol):
    """(reference: common/dl/BaseKerasSequentialTrainBatchOp.java:82)"""

    LAYERS = ParamInfo("layers", list, optional=False,
                       desc='e.g. ["Dense(64)", "Relu()", "Dropout(0.1)"]')
    LABEL_COL = ParamInfo("labelCol", str, optional=False)

    _min_inputs = 1
    _max_inputs = 1

    _regression = False

    def _static_meta_keys(self, in_schema):
        return {
            "regression": self._regression,
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _execute_impl(self, t: MTable) -> MTable:
        from ...dl.convert import keras_torch_to_flax
        from ...dl.modules import KerasSequential
        from ...dl.train import TrainConfig, train_model

        label_col = self.get(self.LABEL_COL)
        vec_col = self.get(HasVectorCol.VECTOR_COL)
        feature_cols = (
            None if vec_col else resolve_feature_cols(t, self,
                                                      exclude=[label_col])
        )
        X = get_feature_block(t, self, exclude=[label_col]).astype(np.float32)
        y_raw = t.col(label_col)

        if self._regression:
            y = np.asarray(y_raw, np.float32)
            labels, out_dim = None, 1
        else:
            labels = sorted(set(np.asarray(y_raw).tolist()), key=str)
            lab_to_idx = {v: i for i, v in enumerate(labels)}
            y = np.asarray([lab_to_idx[v] for v in y_raw], np.int32)
            out_dim = len(labels)

        model = KerasSequential(tuple(self.get(self.LAYERS)), out_dim=out_dim,
                                in_shape=X.shape[1])
        cfg = TrainConfig(
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            eval_ratio=self.get(self.VALIDATION_SPLIT),
            early_stopping_patience=self.get(self.EARLY_STOPPING_PATIENCE),
            seed=self.get(self.RANDOM_SEED),
        )
        state, history = train_model(model, {"x": X}, y, cfg,
                                     regression=self._regression,
                                     device=self.env.device)
        meta = {
            "modelName": "KerasSequentialModel",
            "layers": list(self.get(self.LAYERS)),
            "outDim": out_dim,
            "regression": self._regression,
            "vectorCol": vec_col,
            "featureCols": feature_cols,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "dim": int(X.shape[1]),
            "finalLoss": history.get("final_loss"),
        }
        return model_to_table(
            meta, {"params": params_to_bytes(keras_torch_to_flax(state))})


class KerasSequentialClassifierTrainBatchOp(BaseKerasSequentialTrainBatchOp):
    _regression = False


class KerasSequentialRegressorTrainBatchOp(BaseKerasSequentialTrainBatchOp):
    _regression = True


class KerasSequentialModelMapper(RichModelMapper, HasFeatureCols,
                                 HasVectorCol):
    def load_model(self, model: MTable):
        from ...dl.convert import keras_flax_to_torch
        from ...dl.modules import KerasSequential

        self.meta, arrays = table_to_model(model)
        self.model = KerasSequential(
            tuple(self.meta["layers"]), out_dim=int(self.meta["outDim"]),
            in_shape=int(self.meta["dim"]))
        self.model.load_state_dict(
            keras_flax_to_torch(params_from_bytes(arrays["params"])))
        self.model.to(resolve_device(self.device)).eval()
        return self

    def _pred_type(self) -> str:
        if self.meta["regression"]:
            return AlinkTypes.DOUBLE
        return self.meta.get("labelType", AlinkTypes.STRING)

    def predict_block(self, t: MTable):
        from ...dl.train import predict_model

        meta = self.meta
        p = merge_feature_params(self.get_params(), meta)
        X = get_feature_block(t, p, vector_size=meta["dim"]).astype(np.float32)
        logits = predict_model(self.model, {"x": X}, device=self.device)
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


class KerasSequentialClassifierPredictBatchOp(ModelMapBatchOp,
                                              HasPredictionCol,
                                              HasPredictionDetailCol,
                                              HasReservedCols):
    mapper_cls = KerasSequentialModelMapper


class KerasSequentialRegressorPredictBatchOp(ModelMapBatchOp,
                                             HasPredictionCol,
                                             HasReservedCols):
    mapper_cls = KerasSequentialModelMapper


# ---------------------------------------------------------------------------
# BERT text classifier / regressor
# ---------------------------------------------------------------------------


class BaseBertTextTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                               HasDLTrainParams):
    """(reference: common/dl/BaseEasyTransferTrainBatchOp.java; params
    params/tensorflow/bert/*)"""

    TEXT_COL = ParamInfo("textCol", str, optional=False)
    TEXT_PAIR_COL = ParamInfo("textPairCol", str)
    LABEL_COL = ParamInfo("labelCol", str, optional=False)
    MAX_SEQ_LENGTH = ParamInfo("maxSeqLength", int, default=128)
    VOCAB_SIZE = ParamInfo("vocabSize", int, default=8000)
    HIDDEN_SIZE = ParamInfo("hiddenSize", int, default=256)
    NUM_LAYERS = ParamInfo("numLayers", int, default=4)
    NUM_HEADS = ParamInfo("numHeads", int, default=4)
    INTERMEDIATE_SIZE = ParamInfo("intermediateSize", int, default=1024)
    BERT_SIZE = ParamInfo(
        "bertSize", str, default="custom",
        desc="custom (use hidden/layers params) | base | tiny",
    )
    SEQ_SHARDS = ParamInfo("seqShards", int, default=1,
                           desc="sequence-parallel shards (ring attention)")
    ATTENTION_BLOCK_SIZE = ParamInfo(
        "attentionBlockSize", int, default=0, validator=MinValidator(0),
        desc="0 = full attention; >0 = blockwise attention with this K/V "
             "block (the flash kernel's route)")
    BERT_MODEL_NAME = ParamInfo(
        "bertModelName", str,
        desc="pretrained model resolved from the plugin dir, e.g. "
             "'base-uncased' (see dl.pretrained.MODEL_NAME_DIRS)")
    CHECKPOINT_FILE_PATH = ParamInfo(
        "checkpointFilePath", str,
        desc="explicit pretrained checkpoint directory (HF layout); "
             "overrides bertModelName")
    POOLING_STRATEGY = ParamInfo(
        "poolingStrategy", str, default="auto",
        validator=InValidator("auto", "cls", "mean"),
        desc="auto | cls | mean — auto uses cls for pretrained checkpoints "
             "and mean for from-scratch models")

    _min_inputs = 1
    _max_inputs = 1

    _regression = False

    def _static_meta_keys(self, in_schema):
        return {
            "regression": self._regression,
            "labelType": in_schema.type_of(self.get(self.LABEL_COL)),
        }

    def _resolve_pooling(self, pretrained: bool) -> str:
        pool = self.get(self.POOLING_STRATEGY)
        if pool == "auto":
            return "cls" if pretrained else "mean"
        return pool

    def _bert_config(self, vocab_size: int, num_labels: int):
        from ...dl.modules import BertConfig

        size = self.get(self.BERT_SIZE)
        common = dict(
            vocab_size=vocab_size,
            max_position=self.get(self.MAX_SEQ_LENGTH),
            num_labels=num_labels,
            regression=self._regression,
            pool=self._resolve_pooling(pretrained=False),
            attention_block_size=self.get(self.ATTENTION_BLOCK_SIZE),
        )
        if size == "base":
            return BertConfig.base(**common)
        if size == "tiny":
            return BertConfig.tiny(**common)
        return BertConfig(
            hidden_size=self.get(self.HIDDEN_SIZE),
            num_layers=self.get(self.NUM_LAYERS),
            num_heads=self.get(self.NUM_HEADS),
            intermediate_size=self.get(self.INTERMEDIATE_SIZE),
            **common,
        )

    def _resolve_pretrained(self):
        """Checkpoint dir from checkpointFilePath / bertModelName, or None."""
        path = self.get(self.CHECKPOINT_FILE_PATH)
        if path:
            return path
        name = self.get(self.BERT_MODEL_NAME)
        if not name:
            return None
        from ...dl.pretrained import resolve_bert_resource

        return resolve_bert_resource(name)

    def _execute_impl(self, t: MTable) -> MTable:
        from ...dl.convert import torch_to_flax
        from ...dl.modules import BertConfig, TransformerEncoder
        from ...dl.tokenizer import Tokenizer
        from ...dl.train import TrainConfig, train_model

        if self.get(self.SEQ_SHARDS) > 1:
            raise AkUnsupportedOperationException(
                "seqShards > 1 (ring attention over a device group) is not "
                "ported yet (ROADMAP A3)")
        device = self.env.device
        text_col = self.get(self.TEXT_COL)
        pair_col = self.get(self.TEXT_PAIR_COL)
        label_col = self.get(self.LABEL_COL)
        max_len = self.get(self.MAX_SEQ_LENGTH)

        texts = [str(v) for v in t.col(text_col)]
        pairs = [str(v) for v in t.col(pair_col)] if pair_col else None

        y_raw = t.col(label_col)
        if self._regression:
            y = np.asarray(y_raw, np.float32)
            labels, num_labels = None, 1
        else:
            labels = sorted(set(np.asarray(y_raw).tolist()), key=str)
            lab_to_idx = {v: i for i, v in enumerate(labels)}
            y = np.asarray([lab_to_idx[v] for v in y_raw], np.int32)
            num_labels = len(labels)

        pre_dir = self._resolve_pretrained()
        pre_subtree = None
        if pre_dir:
            from ...dl.pretrained import load_bert_checkpoint, load_vocab_file

            ckpt_cfg, pre_subtree = load_bert_checkpoint(pre_dir)
            do_lower = ckpt_cfg.pop("do_lower_case", True)
            vocab_list = load_vocab_file(pre_dir)
            if len(vocab_list) != ckpt_cfg["vocab_size"]:
                raise AkIllegalArgumentException(
                    f"vocab.txt has {len(vocab_list)} entries but the "
                    f"checkpoint config says vocab_size="
                    f"{ckpt_cfg['vocab_size']} ({pre_dir})")
            tok = Tokenizer.from_list(vocab_list, do_lower)
            if max_len > ckpt_cfg["max_position"]:
                raise AkIllegalArgumentException(
                    f"maxSeqLength={max_len} exceeds the pretrained "
                    f"checkpoint's max_position={ckpt_cfg['max_position']}")
            cfg = BertConfig(
                num_labels=num_labels, regression=self._regression,
                pool=self._resolve_pooling(pretrained=True), dropout=0.1,
                attention_block_size=self.get(self.ATTENTION_BLOCK_SIZE),
                **ckpt_cfg)
        else:
            tok = Tokenizer.build(
                texts + (pairs or []), vocab_size=self.get(self.VOCAB_SIZE))
            cfg = self._bert_config(tok.vocab_size, num_labels)
        enc = tok.encode_batch(texts, pairs, max_len=max_len)
        model = TransformerEncoder(cfg)
        tc = TrainConfig(
            num_epochs=self.get(self.NUM_EPOCHS),
            batch_size=self.get(self.BATCH_SIZE),
            learning_rate=self.get(self.LEARNING_RATE),
            eval_ratio=self.get(self.VALIDATION_SPLIT),
            early_stopping_patience=self.get(self.EARLY_STOPPING_PATIENCE),
            seed=self.get(self.RANDOM_SEED),
            weight_decay=0.01,
        )
        init_params = None
        if pre_subtree is not None:
            from ...dl.pretrained import init_from_pretrained

            init_params = init_from_pretrained(
                model, cfg, pre_subtree, seed=self.get(self.RANDOM_SEED))
        state, history = train_model(
            model, enc, y, tc, regression=self._regression,
            init_params=init_params, device=device)

        cfg_dict = {k: v for k, v in dataclasses.asdict(cfg).items()
                    if k != "dtype"}
        meta = {
            "modelName": "BertTextModel",
            "bertConfig": cfg_dict,
            "textCol": text_col,
            "textPairCol": pair_col,
            "labelCol": label_col,
            "labelType": t.schema.type_of(label_col),
            "labels": labels,
            "regression": self._regression,
            "maxSeqLength": max_len,
            "vocab": tok.to_list(),
            "doLowerCase": tok.do_lower_case,
            "pretrainedFrom": pre_dir,
            "finalLoss": history.get("final_loss"),
        }
        return model_to_table(
            meta, {"params": params_to_bytes(torch_to_flax(state, cfg))})


class BertTextClassifierTrainBatchOp(BaseBertTextTrainBatchOp):
    _regression = False


class BertTextRegressorTrainBatchOp(BaseBertTextTrainBatchOp):
    _regression = True


class BertTextPairClassifierTrainBatchOp(BaseBertTextTrainBatchOp):
    _regression = False
    TEXT_PAIR_COL = ParamInfo("textPairCol", str, optional=False)


class BertTextModelMapper(RichModelMapper):
    TEXT_COL = ParamInfo("textCol", str)
    TEXT_PAIR_COL = ParamInfo("textPairCol", str)
    # int8 serving quantizes the encoder's weights only (``served_state``)
    # and reads no activation scale, so a calibration predict records no
    # range here; ``ModelServer`` gates such a load on its band alone
    INT8_WEIGHT_ONLY = True

    def load_model(self, model: MTable):
        from ...dl.convert import flax_to_torch
        from ...dl.modules import BertConfig, TransformerEncoder
        from ...dl.tokenizer import Tokenizer

        device = resolve_device(self.device)

        def decode():
            metrics.incr("dl.model_decodes")
            meta, arrays = table_to_model(model)
            cfg = BertConfig(dtype=torch.bfloat16, **meta["bertConfig"])
            encoder = TransformerEncoder(cfg)
            encoder.load_state_dict(
                flax_to_torch(params_from_bytes(arrays["params"])))
            encoder.to(device).eval()
            # models serialized before the BERT-spec tokenizer carry no
            # doLowerCase key; serve them with the legacy \w+ tokenization
            # their vocab was built with
            tokenizer = Tokenizer.from_list(
                meta["vocab"], meta.get("doLowerCase", True),
                legacy="doLowerCase" not in meta)
            return meta, cfg, encoder, tokenizer

        # one decode per model table and device, shared by every mapper that
        # loads it (the encoder serves read-only; quantized states are kept
        # on it per policy)
        self.meta, self.cfg, self.model, self.tokenizer = decode_once(
            model, ("bert", str(device)), decode)
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


# ---------------------------------------------------------------------------
# BERT embedding and the text-pair serving names (the reference's io2.py)
# ---------------------------------------------------------------------------


class BertTextEmbeddingMapper(BertTextModelMapper):
    """Pooled encoder output as the embedding vector (reference:
    operator/batch/classification/BertTextEmbeddingBatchOp.java; any model
    the BertText trainers wrote serves, its pre-head pooled states)."""

    def output_schema(self, input_schema):
        return self._append_result_schema(
            input_schema, ["embedding"], [AlinkTypes.DENSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from ...dl.train import predict_model

        meta = self.meta
        text_col = self.get(self.TEXT_COL) or meta["textCol"]
        texts = [str(v) for v in t.col(text_col)]
        enc = self.tokenizer.encode_batch(
            texts, None, max_len=int(meta["maxSeqLength"]))
        pooled = predict_model(self.model, enc, device=self.device,
                               precision=self._precision, return_pooled=True)
        out = "embedding"
        vecs = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            vecs[i] = DenseVector(pooled[i].astype(np.float64))
        return self._append_result(
            t, {out: vecs}, {out: AlinkTypes.DENSE_VECTOR})


class BertTextEmbeddingBatchOp(ModelMapBatchOp, HasReservedCols):
    """(reference: operator/batch/classification/
    BertTextEmbeddingBatchOp.java)"""

    mapper_cls = BertTextEmbeddingMapper


class BertTextPairClassifierPredictBatchOp(BertTextClassifierPredictBatchOp):
    """(reference: operator/batch/classification/
    BertTextPairClassifierPredictBatchOp.java — the shared mapper reads
    textPairCol from the model meta)."""


class BertTextPairRegressorTrainBatchOp(BertTextRegressorTrainBatchOp):
    """(reference: operator/batch/regression/
    BertTextPairRegressorTrainBatchOp.java)"""

    TEXT_PAIR_COL = BertTextPairClassifierTrainBatchOp.TEXT_PAIR_COL


class BertTextPairRegressorPredictBatchOp(BertTextRegressorPredictBatchOp):
    """(reference: operator/batch/regression/
    BertTextPairRegressorPredictBatchOp.java)"""
