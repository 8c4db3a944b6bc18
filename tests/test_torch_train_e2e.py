"""The training slice end to end: ``alink_tpu_torch``'s BERT train operators
against ``alink_tpu``'s recipes and models on the CPU.

- a checkpoint that ``alink_tpu`` pretrained and saved is fine-tuned by the
  port's operator (the recipe of tests/test_pretrained_bert.py), and beats
  training from scratch;
- the reference's long-document recipe (tests/test_dl.py, blockwise
  attention over 768 tokens) trains in the port through the flash route's
  gradient;
- a model table the port trained is served by ``alink_tpu``'s mapper with
  the port's own labels (where the margin exceeds the bf16 tolerance);
- the sst2_mini holdout accuracy of both packages at chip_smoke.py's phase
  10.4 settings: the reference's is the floor chip_smoke.py cites.

Accuracy floors are the reference tests' own (0.9, scratch + 0.1); served
probabilities within 0.02, the bf16 serving tolerance of
tests/test_torch_bert_serving.py.
"""

import numpy as np
import pytest

import chip_smoke

PROB_ATOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALINK_TORCH_DEVICE", "cpu")
        mp.delenv("ALINK_ATTN_PALLAS", raising=False)
        yield


def _sentiment_corpus(n, seed):
    """The tiny synthetic sentiment task of tests/test_pretrained_bert.py."""
    rng = np.random.default_rng(seed)
    pos = ["great", "good", "wonderful", "excellent", "happy", "love"]
    neg = ["awful", "bad", "terrible", "horrid", "sad", "hate"]
    filler = ["the", "movie", "was", "very", "plot", "acting", "film",
              "really", "quite", "so"]
    texts, labels = [], []
    for _ in range(n):
        y = int(rng.integers(2))
        words = list(rng.choice(filler, 4)) + list(
            rng.choice(pos if y else neg, 2))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(y)
    return texts, labels


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """alink_tpu pretrains a tiny encoder and saves it as an HF checkpoint;
    the port fine-tunes it through ``BertTextClassifierTrainBatchOp`` with
    ``checkpointFilePath``, and from scratch, under the same tiny budget."""
    import jax.numpy as jnp

    from alink_tpu.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu.dl.pretrained import save_bert_checkpoint
    from alink_tpu.dl.tokenizer import Tokenizer
    from alink_tpu.dl.train import TrainConfig, train_model
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (
        BertTextClassifierPredictBatchOp, BertTextClassifierTrainBatchOp,
        TableSourceBatchOp)

    texts, labels = _sentiment_corpus(400, seed=0)
    tok = Tokenizer.build(texts, vocab_size=256)
    enc = tok.encode_batch(texts, max_len=16)
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size, max_position=16,
                          num_labels=2, pool="cls", dtype=jnp.float32)
    params, _ = train_model(TransformerEncoder(cfg), enc,
                            np.asarray(labels, np.int32),
                            TrainConfig(num_epochs=12, batch_size=64,
                                        learning_rate=3e-4, seed=0))
    ckpt = str(tmp_path_factory.mktemp("pretrained"))
    save_bert_checkpoint(params, cfg, ckpt, tok.to_list())

    ft_texts, ft_labels = _sentiment_corpus(48, seed=1)
    ev_texts, ev_labels = _sentiment_corpus(200, seed=2)
    train_tbl = TableSourceBatchOp(
        MTable({"text": ft_texts, "label": np.asarray(ft_labels, np.int64)}))
    eval_tbl = TableSourceBatchOp(
        MTable({"text": ev_texts, "label": np.asarray(ev_labels, np.int64)}))

    def run(**extra):
        model = BertTextClassifierTrainBatchOp(
            textCol="text", labelCol="label", maxSeqLength=16, numEpochs=2,
            batchSize=16, learningRate=3e-4, randomSeed=0, **extra
        ).link_from(train_tbl).collect()
        pred = BertTextClassifierPredictBatchOp(
            predictionCol="pred", predictionDetailCol="detail").link_from(
            TableSourceBatchOp(model), eval_tbl).collect()
        acc = float((np.asarray(pred.col("pred"))
                     == np.asarray(ev_labels)).mean())
        return acc, model, pred

    acc_pre, model, pred = run(checkpointFilePath=ckpt)
    acc_scratch, _, _ = run(bertSize="tiny", vocabSize=256)
    return dict(ckpt=ckpt, acc_pre=acc_pre, acc_scratch=acc_scratch,
                model=model, pred=pred, ev_texts=ev_texts,
                ev_labels=ev_labels)


def test_finetune_from_reference_checkpoint_beats_scratch(finetuned):
    from alink_tpu_torch.common.model import table_to_model

    assert finetuned["acc_pre"] >= 0.9, finetuned["acc_pre"]
    assert finetuned["acc_pre"] > finetuned["acc_scratch"] + 0.1, (
        finetuned["acc_pre"], finetuned["acc_scratch"])
    meta, _ = table_to_model(finetuned["model"])
    assert meta["pretrainedFrom"] == finetuned["ckpt"]
    assert meta["bertConfig"]["pool"] == "cls"


def test_port_trained_model_served_by_reference(finetuned, tmp_path):
    """The port's model table, through .ak, in alink_tpu's
    BertTextModelMapper: probabilities within PROB_ATOL of the port's own
    serving (both compute in bf16) and the same labels wherever the
    reference's margin exceeds that tolerance."""
    import json

    from alink_tpu.common.mtable import MTable as RefMTable
    from alink_tpu.operator.batch import AkSourceBatchOp as RefAkSource
    from alink_tpu.operator.batch import (
        BertTextClassifierPredictBatchOp as RefPredict)
    from alink_tpu.operator.batch import TableSourceBatchOp as RefSource
    from alink_tpu_torch.operator.batch import (AkSinkBatchOp,
                                                TableSourceBatchOp)

    path = str(tmp_path / "port_model.ak")
    AkSinkBatchOp(filePath=path, overwriteSink=True).link_from(
        TableSourceBatchOp(finetuned["model"])).collect()
    data = RefMTable({"text": finetuned["ev_texts"],
                      "label": np.asarray(finetuned["ev_labels"], np.int64)})
    ref = RefPredict(predictionCol="pred", predictionDetailCol="detail") \
        .link_from(RefAkSource(filePath=path), RefSource(data)).collect()

    def probs(table):
        return np.asarray([[json.loads(d)[k] for k in ("0", "1")]
                           for d in table.col("detail")])

    got, want = probs(finetuned["pred"]), probs(ref)
    assert float(np.abs(got - want).max()) <= PROB_ATOL
    # labels agree wherever the reference's margin exceeds the tolerance
    sure = np.abs(want[:, 1] - want[:, 0]) > PROB_ATOL
    assert sure.mean() > 0.9
    assert np.array_equal(np.asarray(finetuned["pred"].col("pred"))[sure],
                          np.asarray(ref.col("pred"))[sure])


def test_long_document_blockwise_recipe_trains():
    """tests/test_dl.py's long-document recipe (768 tokens, blocks of 128)
    through the port's operator: the flash route's gradient trains it."""
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (
        BertTextClassifierPredictBatchOp, BertTextClassifierTrainBatchOp,
        TableSourceBatchOp)

    rng = np.random.default_rng(0)
    texts, labels = [], []
    for i in range(32):
        y = i % 2
        word = "good" if y else "bad"
        words = ["the"] * 450 + [word] * 150
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(y)
    src = TableSourceBatchOp(MTable({"text": texts,
                                     "label": np.asarray(labels, np.int64)}))
    m = BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label", maxSeqLength=768,
        vocabSize=64, hiddenSize=32, numLayers=1, numHeads=2,
        intermediateSize=64, attentionBlockSize=128,
        numEpochs=12, batchSize=8, learningRate=3e-3,
    ).link_from(src)
    pred = BertTextClassifierPredictBatchOp(
        predictionCol="p").link_from(m, src).collect()
    acc = float((np.asarray(pred.col("p")) == np.asarray(labels)).mean())
    assert acc >= 0.9, acc


def _sst2_accuracy(pkg):
    """``BertTextClassifierTrainBatchOp`` from data/bert_tiny_sst at
    chip_smoke.SST2's settings on sst2_split(seed=0), holdout accuracy."""
    import importlib

    mt = importlib.import_module(f"{pkg}.common.mtable")
    data = importlib.import_module(f"{pkg}.dl.data")
    ops = importlib.import_module(f"{pkg}.operator.batch.dl")
    base = importlib.import_module(f"{pkg}.operator.batch.base")
    tr_t, tr_y, ho_t, ho_y = data.sst2_split(seed=0)
    model = ops.BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label",
        checkpointFilePath=data.data_path("bert_tiny_sst"), **chip_smoke.SST2
    ).link_from(base.TableSourceBatchOp(mt.MTable({"text": tr_t,
                                                   "label": tr_y})))
    pred = ops.BertTextClassifierPredictBatchOp(predictionCol="p").link_from(
        model, base.TableSourceBatchOp(mt.MTable({"text": ho_t,
                                                  "label": ho_y}))).collect()
    return float((np.asarray(pred.col("p")) == ho_y).mean())


def test_sst2_holdout_accuracy_of_both_packages():
    """The reference's accuracy is the one chip_smoke.py records
    (SST2_REFERENCE_ACC, its phase-10.4 floor less 0.05); the port's, from
    other dropout draws, reaches that floor too."""
    ref = _sst2_accuracy("alink_tpu")
    got = _sst2_accuracy("alink_tpu_torch")
    print(f"sst2_mini holdout accuracy at {chip_smoke.SST2}: alink_tpu "
          f"{ref:.4f}, alink_tpu_torch {got:.4f}")
    assert round(ref, 4) == chip_smoke.SST2_REFERENCE_ACC
    assert got >= chip_smoke.SST2_FLOOR
