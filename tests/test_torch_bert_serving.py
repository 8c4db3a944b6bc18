"""The serving slice as a whole: a BERT text classifier trained and saved by
``alink_tpu`` is served by ``alink_tpu_torch`` through its operators.

``alink_tpu``'s ``BertTextClassifierTrainBatchOp`` trains ``bertSize="tiny"``
for one epoch with ``attentionBlockSize=16`` and ``maxSeqLength=32`` (so the
blockwise route, and with it the flash block update, is on the path), and its
model table goes to ``.ak`` through ``AkSinkBatchOp``. The port serves it with
``AkSourceBatchOp`` → ``BertTextClassifierPredictBatchOp`` → ``collect()``.

Both sides compute in bf16, which rounds at different points in the two
frameworks (fused vs. separate matmul epilogues, GELU and tanh evaluated in
fp32 then rounded, reduction order). ``PROB_ATOL`` = 0.02 is the stated
tolerance on class probabilities: the measured gap on these rows was 0.0022
(CPU, jax 0.9.0 against torch 2.13), and a bf16 ulp is up to 2**-7 relative,
so 0.02 leaves room for a few ulps through 2 layers and the fp32 softmax.
Labels must agree wherever the reference's probability margin exceeds that
tolerance.
"""

import json

import numpy as np
import pytest

PROB_ATOL = 0.02
N_ROWS = 96


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("ALINK_ATTN_PALLAS", raising=False)


def _rows():
    import csv
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "sst2_mini.csv")
    with open(path, newline="") as f:
        rows = [(t, int(y)) for t, y in csv.reader(f)]
    rng = np.random.default_rng(0)
    return [rows[i] for i in rng.permutation(len(rows))[:N_ROWS]]


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.batch import (AkSinkBatchOp,
                                          BertTextClassifierTrainBatchOp,
                                          TableSourceBatchOp)

    rows = _rows()
    table = MTable.from_rows(rows, "text string, label long")
    path = str(tmp_path_factory.mktemp("bert") / "model.ak")
    train = BertTextClassifierTrainBatchOp(
        textCol="text", labelCol="label", bertSize="tiny", maxSeqLength=32,
        attentionBlockSize=16, numEpochs=1, batchSize=32, vocabSize=400,
    ).link_from(TableSourceBatchOp(table))
    AkSinkBatchOp(filePath=path).link_from(train).collect()
    return path, rows


def _jax_predict(model_path, rows):
    from alink_tpu.common.mtable import MTable
    from alink_tpu.operator.batch import (AkSourceBatchOp,
                                          BertTextClassifierPredictBatchOp,
                                          TableSourceBatchOp)

    data = MTable.from_rows(rows, "text string, label long")
    return BertTextClassifierPredictBatchOp(
        predictionCol="pred", predictionDetailCol="detail").link_from(
        AkSourceBatchOp(filePath=model_path), TableSourceBatchOp(data)
    ).collect()


def _port_predict(model_path, rows):
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch import (AkSourceBatchOp,
                                                BertTextClassifierPredictBatchOp,
                                                TableSourceBatchOp)

    data = MTable.from_rows(rows, "text string, label long")
    return BertTextClassifierPredictBatchOp(
        predictionCol="pred", predictionDetailCol="detail").link_from(
        AkSourceBatchOp(filePath=model_path), TableSourceBatchOp(data)
    ).collect()


def _probs(table):
    return np.asarray([[d[k] for k in sorted(d)] for d in
                       (json.loads(s) for s in table.col("detail"))])


def test_port_serves_jax_trained_model(jax_model):
    from alink_tpu_torch.native import kernels

    path, rows = jax_model
    ref = _jax_predict(path, rows)
    kernels.reset_launches()
    got = _port_predict(path, rows)
    assert got.names == ref.names == ["text", "label", "pred", "detail"]
    assert list(got.col("text")) == [r[0] for r in rows]
    p_ref, p_got = _probs(ref), _probs(got)
    assert p_got.shape == (len(rows), 2) and np.isfinite(p_got).all()
    np.testing.assert_allclose(p_got, p_ref, atol=PROB_ATOL)
    margin = np.abs(p_ref[:, 1] - p_ref[:, 0])
    sure = margin > PROB_ATOL
    np.testing.assert_array_equal(np.asarray(got.col("pred"))[sure],
                                  np.asarray(ref.col("pred"))[sure])
    # on the CPU the wrapper runs its plain version: no kernel launches
    assert kernels.launches()["flash_block_update"] == 0


def test_port_written_model_reads_back_in_jax(jax_model, tmp_path):
    from alink_tpu_torch.common.model import model_to_table, table_to_model
    from alink_tpu_torch.dl.convert import flax_to_torch, torch_to_flax
    from alink_tpu_torch.dl.modules import BertConfig
    from alink_tpu_torch.io.ak import read_ak
    from alink_tpu_torch.operator.batch import (AkSinkBatchOp,
                                                TableSourceBatchOp)
    from alink_tpu_torch.operator.batch.dl import (params_from_bytes,
                                                   params_to_bytes)

    path, rows = jax_model
    meta, arrays = table_to_model(read_ak(path))
    cfg = BertConfig(**meta["bertConfig"])
    tree = torch_to_flax(flax_to_torch(params_from_bytes(arrays["params"])),
                         cfg)
    out = str(tmp_path / "port.ak")
    AkSinkBatchOp(filePath=out).link_from(
        TableSourceBatchOp(model_to_table(meta, {"params": params_to_bytes(tree)}))
    ).collect()
    ref = _jax_predict(path, rows[:16])
    again = _jax_predict(out, rows[:16])
    assert list(again.col("pred")) == list(ref.col("pred"))
    assert list(again.col("detail")) == list(ref.col("detail"))


def test_tokenizer_ids_identical_on_mixed_script_corpus():
    from alink_tpu.dl.tokenizer import Tokenizer as JaxTokenizer
    from alink_tpu_torch.dl.tokenizer import Tokenizer

    corpus = [
        "The café's crème brûlée was superb!",
        "Ünïcödé naïve façade — 東京タワー and 北京 in one line",
        "Привет, мир! Это тест токенизатора.",
        "مرحبا بالعالم 123 and emoji 😀 mixed",
        "email: a.b@c.de, url https://x.y/z?q=1 #tag",
        "ALL CAPS, lower, MiXeD, and numbers 3.14159 2e10",
        "  spaces\tand\nnewlines  ",
        "",
    ]
    for lower in (True, False):
        ref = JaxTokenizer.build(corpus, vocab_size=120)
        ref = JaxTokenizer.from_list(ref.to_list(), lower)
        port = Tokenizer.from_list(ref.to_list(), lower)
        a = ref.encode_batch(corpus, corpus[::-1], max_len=40)
        b = port.encode_batch(corpus, corpus[::-1], max_len=40)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert Tokenizer.build(corpus, vocab_size=120).to_list() == \
            JaxTokenizer.build(corpus, vocab_size=120).to_list()
