"""The training and stream metrics of the port: ``train_model`` and
``pretrain_mlm`` emit what the reference's training loop emits
(``tests/test_corpus_scale.py``'s observability test, without its
pre-flight part), and the stream layer observes its histograms and span.

- histograms ``train.step_s``, ``train.feed_wait_s``,
  ``train.accum_flush_s``; counters ``train.steps``, ``train.micro_steps``,
  ``train.rows``, ``train.ckpt_saves``; one ``train.epoch`` span an epoch;
- ``history["feed"]`` in the reference's shape under the async feed;
- the Prometheus families, and ``job_report()["train"]``;
- ``stream_map``'s ``stream.transfer_s``/``wait_s``/``compute_s``, and a
  stream ``collect``'s ``stream.collect`` span and ``stream.chunk_s``.

Counters and histograms are process-wide, so the test reads deltas.
"""

import numpy as np
import pytest
import torch

_HISTS = ("train.step_s", "train.feed_wait_s", "train.accum_flush_s",
          "stream.transfer_s", "stream.wait_s", "stream.compute_s",
          "stream.chunk_s")
_COUNTERS = ("train.steps", "train.micro_steps", "train.rows",
             "train.ckpt_saves")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ALINK_TRACING", "on")


def _counts(metrics):
    return ({h: (metrics.histogram(h) or {"count": 0})["count"]
             for h in _HISTS},
            {c: metrics.counter(c) for c in _COUNTERS})


def _epoch_spans(tracer, trace_id):
    return [s for s in tracer.spans(trace_id) if s["name"] == "train.epoch"]


def test_training_emits_the_reference_metrics_and_spans(tmp_path):
    from alink_tpu_torch.common.metrics import export_prometheus, metrics
    from alink_tpu_torch.common.tracing import (job_report, trace_span,
                                                tracer)
    from alink_tpu_torch.dl.data import load_reviews
    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder
    from alink_tpu_torch.dl.pretrain import pretrain_mlm
    from alink_tpu_torch.dl.train import TrainConfig, train_model

    h0, c0 = _counts(metrics)
    g = np.random.default_rng(0)
    inputs = {"input_ids": g.integers(5, 64, (40, 12)).astype(np.int32)}
    y = (inputs["input_ids"][:, 0] % 2).astype(np.int32)
    model = TransformerEncoder(BertConfig.tiny(
        dtype=torch.float32, vocab_size=64, max_position=12))
    with trace_span("test.train_job"):
        _, hist = train_model(model, inputs, y, TrainConfig(
            num_epochs=2, batch_size=16, accum_steps=2,
            checkpoint_dir=str(tmp_path / "t")))
    h1, c1 = _counts(metrics)
    # 40 rows in batches of 16: 3 steps an epoch (the last of 8 rows), two
    # chunks a step; one checkpoint an epoch
    assert c1["train.steps"] - c0["train.steps"] == 6
    assert c1["train.micro_steps"] - c0["train.micro_steps"] == 12
    assert c1["train.rows"] - c0["train.rows"] == 80
    assert c1["train.ckpt_saves"] - c0["train.ckpt_saves"] == 2
    assert h1["train.step_s"] - h0["train.step_s"] == 6
    assert h1["train.accum_flush_s"] - h0["train.accum_flush_s"] == 6
    assert h1["train.feed_wait_s"] - h0["train.feed_wait_s"] == 12
    # the async feed runs through stream_map: one transfer per feed item
    assert h1["stream.transfer_s"] - h0["stream.transfer_s"] == 12
    assert h1["stream.wait_s"] - h0["stream.wait_s"] == 12
    assert h1["stream.compute_s"] - h0["stream.compute_s"] == 12
    assert set(hist["feed"]) == {"mode", "transfer_s", "batches"}
    assert hist["feed"]["mode"] == "async" and hist["feed"]["batches"] == 12
    spans = _epoch_spans(tracer, tracer.last_trace_id())
    assert [s["attrs"]["epoch"] for s in spans] == [0, 1]
    assert all(s["outcome"] == "ok" for s in spans)
    rec = metrics.last("dl.train")
    assert rec["step"] == 6 and rec["samples_per_sec"] > 0

    texts = load_reviews(limit=64)
    with trace_span("test.pretrain_job"):
        pretrain_mlm(texts, vocab_size=200, hidden_size=16, num_layers=1,
                     num_heads=2, intermediate_size=32, max_len=16,
                     epochs=2, batch_size=16, accum_steps=2,
                     checkpoint_dir=str(tmp_path / "p"))
    h2, c2 = _counts(metrics)
    assert c2["train.steps"] - c1["train.steps"] == 8
    assert c2["train.micro_steps"] - c1["train.micro_steps"] == 16
    assert c2["train.rows"] - c1["train.rows"] == 128
    assert c2["train.ckpt_saves"] - c1["train.ckpt_saves"] == 2
    for name, n in (("train.step_s", 8), ("train.accum_flush_s", 8),
                    ("train.feed_wait_s", 16), ("stream.transfer_s", 16)):
        assert h2[name] - h1[name] == n, name
    assert len(_epoch_spans(tracer, tracer.last_trace_id())) == 2

    text = export_prometheus()
    for fam in ("alink_train_step_seconds", "alink_train_feed_wait_seconds",
                "alink_train_accum_flush_seconds", "alink_train_steps_total",
                "alink_train_micro_steps_total", "alink_train_rows_total",
                "alink_train_ckpt_saves_total", "alink_stream_transfer_seconds",
                "alink_stream_wait_seconds", "alink_stream_compute_seconds"):
        assert f"# TYPE {fam} " in text, fam
    tr = job_report()["train"]
    assert tr["step_s"]["count"] == h2["train.step_s"]
    assert {"feed_wait_s", "accum_flush_s"} <= set(tr)
    assert tr["counters"]["train.steps"] == c2["train.steps"]


def test_stream_collect_opens_its_span_and_times_chunks():
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.common.tracing import tracer
    from alink_tpu_torch.operator.stream.base import (StreamOperator,
                                                      TableSourceStreamOp,
                                                      _FuncStreamOp)

    n0 = (metrics.histogram("stream.chunk_s") or {"count": 0})["count"]
    src = TableSourceStreamOp(MTable({"x": np.arange(10.0)}), chunkSize=3)
    out = _FuncStreamOp(lambda t: t).link_from(src).collect()
    assert out.num_rows == 10
    assert metrics.histogram("stream.chunk_s")["count"] - n0 == 4
    sp = [s for s in tracer.spans(tracer.last_trace_id())
          if s["name"] == "stream.collect"][-1]
    assert sp["attrs"] == {"op": "_FuncStreamOp", "chunks": 4}
    assert sp["outcome"] == "ok"

    class Empty(StreamOperator):
        def _stream_impl(self):
            return iter(())

    from alink_tpu_torch.common.exceptions import AkIllegalStateException

    with pytest.raises(AkIllegalStateException):
        Empty().collect()
    sp = tracer.spans(tracer.last_trace_id())[-1]
    assert sp["name"] == "stream.collect" and sp["outcome"] == "failed"
