"""The port's observability and resilience layers (``common/metrics.py``,
``common/tracing.py``, ``common/resilience.py``), held against
``alink_tpu``'s: one seeded sequence of operations runs in both packages
and must give

- the same Prometheus text, and the same histogram quantiles;
- the same ``CircuitBreaker`` states under an injected clock;
- the same ``RetryPolicy`` delays from the same seed, and the same
  ``with_retries`` attempts;
- the same ``job_report`` and ``chrome_trace`` structure (ids and times
  aside).

Also the two repairs the serving tier rests on: ``predict_model`` pads
each chunk up the bucket ladder and trims (a 3-row request runs its
forward at 8 rows, and its trimmed logits equal the unpadded forward's),
and a ``LocalPredictor`` decodes its model once where the reference
reloads it every predict, with the same output rows.
"""

import importlib
import random
import threading

import numpy as np
import pytest

PKGS = ("alink_tpu", "alink_tpu_torch")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ALINK_TRACING", "on")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.common.{name}")


def _metric_ops(m, seed):
    """One seeded sequence of recorder operations on ``m`` (a fresh
    StepMetrics)."""
    rng = np.random.default_rng(seed)
    for i in range(200):
        op = rng.integers(0, 6)
        if op == 0:
            m.incr(f"serving.c{rng.integers(0, 3)}", int(rng.integers(1, 4)))
        elif op == 1:
            m.observe("serving.request_s", float(rng.lognormal(-6, 1.5)))
        elif op == 2:
            m.observe("serving.batch_rows", float(rng.integers(1, 65)),
                      buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        elif op == 3:
            m.set_gauge("fleet.replicas", float(rng.integers(0, 9)),
                        replica=f"r{rng.integers(0, 2)}")
        elif op == 4:
            m.add_time("train.step", float(rng.random()))
        else:
            m.record("bert.step", step=i, loss=float(rng.random()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_quantiles_match_reference(seed):
    out = {}
    for pkg in PKGS:
        m = _mod(pkg, "metrics").StepMetrics()
        _metric_ops(m, seed)
        out[pkg] = (m.export_prometheus(),
                    {h: m.histogram(h) for h in m.histogram_names()},
                    m.counters(), m.summary())
    ref, port = out["alink_tpu"], out["alink_tpu_torch"]
    assert port[0] == ref[0]
    assert "alink_serving_request_seconds_bucket" in port[0]
    assert port[1] == ref[1]
    for h in port[1].values():
        assert h["p50"] is not None and h["p99"] is not None
    assert port[2] == ref[2] and port[3] == ref[3]


def test_histogram_state_merge_matches_reference():
    states = {}
    for pkg in PKGS:
        H = _mod(pkg, "metrics")._Histogram
        a, b = H(), H()
        rng = np.random.default_rng(5)
        for v in rng.lognormal(-5, 2, 300):
            a.observe(v)
        for v in rng.lognormal(-3, 1, 100):
            b.observe(v)
        a.merge(H.from_state(b.state()))
        states[pkg] = (a.state(), a.stats(),
                       [a.quantile(q) for q in (0.1, 0.5, 0.9, 0.999)])
    assert states["alink_tpu_torch"] == states["alink_tpu"]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_walk(pkg, seed):
    """States of one breaker under a seeded sequence of successes,
    failures, probe releases and clock steps."""
    res = _mod(pkg, "resilience")
    exc = _mod(pkg, "exceptions")
    clock = _Clock()
    br = res.CircuitBreaker(failure_threshold=3, reset_timeout=5.0,
                            name="ep", clock=clock)
    rng = random.Random(seed)
    states = []
    for _ in range(120):
        op = rng.randrange(5)
        try:
            br.before_call()
            admitted = True
        except exc.AkCircuitOpenException:
            admitted = False
        if op == 0:
            br.record_success()
        elif op in (1, 2):
            br.record_failure()
        elif op == 3:
            br.release_probe()
        else:
            clock.t += rng.choice([0.5, 2.0, 6.0])
        states.append((admitted, br.is_open, br._failures, br._probing))
    return states


@pytest.mark.parametrize("seed", [0, 7])
def test_circuit_breaker_states_match_reference(seed):
    assert _breaker_walk("alink_tpu_torch", seed) == \
        _breaker_walk("alink_tpu", seed)


def test_breaker_registry_matches_reference():
    out = {}
    for pkg in PKGS:
        CB = _mod(pkg, "resilience").CircuitBreaker
        a = CB.for_endpoint("serving:x", failure_threshold=1)
        a.record_failure()
        b = CB.replace_endpoint("serving:x", failure_threshold=1)
        out[pkg] = (CB.for_endpoint("serving:x") is b, a.is_open, b.is_open,
                    CB.endpoint_states("serving:x"))
    assert out["alink_tpu_torch"] == out["alink_tpu"]
    assert out["alink_tpu"] == (True, True, False, {"serving:x": "closed"})


def _retry_run(pkg, seed):
    res = _mod(pkg, "resilience")
    exc = _mod(pkg, "exceptions")
    policy = res.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=1.0)
    delays = [policy.delay(k, random.Random(seed)) for k in range(8)]
    rng = random.Random(seed)
    seq = [policy.delay(k, rng) for k in range(8)]
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise exc.AkRetryableException("blip")
        return len(calls)

    res._rng.seed(seed)
    got = res.with_retries(flaky, policy, sleep=slept.append, name="t")

    def fatal():
        raise exc.AkIllegalArgumentException("bad")

    with pytest.raises(exc.AkIllegalArgumentException):
        res.with_retries(fatal, policy, sleep=slept.append)
    return delays, seq, got, slept, len(calls)


@pytest.mark.parametrize("seed", [0, 3])
def test_retry_policy_delays_match_reference(seed):
    port, ref = _retry_run("alink_tpu_torch", seed), _retry_run("alink_tpu",
                                                                seed)
    assert port == ref
    assert ref[2] == 4 and len(ref[3]) == 3


def _xla_error(status):
    """An exception classified as jaxlib's runtime error (the taxonomy
    matches the type by name), carrying ``status``."""
    return type("XlaRuntimeError", (RuntimeError,), {})(
        f"{status}: device event")


# (PyTorch device error, the reference's XLA status for the same event,
# retryable in both)
_DEVICE_ERRORS = [
    ("torch.OutOfMemoryError",
     lambda t: t.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                  "2.00 GiB"),
     "RESOURCE_EXHAUSTED", True),
    ("torch.cuda.OutOfMemoryError",
     lambda t: t.cuda.OutOfMemoryError("CUDA out of memory"),
     "RESOURCE_EXHAUSTED", True),
    ("AcceleratorError out of memory",
     lambda t: t.AcceleratorError("CUDA error: out of memory"),
     "RESOURCE_EXHAUSTED", True),
    ("RuntimeError out of memory",
     lambda t: RuntimeError("CUDA error: out of memory\nCUDA kernel errors "
                            "might be asynchronously reported"),
     "RESOURCE_EXHAUSTED", True),
    ("illegal memory access",
     lambda t: t.AcceleratorError("CUDA error: an illegal memory access was "
                                  "encountered"),
     "INTERNAL", False),
    ("device-side assert",
     lambda t: t.AcceleratorError("CUDA error: device-side assert "
                                  "triggered"),
     "INTERNAL", False),
    ("unspecified launch failure",
     lambda t: RuntimeError("CUDA error: unspecified launch failure"),
     "INTERNAL", False),
    ("program error",
     lambda t: RuntimeError("mat1 and mat2 shapes cannot be multiplied "
                            "(4x3 and 5x2)"),
     "INVALID_ARGUMENT", False),
]


@pytest.mark.parametrize("label,make,status,retry", _DEVICE_ERRORS,
                         ids=[c[0] for c in _DEVICE_ERRORS])
def test_device_errors_classify_as_the_reference_classifies_xla(
        label, make, status, retry):
    """An out-of-memory error is transient, as the reference's
    RESOURCE_EXHAUSTED is; a sticky CUDA error (the context is unusable
    after it) and a program error are fatal, as the reference's INTERNAL
    and INVALID_ARGUMENT are."""
    import torch

    ref = _mod("alink_tpu", "exceptions").is_retryable
    port = _mod("alink_tpu_torch", "exceptions").is_retryable
    assert ref(_xla_error(status)) is retry
    assert port(make(torch)) is retry
    # the reference's own XLA classification stays as it was in the port
    assert port(_xla_error(status)) is retry


def test_dead_letters_and_summary_keys_match_reference():
    out = {}
    for pkg in PKGS:
        res = _mod(pkg, "resilience")
        buf = res.DeadLetterBuffer()
        buf.add("csv", ("x", 1), ValueError("no"))
        out[pkg] = (buf.records(), sorted(res.resilience_summary()))
    assert out["alink_tpu_torch"][0] == out["alink_tpu"][0]
    assert "dead_letter_buffered" in out["alink_tpu_torch"][1]


def _spans(pkg):
    """One job's spans: nested spans, a retried one, a failed one, a
    thread handoff, a wire hop. Returns (job_report, chrome_trace)."""
    tr = _mod(pkg, "tracing")
    tr.tracer.clear()
    with tr.trace_span("job", rows=3) as root:
        with tr.trace_span("stage.a", op="A") as sp:
            sp.phases["compute_s"] = 0.25
            tr.note_retry()
        with pytest.raises(RuntimeError):
            with tr.trace_span("stage.b"):
                raise RuntimeError("boom")
        ctx = tr.capture_context()

        def worker():
            with tr.attach_context(ctx), tr.trace_span("pool.unit"):
                pass

        th = threading.Thread(target=worker, name="worker-1")
        th.start()
        th.join(timeout=30)
        wire = tr.wire_context()
    with tr.adopt_context(wire), tr.trace_span("remote.unit"):
        pass
    with tr.adopt_context({"trace_id": 5}), tr.trace_span("orphan"):
        pass
    return tr.job_report(root.trace_id), tr.chrome_trace(root.trace_id)


def _shape(node):
    return (node["name"], node["outcome"], node.get("retries", 0),
            node.get("attrs"), node.get("phases"),
            [_shape(c) for c in node["children"]])


def test_job_report_and_chrome_trace_structure_match_reference():
    (rep_r, ch_r), (rep_p, ch_p) = _spans("alink_tpu"), _spans(
        "alink_tpu_torch")
    assert sorted(rep_p) == sorted(rep_r)
    assert [_shape(t) for t in rep_p["tree"]] == \
        [_shape(t) for t in rep_r["tree"]]
    for key in ("totals", "retries", "outcomes"):
        assert rep_p[key] == rep_r[key], key
    assert rep_p["root"]["name"] == "job" and rep_p["retries"] == 1
    assert rep_p["outcomes"] == {"ok": 3, "retried": 1, "failed": 1}
    assert sorted(rep_p["caches"]) == sorted(rep_r["caches"])

    def events(ch):
        return [(e["ph"], e["name"], e.get("cat"), sorted(e["args"]))
                for e in ch["traceEvents"] if e["name"] != "process_name"]

    assert events(ch_p) == events(ch_r)
    assert sorted(ch_p) == sorted(ch_r)


def test_tracing_off_records_nothing(monkeypatch):
    tr = _mod("alink_tpu_torch", "tracing")
    monkeypatch.setenv("ALINK_TRACING", "off")
    tr.tracer.clear()
    with tr.trace_span("x") as sp:
        assert sp is None
    assert tr.tracer.spans() == []
    assert "error" in tr.job_report()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from alink_tpu_torch.common.metrics import profile_trace

    with profile_trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# the two repairs: the padded forward, the kept mapper
# ---------------------------------------------------------------------------


def _tiny_encoder(seed=0, block=0):
    import torch

    from alink_tpu_torch.dl.modules import BertConfig, TransformerEncoder

    cfg = BertConfig.tiny(vocab_size=50, max_position=16, num_labels=3,
                          attention_block_size=block)
    torch.manual_seed(seed)
    model = TransformerEncoder(cfg)
    model.init_weights(seed)
    return model


def _tiny_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 50, (n, 16)).astype(np.int32)
    mask = np.ones((n, 16), np.int32)
    mask[:, 12:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((n, 16), np.int32)}


@pytest.mark.parametrize("n,rung", [(3, 8), (9, 16), (65, 128)])
def test_predict_model_pads_chunks_up_the_ladder(n, rung):
    """The forward runs at the chunk's bucket rung (a hook records the
    batch dimension) and the trimmed logits equal the unpadded forward's."""
    import torch

    from alink_tpu_torch.common.jitcache import bucket_rows
    from alink_tpu_torch.dl.train import predict_model

    model = _tiny_encoder()
    seen = []
    hook = model.register_forward_hook(
        lambda mod, args, kw, out: seen.append(kw["input_ids"].shape[0]),
        with_kwargs=True)
    inputs = _tiny_inputs(n)
    got = predict_model(model, inputs, device="cpu")
    hook.remove()
    assert seen == [rung] == [bucket_rows(n)]
    with torch.inference_mode():
        want = model(**{k: torch.as_tensor(v) for k, v in inputs.items()})
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, want.float().numpy(), rtol=0, atol=1e-6)


def test_predict_model_notes_each_rung_once(monkeypatch):
    from alink_tpu_torch.common import jitcache
    from alink_tpu_torch.common.metrics import metrics
    from alink_tpu_torch.dl.train import predict_model

    jitcache.clear_signatures()
    model = _tiny_encoder(1)
    t0 = metrics.counter("jit.trace")
    for n in (1, 3, 8, 5, 12, 16):
        predict_model(model, _tiny_inputs(n), device="cpu")
    assert metrics.counter("jit.trace") - t0 == 2      # rungs 8 and 16
    specs = jitcache.seen_warmup_specs(["dl.apply_logits"])
    assert sorted(s[0][0][0] for _, s in specs) == [8, 16]
    monkeypatch.setenv("ALINK_SHAPE_BUCKETS", "off")
    assert jitcache.bucket_rows(5) == 5
    predict_model(model, _tiny_inputs(5), device="cpu")
    assert metrics.counter("jit.trace") - t0 == 3


def _bert_pipeline(path):
    """A BertClassificationModel pipeline over a seeded tiny encoder."""
    import dataclasses

    from alink_tpu_torch.common.model import model_to_table
    from alink_tpu_torch.dl.convert import torch_to_flax
    from alink_tpu_torch.operator.batch.dl import params_to_bytes
    from alink_tpu_torch.pipeline import BertClassificationModel, PipelineModel

    model = _tiny_encoder(2, block=8)
    cfg = model.cfg
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [f"w{i}" for i in range(45)]
    meta = {"modelName": "BertTextModel",
            "bertConfig": {k: v for k, v in dataclasses.asdict(cfg).items()
                           if k != "dtype"},
            "textCol": "text", "textPairCol": None, "labelCol": "label",
            "labelType": "LONG", "labels": [0, 1, 2], "regression": False,
            "maxSeqLength": 16, "vocab": vocab, "doLowerCase": True}
    table = model_to_table(meta, {"params": params_to_bytes(
        torch_to_flax(model.state_dict(), cfg))})
    PipelineModel(BertClassificationModel(
        predictionCol="pred", predictionDetailCol="detail")
        .set_model_data(table)).save(path)
    rng = np.random.default_rng(3)
    return [(" ".join(f"w{j}" for j in rng.integers(0, 45, rng.integers(
        2, 14))),) for _ in range(12)]


def test_local_predictor_decodes_its_model_once(tmp_path, monkeypatch):
    """The cached plan's BERT op keeps its loaded mapper: 4 predicts, 1
    decode; the reload-every-time route (a plan rebuilt per call) decodes 4
    times and gives the same rows. New stamped params (a precision policy)
    decode once more."""
    from alink_tpu_torch.operator.batch import dl
    from alink_tpu_torch.pipeline import LocalPredictor

    rows = _bert_pipeline(str(tmp_path / "b.ak"))
    loads = []
    real = dl.BertTextModelMapper.load_model

    def counted(self, model):
        loads.append(1)
        return real(self, model)

    monkeypatch.setattr(dl.BertTextModelMapper, "load_model", counted)
    kept = LocalPredictor(str(tmp_path / "b.ak"), "text string")
    got = [kept.predict_row(r) for r in rows[:4]]
    assert len(loads) == 1
    rebuilt = LocalPredictor(str(tmp_path / "b.ak"), "text string",
                             cache_plan=False)
    want = [rebuilt.predict_row(r) for r in rows[:4]]
    assert len(loads) == 5
    assert got == want
    from alink_tpu_torch.common import quant

    for op in kept._plan[2]:
        op.get_params().set(quant.PRECISION_KEY, "bf16")
    kept.predict_row(rows[0])
    kept.predict_row(rows[1])
    assert len(loads) == 6


@pytest.mark.parametrize("knob", ["", "off", "64,512,4096", "junk"])
def test_bucket_ladder_matches_reference(monkeypatch, knob):
    from alink_tpu.common import jitcache as ref
    from alink_tpu_torch.common import jitcache as port

    monkeypatch.setenv("ALINK_SHAPE_BUCKETS", knob)
    ns = list(range(0, 300)) + [511, 512, 513, 4095, 4097, 10_000]
    for fn in ("bucket_rows", "floor_bucket_rows"):
        assert [getattr(port, fn)(n) for n in ns] == \
            [getattr(ref, fn)(n) for n in ns], fn
    assert port.bucketing_enabled() == ref.bucketing_enabled()
    a = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(port.pad_rows(a, 8), ref.pad_rows(a, 8))


def test_warmup_specs_file_reads_in_the_reference(tmp_path):
    """The port's signature record, saved, is a profile the reference's
    ``load_shape_profile`` reads back entry for entry."""
    from alink_tpu.common.jitcache import load_shape_profile
    from alink_tpu_torch.common import jitcache

    jitcache.clear_signatures()
    jitcache.note_signature("k", [np.zeros((8, 4), np.int32)])
    jitcache.note_signature("k", [np.zeros((16, 4), np.int32)])
    assert not jitcache.note_signature("k", [np.zeros((8, 4), np.int32)])
    path = str(tmp_path / "profile.jsonl")
    assert jitcache.save_warmup_specs(path) == 2
    assert load_shape_profile(path) == jitcache.seen_warmup_specs() == [
        ("k", [((8, 4), "int32")]), ("k", [((16, 4), "int32")])]
