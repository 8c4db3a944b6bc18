"""Parity of the port's NLP ops (``operator/batch/nlp.py``: segmentation,
n-grams, stop words, word counts, TF-IDF, the count vectorizers,
TextRank keywords and the tokenizers) with ``alink_tpu`` on the CPU: the
cases of ``tests/test_nlp.py``, empty and None documents, and a seeded
corpus, through both packages.

Everything but TextRank is host code copied: the tables are equal.
TextRank's word graph is symmetric, so its PageRank has no dangling vertex
and the port's ranks equal the reference's bit for bit
(``graph/engine.py``): the keywords are equal, tied scores included, with
no tolerance."""

import numpy as np
import pytest

from torch_table_parity import both, reference_session, remove_session, \
    same_model, same_table


@pytest.fixture(scope="module")
def sid():
    s = reference_session()
    yield s
    remove_session(s)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _corpus(n=60, seed=0):
    """Seeded documents over a small Zipf vocabulary with stop words, an
    empty document, a None and one word repeated."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(40)] + ["the", "and", "of", "The"]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = [" ".join(rng.choice(vocab, int(rng.integers(1, 30)), p=p))
            for _ in range(n)]
    docs[3], docs[7], docs[11] = "", None, "w1 w1 w1"
    return {"id": np.asarray([f"d{i}" for i in range(n)], object),
            "txt": np.asarray(docs, object)}


TEXTS = {"id": np.asarray(["d1", "d2", "d3"], object),
         "txt": np.asarray(["The cat and the hat", "abcd  x y x", None],
                           object)}


@pytest.mark.parametrize("op, params", [
    ("SegmentBatchOp", {"userDefinedDict": ["ab", "cd", "ca"]}),
    ("SegmentBatchOp", {}),
    ("NGramBatchOp", {"n": 2}),
    ("NGramBatchOp", {"n": 3}),
    ("StopWordsRemoverBatchOp", {}),
    ("StopWordsRemoverBatchOp", {"stopWords": ["Cat"]}),
    ("StopWordsRemoverBatchOp", {"stopWords": ["Cat"], "caseSensitive": True}),
    ("TokenizerBatchOp", {}),
    ("RegexTokenizerBatchOp", {}),
    ("RegexTokenizerBatchOp", {"pattern": "\\w+", "gaps": False,
                               "minTokenLength": 2, "toLowerCase": False}),
])
def test_string_mappers(sid, op, params):
    ref, port = both(sid, TEXTS, lambda ops, extra, src: getattr(ops, op)(
        selectedCol="txt", outputCol="out", **params, **extra).link_from(src))
    same_table(port, ref)


def test_segment_with_user_dict(sid):
    ref, port = both(sid, {"txt": np.asarray(["abcd"], object)},
                     lambda ops, extra, src: ops.SegmentBatchOp(
                         selectedCol="txt", outputCol="seg",
                         userDefinedDict=["ab", "cd"], **extra).link_from(src))
    same_table(port, ref)
    assert port.col("seg")[0] == "ab cd"


@pytest.mark.parametrize("cols", [TEXTS, _corpus()])
def test_word_count_doc_word_count_and_tfidf(sid, cols):
    ref, port = both(sid, cols, lambda ops, extra, src: ops.WordCountBatchOp(
        selectedCol="txt", **extra).link_from(src))
    same_table(port, ref)
    ref, port = both(sid, cols, lambda ops, extra, src: ops.TfidfBatchOp(
        **extra).link_from(ops.DocWordCountBatchOp(
            docIdCol="id", contentCol="txt", **extra).link_from(src)))
    same_table(port, ref)


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("ftype", ["WORD_COUNT", "TF", "IDF", "TF_IDF",
                                   "BINARY"])
def test_count_vectorizers(sid, hashed, ftype):
    cols = _corpus(seed=1)
    kind = "DocHashCountVectorizer" if hashed else "DocCountVectorizer"
    params = {"numFeatures": 64} if hashed else {"minDF": 2.0,
                                                 "vocabSize": 20}

    def build(ops, extra, src):
        model = getattr(ops, f"{kind}TrainBatchOp")(
            selectedCol="txt", **params, **extra).link_from(src)
        return getattr(ops, f"{kind}PredictBatchOp")(
            selectedCol="txt", outputCol="vec", featureType=ftype,
            **extra).link_from(model, src)

    ref, port = both(sid, cols, build)
    same_table(port, ref)
    ref, port = both(sid, cols, lambda ops, extra, src: getattr(
        ops, f"{kind}TrainBatchOp")(selectedCol="txt", **params,
                                    **extra).link_from(src))
    same_model(port, ref)


@pytest.mark.parametrize("cols, params", [
    ({"id": np.asarray(["d1"], object), "txt": np.asarray([
        "graph ranking algorithm ranks graph nodes by graph structure "
        "ranking uses graph edges"], object)}, {"topN": 2}),
    # paths and cycles: many exact ties among the scores
    ({"id": np.asarray(["p", "c", "s", "e", "o"], object),
      "txt": np.asarray(["a b c d e f g", "a b c a b c a", "the and of",
                         "", "solo"], object)}, {"topN": 4}),
    (_corpus(seed=2), {"topN": 5}),
    (_corpus(seed=3), {"topN": 3, "windowSize": 4}),
])
def test_keywords_extraction(sid, cols, params):
    ref, port = both(sid, cols, lambda ops, extra, src:
                     ops.KeywordsExtractionBatchOp(
                         docIdCol="id", selectedCol="txt", **params,
                         **extra).link_from(src))
    same_table(port, ref)
    if params == {"topN": 2}:
        assert "graph" in port.col("keywords")[0].split()


def test_keywords_ranks_are_the_references_bit_for_bit(monkeypatch):
    """TextRank's PageRank calls receive the same graphs and return the
    same float32 ranks in both packages, tied scores included."""
    from alink_tpu.graph import engine as R
    from alink_tpu_torch.graph import engine as P
    import alink_tpu.operator.batch as RB
    import alink_tpu_torch.operator.batch as PB
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    seen = {"ref": [], "port": []}
    for mod, key in ((R, "ref"), (P, "port")):
        orig = mod.pagerank

        def rec(g, *a, _orig=orig, _key=key, **kw):
            pr = _orig(g, *a, **kw)
            seen[_key].append(pr)
            return pr

        monkeypatch.setattr(mod, "pagerank", rec)
    cols = _corpus(seed=4)
    for ops, T in ((RB, RT), (PB, PT)):
        ops.KeywordsExtractionBatchOp(docIdCol="id", selectedCol="txt") \
            .link_from(ops.TableSourceBatchOp(T(dict(cols)))).collect()
    assert len(seen["ref"]) == len(seen["port"]) > 40
    ties = 0
    for a, b in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(b, a)
        ties += len(a) - len(np.unique(a))
    assert ties > 0
