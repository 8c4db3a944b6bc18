"""NLP breadth: segmentation, n-grams, stop words, word counts, TF-IDF,
count vectorizer, keyword extraction (port of
``alink_tpu.operator.batch.nlp``).

Capability parity with the reference nlp package (reference:
core/src/main/java/com/alibaba/alink/operator/batch/nlp/
SegmentBatchOp.java (jieba-style dict DP; dict resource
core/src/main/resources/prob_emit.txt), NGramBatchOp.java,
StopWordsRemoverBatchOp.java (common/nlp/StopWordsRemoverMapper),
WordCountBatchOp.java, DocWordCountBatchOp.java, TfidfBatchOp.java,
DocCountVectorizerTrainBatchOp.java + common/nlp/DocCountVectorizerModelMapper
(featureType TF/IDF/TF_IDF/BINARY/WORD_COUNT),
KeywordsExtractionBatchOp.java (TextRank over a word graph)).

Re-design notes: the count-vectorizer serving path emits SparseVector blocks;
TextRank rides the graph engine's PageRank (graph/engine.py) on the
session's device — the word co-occurrence graph is just another edge list,
symmetric, so on the CPU its ranks equal the reference's bit for bit and
tied words keep the reference's order. Everything else is host code,
copied; DocWordCount and Tfidf build their columns in bulk and the hashing
vectorizer hashes each distinct word once, with the reference's results.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ...common.linalg import SparseVector
from ...common.model import model_to_table, table_to_model
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import (
    HasOutputCol,
    HasReservedCols,
    HasSelectedCol,
    Mapper,
    ModelMapper,
    SISOMapper,
)
from .base import BatchOperator
from .utils import MapBatchOp, ModelMapBatchOp, ModelTrainOpMixin

# A minimal English stop-word list (reference ships resource files under
# core/src/main/resources; the op accepts a user list for anything else).
_DEFAULT_STOP_WORDS = frozenset("""
a an and are as at be by for from has he in is it its of on that the to was
were will with this these those i you your we they them their or not no but
if then else when while do does did done been being am
""".split())


class SegmentMapper(SISOMapper):
    """Dictionary unigram-DP segmentation (the jieba DAG-route algorithm
    without the HMM tail; reference: common/nlp/SegmentMapper.java). Words
    absent from the dictionary fall back to single characters."""

    USER_DEFINED_DICT = ParamInfo("userDefinedDict", list)

    def _dict(self) -> Dict[str, float]:
        words = self.get(self.USER_DEFINED_DICT) or []
        freq = {w: 10.0 for w in words}
        return freq

    def map_column(self, values, type_tag):
        return (np.asarray([self._segment(v) for v in values], object),
                AlinkTypes.STRING)

    def _segment(self, value):
        if value is None:
            return None
        text = str(value)
        freq = getattr(self, "_freq", None)
        if freq is None:
            freq = self._dict()
            self._freq = freq
            self._maxlen = max((len(w) for w in freq), default=1)
        n = len(text)
        if n == 0:
            return ""
        # DP over best log-prob split; unknown single chars get a low score
        best = [-1e18] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        total = sum(freq.values()) + 1.0
        for i in range(n):
            if best[i] == -1e18:
                continue
            for j in range(i + 1, min(n, i + self._maxlen) + 1):
                w = text[i:j]
                if j == i + 1:
                    score = math.log(freq.get(w, 0.5) / total)
                elif w in freq:
                    score = math.log(freq[w] / total)
                else:
                    continue
                if best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = i
        toks = []
        j = n
        while j > 0:
            i = back[j]
            toks.append(text[i:j])
            j = i
        return " ".join(reversed(toks))


class SegmentBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                     HasReservedCols):
    mapper_cls = SegmentMapper
    USER_DEFINED_DICT = SegmentMapper.USER_DEFINED_DICT


class NGramMapper(SISOMapper):
    """word n-grams joined by '_' (reference: common/nlp/NGramMapper.java)."""

    N = ParamInfo("n", int, default=2, validator=MinValidator(1))

    def map_column(self, values, type_tag):
        n = int(self.get(self.N))

        def one(value):
            if value is None:
                return None
            toks = str(value).split()
            return " ".join("_".join(toks[i:i + n])
                            for i in range(max(len(toks) - n + 1, 0)))

        return np.asarray([one(v) for v in values], object), AlinkTypes.STRING


class NGramBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol, HasReservedCols):
    mapper_cls = NGramMapper
    N = NGramMapper.N


class StopWordsRemoverMapper(SISOMapper):
    """(reference: common/nlp/StopWordsRemoverMapper.java)"""

    STOP_WORDS = ParamInfo("stopWords", list)
    CASE_SENSITIVE = ParamInfo("caseSensitive", bool, default=False)

    def map_column(self, values, type_tag):
        extra = self.get(self.STOP_WORDS) or []
        case = self.get(self.CASE_SENSITIVE)
        stop = set(_DEFAULT_STOP_WORDS) | (
            set(extra) if case else {w.lower() for w in extra})

        def one(value):
            if value is None:
                return None
            kept = [t for t in str(value).split()
                    if (t if case else t.lower()) not in stop]
            return " ".join(kept)

        return np.asarray([one(v) for v in values], object), AlinkTypes.STRING


class StopWordsRemoverBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                              HasReservedCols):
    mapper_cls = StopWordsRemoverMapper
    STOP_WORDS = StopWordsRemoverMapper.STOP_WORDS
    CASE_SENSITIVE = StopWordsRemoverMapper.CASE_SENSITIVE


_WORD_COUNT_SCHEMA = TableSchema(["word", "cnt"],
                                 [AlinkTypes.STRING, AlinkTypes.LONG])


class WordCountBatchOp(BatchOperator, HasSelectedCol):
    """Corpus word counts (reference: WordCountBatchOp.java)."""

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from collections import Counter

        counter = Counter()
        for doc in t.col(self.get(HasSelectedCol.SELECTED_COL)):
            if doc is not None:
                counter.update(str(doc).split())
        items = counter.most_common()
        return MTable(
            {"word": np.asarray([w for w, _ in items], object),
             "cnt": np.asarray([c for _, c in items], np.int64)},
            _WORD_COUNT_SCHEMA)

    def _out_schema(self, in_schema):
        return _WORD_COUNT_SCHEMA


_DOC_WC_SCHEMA = TableSchema(["docId", "word", "cnt"],
                             [AlinkTypes.STRING, AlinkTypes.STRING,
                              AlinkTypes.LONG])


class DocWordCountBatchOp(BatchOperator):
    """(docId, word, cnt) triples (reference: DocWordCountBatchOp.java)."""

    DOC_ID_COL = ParamInfo("docIdCol", str, optional=False)
    CONTENT_COL = ParamInfo("contentCol", str, optional=False,
                            aliases=("selectedCol",))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from collections import Counter

        dids, words, cnts = [], [], []
        for did, doc in zip(t.col(self.get(self.DOC_ID_COL)),
                            t.col(self.get(self.CONTENT_COL))):
            counter = Counter(str(doc).split() if doc is not None else [])
            dids.extend([str(did)] * len(counter))
            words.extend(counter)
            cnts.extend(counter.values())
        if not words:
            return MTable.from_rows([], _DOC_WC_SCHEMA)
        # the columns from_rows would build, without its row loop
        return MTable({"docId": np.asarray(dids), "word": np.asarray(words),
                       "cnt": np.asarray(cnts, np.int64)}, _DOC_WC_SCHEMA)

    def _out_schema(self, in_schema):
        return _DOC_WC_SCHEMA


_TFIDF_SCHEMA = TableSchema(
    ["docId", "word", "cnt", "tf", "idf", "tfidf"],
    [AlinkTypes.STRING, AlinkTypes.STRING, AlinkTypes.LONG,
     AlinkTypes.DOUBLE, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE])


class TfidfBatchOp(BatchOperator):
    """TF-IDF from (docId, word, cnt) triples — chain after DocWordCount
    (reference: TfidfBatchOp.java)."""

    DOC_ID_COL = ParamInfo("docIdCol", str, default="docId")
    WORD_COL = ParamInfo("wordCol", str, default="word")
    COUNT_COL = ParamInfo("countCol", str, default="cnt")

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        dids = np.asarray(t.col(self.get(self.DOC_ID_COL)), object).astype(str)
        words = np.asarray(t.col(self.get(self.WORD_COL)), object).astype(str)
        cnts = np.asarray(t.col(self.get(self.COUNT_COL)), np.float64)
        if not len(dids):
            return MTable.from_rows([], _TFIDF_SCHEMA)
        # in bulk, the reference's values: each document's total summed in
        # row order, each word's idf by math.log once
        doc_of: Dict[str, int] = {}
        inv_d = np.fromiter((doc_of.setdefault(d, len(doc_of))
                             for d in dids.tolist()), np.int64, len(dids))
        word_of: Dict[str, int] = {}
        inv_w = np.fromiter((word_of.setdefault(w, len(word_of))
                             for w in words.tolist()), np.int64, len(words))
        doc_total = np.zeros(len(doc_of))
        np.add.at(doc_total, inv_d, cnts)
        doc_freq = np.bincount(inv_w, minlength=len(word_of))
        n_docs = len(doc_of)
        idf = np.asarray([math.log((1.0 + n_docs) / (1.0 + f))
                          for f in doc_freq.tolist()])[inv_w]
        tf = cnts / doc_total[inv_d]
        return MTable({"docId": dids, "word": words,
                       "cnt": cnts.astype(np.int64), "tf": tf, "idf": idf,
                       "tfidf": tf * idf}, _TFIDF_SCHEMA)

    def _out_schema(self, in_schema):
        return _TFIDF_SCHEMA


class DocCountVectorizerTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                     HasSelectedCol):
    """Vocabulary + document frequencies (reference:
    DocCountVectorizerTrainBatchOp.java)."""

    MAX_DF = ParamInfo("maxDF", float, default=1.0)
    MIN_DF = ParamInfo("minDF", float, default=1.0)
    VOCAB_SIZE = ParamInfo("vocabSize", int, default=1 << 18)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from collections import Counter

        docs = [str(v).split() if v is not None else []
                for v in t.col(self.get(HasSelectedCol.SELECTED_COL))]
        n_docs = max(len(docs), 1)
        df = Counter()
        for doc in docs:
            df.update(set(doc))
        min_df = self.get(self.MIN_DF)
        max_df = self.get(self.MAX_DF)
        min_abs = min_df if min_df >= 1 else min_df * n_docs
        max_abs = max_df if max_df > 1 else max_df * n_docs
        items = [(w, c) for w, c in df.most_common()
                 if min_abs <= c <= max_abs][:self.get(self.VOCAB_SIZE)]
        vocab = sorted(w for w, _ in items)
        dfs = {w: c for w, c in items}
        meta = {
            "modelName": "DocCountVectorizerModel",
            "selectedCol": self.get(HasSelectedCol.SELECTED_COL),
            "vocab": vocab,
            "docFreq": [dfs[w] for w in vocab],
            "numDocs": n_docs,
        }
        return model_to_table(meta, {})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "DocCountVectorizerModel"}


class DocCountVectorizerModelMapper(ModelMapper, HasSelectedCol, HasOutputCol,
                                    HasReservedCols):
    """featureType TF / IDF / TF_IDF / BINARY / WORD_COUNT (reference:
    common/nlp/DocCountVectorizerModelMapper.java)."""

    FEATURE_TYPE = ParamInfo(
        "featureType", str, default="WORD_COUNT",
        validator=InValidator("TF", "IDF", "TF_IDF", "BINARY", "WORD_COUNT"))

    def load_model(self, model: MTable):
        self.meta, _ = table_to_model(model)
        self.w2i = {w: i for i, w in enumerate(self.meta["vocab"])}
        n_docs = self.meta["numDocs"]
        self.idf = np.asarray(
            [math.log((1.0 + n_docs) / (1.0 + c))
             for c in self.meta["docFreq"]], np.float64)
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from collections import Counter

        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        col = self.get(HasSelectedCol.SELECTED_COL) or self.meta["selectedCol"]
        ftype = self.get(self.FEATURE_TYPE)
        V = len(self.w2i)
        vecs = []
        for doc in t.col(col):
            counter = Counter(str(doc).split() if doc is not None else [])
            idx, vals = [], []
            total = sum(counter.values()) or 1
            for w, c in counter.items():
                j = self.w2i.get(w)
                if j is None:
                    continue
                if ftype == "WORD_COUNT":
                    v = float(c)
                elif ftype == "TF":
                    v = c / total
                elif ftype == "BINARY":
                    v = 1.0
                elif ftype == "IDF":
                    v = self.idf[j]
                else:  # TF_IDF
                    v = c / total * self.idf[j]
                idx.append(j)
                vals.append(v)
            vecs.append(SparseVector(V, idx, vals))
        return self._append_result(
            t, {out: np.asarray(vecs, object)}, {out: AlinkTypes.SPARSE_VECTOR})


class DocCountVectorizerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                       HasOutputCol, HasReservedCols):
    mapper_cls = DocCountVectorizerModelMapper
    FEATURE_TYPE = DocCountVectorizerModelMapper.FEATURE_TYPE


_KEYWORDS_SCHEMA = TableSchema(["docId", "keywords"],
                               [AlinkTypes.STRING, AlinkTypes.STRING])


class KeywordsExtractionBatchOp(BatchOperator):
    """TextRank keywords per document (reference:
    KeywordsExtractionBatchOp.java — TextRank over the word co-occurrence
    window graph, scored by the shared PageRank kernel)."""

    DOC_ID_COL = ParamInfo("docIdCol", str)
    SELECTED_COL = ParamInfo("selectedCol", str, optional=False)
    TOP_N = ParamInfo("topN", int, default=5, validator=MinValidator(1))
    WINDOW_SIZE = ParamInfo("windowSize", int, default=2,
                            validator=MinValidator(1))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...graph.engine import MemoryGraph, pagerank

        id_col = self.get(self.DOC_ID_COL)
        topn = self.get(self.TOP_N)
        win = self.get(self.WINDOW_SIZE)
        doc_ids = (t.col(id_col) if id_col
                   else np.arange(t.num_rows).astype(str))
        rows = []
        for did, doc in zip(doc_ids, t.col(self.get(self.SELECTED_COL))):
            toks = [w for w in str(doc).split()
                    if w.lower() not in _DEFAULT_STOP_WORDS]
            uniq = sorted(set(toks))
            if not uniq:
                rows.append((str(did), ""))
                continue
            w2i = {w: i for i, w in enumerate(uniq)}
            src, dst = [], []
            for i, w in enumerate(toks):
                for j in range(i + 1, min(i + win + 1, len(toks))):
                    if toks[j] != w:
                        src.append(w2i[w])
                        dst.append(w2i[toks[j]])
            if not src:
                rows.append((str(did), " ".join(uniq[:topn])))
                continue
            src, dst = np.asarray(src + dst), np.asarray(dst + src)
            g = MemoryGraph(len(uniq), src, dst)
            pr = pagerank(g, max_iter=50, device=self.env.device)
            order = np.argsort(-pr)[:topn]
            rows.append((str(did), " ".join(uniq[i] for i in order)))
        return MTable.from_rows(rows, _KEYWORDS_SCHEMA)

    def _out_schema(self, in_schema):
        return _KEYWORDS_SCHEMA


class DocHashCountVectorizerModelMapper(ModelMapper, HasSelectedCol,
                                        HasOutputCol, HasReservedCols):
    """Hashing-trick doc vectorizer serving (reference:
    common/nlp/DocHashCountVectorizerModelMapper.java). Model carries the
    IDF table over hash slots."""

    FEATURE_TYPE = ParamInfo(
        "featureType", str, default="WORD_COUNT",
        validator=InValidator("TF", "IDF", "TF_IDF", "BINARY", "WORD_COUNT"))

    def load_model(self, model: MTable):
        self.meta, arrays = table_to_model(model)
        self.idf = arrays["idf"]
        return self

    def output_schema(self, input_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        return self._append_result_schema(input_schema, [out],
                                          [AlinkTypes.SPARSE_VECTOR])

    def map_table(self, t: MTable) -> MTable:
        from collections import Counter

        from .feature2 import _hash32

        out = self.get(HasOutputCol.OUTPUT_COL) or "vec"
        col = self.get(HasSelectedCol.SELECTED_COL) or self.meta["selectedCol"]
        ftype = self.get(self.FEATURE_TYPE)
        m = self.meta["numFeatures"]
        slot_of: Dict[str, int] = {}     # each distinct word hashed once

        def slot_for(w):
            j = slot_of.get(w)
            if j is None:
                j = slot_of[w] = _hash32(w) % m
            return j

        vecs = []
        for doc in t.col(col):
            counter = Counter(
                slot_for(w)
                for w in (str(doc).split() if doc is not None else []))
            total = sum(counter.values()) or 1
            idx, vals = [], []
            for slot, c in counter.items():
                if ftype == "WORD_COUNT":
                    v = float(c)
                elif ftype == "TF":
                    v = c / total
                elif ftype == "BINARY":
                    v = 1.0
                elif ftype == "IDF":
                    v = float(self.idf[slot])
                else:
                    v = c / total * float(self.idf[slot])
                idx.append(slot)
                vals.append(v)
            vecs.append(SparseVector(m, idx, vals))
        return self._append_result(
            t, {out: np.asarray(vecs, object)},
            {out: AlinkTypes.SPARSE_VECTOR})


class DocHashCountVectorizerTrainBatchOp(ModelTrainOpMixin, BatchOperator,
                                         HasSelectedCol):
    """(reference: DocHashCountVectorizerTrainBatchOp.java — IDF over hash
    slots, no vocabulary table)."""

    NUM_FEATURES = ParamInfo("numFeatures", int, default=1 << 18)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from .feature2 import _hash32

        m = int(self.get(self.NUM_FEATURES))
        df = np.zeros(m, np.float64)
        docs = [str(v).split() if v is not None else []
                for v in t.col(self.get(HasSelectedCol.SELECTED_COL))]
        slot_of: Dict[str, int] = {}     # each distinct word hashed once
        for doc in docs:
            for w in set(doc):
                if w not in slot_of:
                    slot_of[w] = _hash32(w) % m
            for slot in {slot_of[w] for w in doc}:
                df[slot] += 1
        n_docs = max(len(docs), 1)
        idf = np.log((1.0 + n_docs) / (1.0 + df))
        meta = {"modelName": "DocHashCountVectorizerModel",
                "selectedCol": self.get(HasSelectedCol.SELECTED_COL),
                "numFeatures": m}
        return model_to_table(meta, {"idf": idf})

    def _static_meta_keys(self, in_schema):
        return {"modelName": "DocHashCountVectorizerModel",
                "numFeatures": self.get(self.NUM_FEATURES)}


class DocHashCountVectorizerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                           HasOutputCol, HasReservedCols):
    mapper_cls = DocHashCountVectorizerModelMapper
    FEATURE_TYPE = DocHashCountVectorizerModelMapper.FEATURE_TYPE


class TokenizerMapper(SISOMapper):
    """Lowercase whitespace tokenizer, space-joined output (reference:
    common/nlp/TokenizerMapper.java)."""

    def map_column(self, values, type_tag):
        out = []
        for v in values:
            out.append(None if v is None
                       else " ".join(str(v).lower().split()))
        return np.asarray(out, object), AlinkTypes.STRING


class TokenizerBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                       HasReservedCols):
    """(reference: operator/batch/nlp/TokenizerBatchOp.java)"""

    mapper_cls = TokenizerMapper


class RegexTokenizerMapper(SISOMapper):
    """Regex split (gaps=True) or regex match (gaps=False) tokenizer
    (reference: common/nlp/RegexTokenizerMapper.java)."""

    PATTERN = ParamInfo("pattern", str, default=r"\s+")
    GAPS = ParamInfo("gaps", bool, default=True)
    MIN_TOKEN_LENGTH = ParamInfo("minTokenLength", int, default=1)
    TO_LOWER_CASE = ParamInfo("toLowerCase", bool, default=True)

    def map_column(self, values, type_tag):
        import re as _re

        pat = _re.compile(self.get(self.PATTERN))
        gaps = self.get(self.GAPS)
        min_len = self.get(self.MIN_TOKEN_LENGTH)
        lower = self.get(self.TO_LOWER_CASE)
        out = []
        for v in values:
            if v is None:
                out.append(None)
                continue
            s = str(v).lower() if lower else str(v)
            toks = pat.split(s) if gaps else pat.findall(s)
            out.append(" ".join(t for t in toks if len(t) >= min_len))
        return np.asarray(out, object), AlinkTypes.STRING


class RegexTokenizerBatchOp(MapBatchOp, HasSelectedCol, HasOutputCol,
                            HasReservedCols):
    """(reference: operator/batch/nlp/RegexTokenizerBatchOp.java)"""

    mapper_cls = RegexTokenizerMapper
    PATTERN = RegexTokenizerMapper.PATTERN
    GAPS = RegexTokenizerMapper.GAPS
    MIN_TOKEN_LENGTH = RegexTokenizerMapper.MIN_TOKEN_LENGTH
    TO_LOWER_CASE = RegexTokenizerMapper.TO_LOWER_CASE
