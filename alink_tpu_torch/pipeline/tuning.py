"""Hyper-parameter tuning: grid/random/Bayes search with CV or TV split
(port of ``alink_tpu.pipeline.tuning``).

Capability parity with the reference's tuning package (reference:
core/src/main/java/com/alibaba/alink/pipeline/tuning/ — 3.5k LoC:
GridSearchCV.java, GridSearchTVSplit.java, RandomSearchCV.java, ParamGrid.java,
ParamDist.java, BinaryClassificationTuningEvaluator.java,
RegressionTuningEvaluator.java, MultiClassClassificationTuningEvaluator.java,
ClusterTuningEvaluator.java; BaseTuning.findBest / kFoldCv). BayesSearchCV is
a TPE-style sequential model-based search the reference lacks.

Candidates and splits are numpy drawn from ``default_rng(seed)``, as in
``alink_tpu``, so both packages try the same candidates on the same folds.

Parallelism: with ``num_threads > 1`` each candidate is applied to a deep
copy of the estimator (a stage holds params only: no device tensor and no
loaded mapper is copied) and (fit, transform, evaluate) runs in a thread
pool. Device work releases the GIL inside PyTorch, so candidates overlap on
the card; each operator reads its device from the session, never from a
thread-local default. The grid/random searches stay deterministic either
way: each candidate's score depends on its own fits only.
"""

from __future__ import annotations

import copy
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common.exceptions import AkIllegalArgumentException, AkIllegalStateException
from ..common.mtable import MTable
from ..common.params import ParamInfo
from ..operator.batch.base import TableSourceBatchOp
from ..operator.batch.evaluation import (
    EvalBinaryClassBatchOp,
    EvalClusterBatchOp,
    EvalMultiClassBatchOp,
    EvalRegressionBatchOp,
)
from .base import PipelineStageBase
from .pipeline import Pipeline, PipelineModel


class ParamGrid:
    """(reference: pipeline/tuning/ParamGrid.java)"""

    def __init__(self):
        self._items: List[Tuple[PipelineStageBase, ParamInfo, Sequence]] = []

    def add_grid(self, stage: PipelineStageBase, info: "ParamInfo | str", values):
        if isinstance(info, str):
            resolved = type(stage)._resolve_info(info)
            if resolved is None:
                raise AkIllegalArgumentException(
                    f"{type(stage).__name__} has no param {info!r}"
                )
            info = resolved
        self._items.append((stage, info, list(values)))
        return self

    def candidates(self):
        if not self._items:
            return [()]
        value_lists = [vals for _, _, vals in self._items]
        combos = []
        for values in itertools.product(*value_lists):
            combos.append(
                tuple((stage, info, v)
                      for (stage, info, _), v in zip(self._items, values))
            )
        return combos


class ParamDist:
    """Random distributions (reference: pipeline/tuning/ParamDist.java)."""

    def __init__(self):
        self._items: List[Tuple[PipelineStageBase, ParamInfo, Callable]] = []

    def add_dist(self, stage, info: "ParamInfo | str", sampler: "Callable | Sequence"):
        if isinstance(info, str):
            resolved = type(stage)._resolve_info(info)
            if resolved is None:
                raise AkIllegalArgumentException(
                    f"{type(stage).__name__} has no param {info!r}"
                )
            info = resolved
        if not callable(sampler):
            choices = list(sampler)

            def sampler(rng, _c=choices):
                return _c[rng.integers(len(_c))]

        self._items.append((stage, info, sampler))
        return self

    def sample(self, n: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        return [
            tuple((stage, info, sampler(rng)) for stage, info, sampler in self._items)
            for _ in range(n)
        ]


class TuningEvaluator:
    """metric extraction wrapper; larger_is_better decides argbest."""

    eval_cls = None
    metric_name: str = None
    larger_is_better = True

    def __init__(self, **eval_params):
        self.eval_params = eval_params
        metric = eval_params.pop("tuningMetric", None)
        if metric:
            self.metric_name = metric

    def evaluate(self, predicted: MTable) -> float:
        op = self.eval_cls(**self.eval_params).link_from(TableSourceBatchOp(predicted))
        return float(op.collect_metrics()[self.metric_name])


class BinaryClassificationTuningEvaluator(TuningEvaluator):
    eval_cls = EvalBinaryClassBatchOp
    metric_name = "AUC"


class MultiClassClassificationTuningEvaluator(TuningEvaluator):
    eval_cls = EvalMultiClassBatchOp
    metric_name = "Accuracy"


class RegressionTuningEvaluator(TuningEvaluator):
    eval_cls = EvalRegressionBatchOp
    metric_name = "RMSE"
    larger_is_better = False


class ClusterTuningEvaluator(TuningEvaluator):
    eval_cls = EvalClusterBatchOp
    metric_name = "CalinskiHarabasz"


class TuningResult:
    def __init__(self, best_model, best_params, reports):
        self.best_model: PipelineModel = best_model
        self.best_params = best_params
        self.reports: List[Dict[str, Any]] = reports

    def transform(self, data):
        return self.best_model.transform(data)


class _BaseSearch:
    def __init__(self, estimator, evaluator: TuningEvaluator, num_folds: int = 3,
                 train_ratio: Optional[float] = None, seed: int = 0,
                 num_threads: int = 1):
        self.estimator = estimator
        self.evaluator = evaluator
        self.num_folds = num_folds
        self.train_ratio = train_ratio
        self.seed = seed
        self.num_threads = num_threads

    def _candidates(self):
        raise NotImplementedError

    def _stage_list(self, est):
        return est.stages if isinstance(est, Pipeline) else [est]

    def _clone_with(self, combo):
        """Deep-copy the estimator and apply the combo to the clone (combo
        references the ORIGINAL stage objects; map by position)."""
        est = copy.deepcopy(self.estimator)
        pos = {id(s): i for i, s in enumerate(self._stage_list(self.estimator))}
        clones = self._stage_list(est)
        for stage, info, v in combo:
            clones[pos[id(stage)]].set(info, v)
        return est

    def _eval_candidate(self, combo, t: MTable) -> float:
        est = self._clone_with(combo)
        scores = [self._score_split(t, tr, te, est)
                  for tr, te in self._splits(t)]
        return float(np.mean(scores))

    def fit(self, data) -> TuningResult:
        t = data.collect() if not isinstance(data, MTable) else data
        candidates = list(self._candidates())
        if self.num_threads > 1:
            with ThreadPoolExecutor(self.num_threads) as pool:
                scores = list(pool.map(
                    lambda c: self._eval_candidate(c, t), candidates))
        else:
            scores = [self._eval_candidate(c, t) for c in candidates]
        return self._finish(t, candidates, scores)

    def _finish(self, t: MTable, candidates, scores) -> TuningResult:
        reports = []
        best_score, best_combo = None, None
        for combo, score in zip(candidates, scores):
            reports.append(
                {
                    "params": {f"{type(s).__name__}.{i.name}": v for s, i, v in combo},
                    "score": score,
                }
            )
            if np.isnan(score):
                # a fold with a degenerate metric must not lock in (or shadow)
                # a candidate — NaN never compares better than anything
                continue
            if best_score is None or (
                score > best_score if self.evaluator.larger_is_better else score < best_score
            ):
                best_score, best_combo = score, combo
        if best_combo is None:
            raise AkIllegalStateException(
                "all tuning candidates scored NaN; check the evaluator/folds"
            )
        for stage, info, v in best_combo:
            stage.set(info, v)
        best_model = self._fit_full(t)
        best_params = {f"{type(s).__name__}.{i.name}": v for s, i, v in best_combo}
        return TuningResult(best_model, best_params, reports)

    def _fit_full(self, t: MTable) -> PipelineModel:
        est = self.estimator
        if isinstance(est, Pipeline):
            return est.fit(t)
        model = est.fit(t)
        return PipelineModel(model)

    def _splits(self, t: MTable):
        n = t.num_rows
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        if self.train_ratio is not None:
            cut = int(n * self.train_ratio)
            yield perm[:cut], perm[cut:]
            return
        folds = np.array_split(perm, self.num_folds)
        for i in range(self.num_folds):
            test = folds[i]
            train = np.concatenate([f for j, f in enumerate(folds) if j != i])
            yield train, test

    def _score_split(self, t: MTable, train_idx, test_idx,
                     est=None) -> float:
        train_t, test_t = t.take(train_idx), t.take(test_idx)
        est = est if est is not None else self.estimator
        model = est.fit(train_t) if isinstance(est, Pipeline) else PipelineModel(
            est.fit(train_t)
        )
        predicted = model.transform(test_t).collect()
        return self.evaluator.evaluate(predicted)


class GridSearchCV(_BaseSearch):
    """(reference: pipeline/tuning/GridSearchCV.java)"""

    def __init__(self, estimator, param_grid: ParamGrid, evaluator, num_folds=3,
                 seed=0, num_threads=1):
        super().__init__(estimator, evaluator, num_folds=num_folds, seed=seed,
                         num_threads=num_threads)
        self.param_grid = param_grid

    def _candidates(self):
        return self.param_grid.candidates()


class GridSearchTVSplit(_BaseSearch):
    """(reference: pipeline/tuning/GridSearchTVSplit.java)"""

    def __init__(self, estimator, param_grid: ParamGrid, evaluator,
                 train_ratio=0.8, seed=0, num_threads=1):
        super().__init__(estimator, evaluator, train_ratio=train_ratio, seed=seed,
                         num_threads=num_threads)
        self.param_grid = param_grid

    def _candidates(self):
        return self.param_grid.candidates()


class RandomSearchCV(_BaseSearch):
    """(reference: pipeline/tuning/RandomSearchCV.java)"""

    def __init__(self, estimator, param_dist: ParamDist, evaluator,
                 num_candidates=10, num_folds=3, seed=0, num_threads=1):
        super().__init__(estimator, evaluator, num_folds=num_folds, seed=seed,
                         num_threads=num_threads)
        self.param_dist = param_dist
        self.num_candidates = num_candidates

    def _candidates(self):
        return self.param_dist.sample(self.num_candidates, seed=self.seed)


class RandomSearchTVSplit(_BaseSearch):
    """(reference: pipeline/tuning/RandomSearchTVSplit.java)"""

    def __init__(self, estimator, param_dist: ParamDist, evaluator,
                 num_candidates=10, train_ratio=0.8, seed=0, num_threads=1):
        super().__init__(estimator, evaluator, train_ratio=train_ratio, seed=seed,
                         num_threads=num_threads)
        self.param_dist = param_dist
        self.num_candidates = num_candidates

    def _candidates(self):
        return self.param_dist.sample(self.num_candidates, seed=self.seed)


class ParamRange:
    """Search space for Bayes search: continuous/integer ranges (optionally
    log-scaled) and categorical choices."""

    def __init__(self):
        self._items: List[Tuple] = []

    def add_range(self, stage, info: "ParamInfo | str", low, high,
                  log: bool = False, integer: bool = False):
        if isinstance(info, str):
            info = type(stage)._resolve_info(info)
        self._items.append((stage, info, ("range", float(low), float(high),
                                          log, integer)))
        return self

    def add_choices(self, stage, info: "ParamInfo | str", values):
        if isinstance(info, str):
            info = type(stage)._resolve_info(info)
        self._items.append((stage, info, ("choice", list(values))))
        return self


class BayesSearchCV(_BaseSearch):
    """TPE-style sequential model-based search: after ``num_initial`` random
    draws, each next candidate maximizes the good/bad kernel-density ratio of
    the observations so far (Bergstra et al. 2011). The reference tuning
    package has grid/random only — this is the Bayes slot its docs leave
    open."""

    def __init__(self, estimator, param_range: ParamRange, evaluator,
                 num_candidates=20, num_initial=5, gamma=0.3, num_folds=3,
                 seed=0, num_threads=1):
        super().__init__(estimator, evaluator, num_folds=num_folds, seed=seed,
                         num_threads=num_threads)
        self.param_range = param_range
        self.num_candidates = num_candidates
        self.num_initial = max(2, num_initial)
        self.gamma = gamma

    # -- sampling helpers (stateless: shared by TreeParzenEstimator and
    # PipelineCandidatesBayes without constructing a search object) --------
    @staticmethod
    def _draw(rng, spec):
        if spec[0] == "choice":
            return spec[1][rng.integers(len(spec[1]))]
        _, low, high, log, integer = spec
        if log:
            v = float(np.exp(rng.uniform(np.log(low), np.log(high))))
        else:
            v = float(rng.uniform(low, high))
        return int(round(v)) if integer else v

    @staticmethod
    def _split_good_bad(observations, gamma, larger_is_better):
        """observations: [(values, score)] -> (good values, bad values)."""
        ordered = sorted(observations, key=lambda o: o[1],
                         reverse=larger_is_better)
        n_good = max(1, int(np.ceil(gamma * len(ordered))))
        return [o[0] for o in ordered[:n_good]], [o[0] for o in ordered[n_good:]]

    @staticmethod
    def _tpe_draw(rng, spec, good_vals, bad_vals):
        if spec[0] == "choice":
            choices = spec[1]
            counts = np.ones(len(choices))
            for v in good_vals:
                counts[choices.index(v)] += 1
            return choices[rng.choice(len(choices), p=counts / counts.sum())]
        _, low, high, log, integer = spec
        to_s = np.log if log else (lambda x: np.asarray(x, float))
        from_s = np.exp if log else (lambda x: x)
        g = to_s(np.asarray(good_vals, float))
        b = to_s(np.asarray(bad_vals, float)) if len(bad_vals) else g
        bw = max(g.std(), (to_s(high) - to_s(low)) * 0.05, 1e-12)

        def kde(x, centers):
            z = (x[:, None] - centers[None, :]) / bw
            return np.exp(-0.5 * z * z).mean(axis=1) + 1e-12

        # propose from the good KDE, keep the best good/bad density ratio
        props = rng.choice(g, size=32) + bw * rng.standard_normal(32)
        props = np.clip(props, to_s(low), to_s(high))
        ratio = kde(props, g) / kde(props, b)
        v = float(from_s(props[int(np.argmax(ratio))]))
        v = min(max(v, low), high)
        return int(round(v)) if integer else v

    def fit(self, data) -> TuningResult:
        t = data.collect() if not isinstance(data, MTable) else data
        rng = np.random.default_rng(self.seed)
        items = self.param_range._items
        observed: List[Tuple[tuple, float]] = []
        candidates, scores = [], []
        for k in range(self.num_candidates):
            if k < self.num_initial or not observed:
                values = tuple(self._draw(rng, spec) for _, _, spec in items)
            else:
                good, bad = self._split_good_bad(
                    observed, self.gamma, self.evaluator.larger_is_better)
                values = tuple(
                    self._tpe_draw(rng, spec,
                                   [gv[i] for gv in good],
                                   [bv[i] for bv in bad])
                    for i, (_, _, spec) in enumerate(items))
            combo = tuple((stage, info, v)
                          for (stage, info, _), v in zip(items, values))
            score = self._eval_candidate(combo, t)
            candidates.append(combo)
            scores.append(score)
            if not np.isnan(score):
                observed.append((values, score))
        return self._finish(t, candidates, scores)


class BayesSearchTVSplit(BayesSearchCV):
    """TPE search evaluated on one train/validation split instead of CV
    (reference: pipeline/tuning/* TVSplit family; Bayes slot as in
    BayesSearchCV)."""

    def __init__(self, estimator, param_range: ParamRange, evaluator,
                 num_candidates=20, num_initial=5, gamma=0.3,
                 train_ratio=0.8, seed=0, num_threads=1):
        super().__init__(estimator, param_range, evaluator,
                         num_candidates=num_candidates,
                         num_initial=num_initial, gamma=gamma, seed=seed,
                         num_threads=num_threads)
        self.train_ratio = train_ratio


class GaussianProcessRegression:
    """RBF-kernel GP regressor on small design matrices — the surrogate
    model the reference ships for tuning (reference:
    pipeline/tuning/GaussianProcessRegression.java). fit(X, y) then
    predict(X*) -> (mean, std)."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-6):
        self.length_scale = float(length_scale)
        self.noise = float(noise)
        self._X = self._alpha = self._L = None

    @staticmethod
    def _as_design(X):
        X = np.asarray(X, float)
        return X[:, None] if X.ndim == 1 else X

    def _kernel(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.length_scale ** 2))

    def fit(self, X, y):
        X = self._as_design(X)
        y = np.asarray(y, float)
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))
        self._X = X
        return self

    def predict(self, Xs):
        Xs = self._as_design(Xs)
        Ks = self._kernel(Xs, self._X)
        mean = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mean, np.sqrt(var)


class TreeParzenEstimator:
    """The TPE proposal rule as a standalone component (reference names it
    pipeline/tuning/TreeParzenEstimator.java; BayesSearchCV embeds the same
    good/bad KDE-ratio logic)."""

    def __init__(self, gamma: float = 0.3, seed: int = 0):
        self.gamma = gamma
        self._rng = np.random.default_rng(seed)

    def propose(self, spec, observations, larger_is_better=True):
        """spec: ("range", low, high, log, integer) or ("choice", values);
        observations: [(value, score)]. Returns the next value to try."""
        if not observations:
            return BayesSearchCV._draw(self._rng, spec)
        good, bad = BayesSearchCV._split_good_bad(
            observations, self.gamma, larger_is_better)
        return BayesSearchCV._tpe_draw(self._rng, spec, good, bad)


class Report:
    """Per-candidate tuning report (reference: pipeline/tuning/Report.java)."""

    def __init__(self, result: TuningResult):
        self.items = result.reports

    def to_list(self):
        return list(self.items)

    def __str__(self):
        return "\n".join(
            f"{i}: score={r['score']} params={r['params']}"
            for i, r in enumerate(self.items))


# reference fit() returns a XxxModel; TuningResult IS that model here — the
# named classes keep the reference's type surface
class BaseTuning(_BaseSearch):
    pass


class BaseGridSearch(GridSearchCV):
    pass


class BaseRandomSearch(RandomSearchCV):
    pass


class BaseBayesSearch(BayesSearchCV):
    pass


class BaseTuningModel(TuningResult):
    pass


class GridSearchCVModel(TuningResult):
    pass


class GridSearchTVSplitModel(TuningResult):
    pass


class RandomSearchCVModel(TuningResult):
    pass


class RandomSearchTVSplitModel(TuningResult):
    pass


class BayesSearchCVModel(TuningResult):
    pass


class BayesSearchTVSplitModel(TuningResult):
    pass
