"""Pipeline layer of the port (``alink_tpu.pipeline``): Pipeline,
PipelineModel, LocalPredictor and the stages whose operators the port has."""

from .base import EstimatorBase, ModelBase, PipelineStageBase, TransformerBase
from . import estimators as _estimators
from .estimators import (
    C45,
    C45Model,
    Cart,
    CartModel,
    DecisionTreeClassifier,
    DecisionTreeModel,
    GbdtClassifier,
    GbdtModel,
    GbdtRegModel,
    GbdtRegressor,
    Id3,
    Id3Model,
    KMeans,
    KMeansModel,
    Lasso,
    LinearModel,
    LinearRegression,
    LinearSvm,
    LinearSvr,
    LogisticRegression,
    RandomForestClassifier,
    RandomForestModel,
    Ridge,
    Softmax,
    Word2Vec,
    Word2VecModel,
)
from .local_predictor import LocalPredictor
from .pipeline import Pipeline, PipelineModel

# the generated stages (estimators.GENERATED) and their models
globals().update({n: getattr(_estimators, n) for n in (
    *_estimators.GENERATED, *(m for *_, m in _estimators.GENERATED.values()),
    *_estimators.GENERATED_MODELS)})

__all__ = [
    "DecisionTreeClassifier", "DecisionTreeModel", "EstimatorBase",
    "GbdtClassifier", "GbdtModel", "GbdtRegModel", "GbdtRegressor", "KMeans",
    "KMeansModel", "Lasso", "LinearModel", "LinearRegression", "LinearSvm",
    "LinearSvr", "LocalPredictor", "LogisticRegression", "ModelBase",
    "Pipeline", "PipelineModel", "PipelineStageBase", "RandomForestClassifier",
    "RandomForestModel", "Ridge", "Softmax", "TransformerBase", "Word2Vec",
    "Word2VecModel", "C45", "C45Model", "Cart", "CartModel", "Id3",
    "Id3Model",
    *_estimators.GENERATED,
    *(m for *_, m in _estimators.GENERATED.values()),
    *_estimators.GENERATED_MODELS,
]
