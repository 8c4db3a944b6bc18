"""Pipeline layer of the port (``alink_tpu.pipeline``): Pipeline,
PipelineModel, LocalPredictor and the stages whose operators the port has."""

from .base import EstimatorBase, ModelBase, PipelineStageBase, TransformerBase
from .estimators import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    GbdtClassifier,
    GbdtModel,
    GbdtRegModel,
    GbdtRegressor,
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

__all__ = [
    "DecisionTreeClassifier", "DecisionTreeModel", "EstimatorBase",
    "GbdtClassifier", "GbdtModel", "GbdtRegModel", "GbdtRegressor", "KMeans",
    "KMeansModel", "Lasso", "LinearModel", "LinearRegression", "LinearSvm",
    "LinearSvr", "LocalPredictor", "LogisticRegression", "ModelBase",
    "Pipeline", "PipelineModel", "PipelineStageBase", "RandomForestClassifier",
    "RandomForestModel", "Ridge", "Softmax", "TransformerBase", "Word2Vec",
    "Word2VecModel",
]
