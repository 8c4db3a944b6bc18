"""Tree ensembles: histogram GBDT + RandomForest + DecisionTree (port of
``alink_tpu/tree``).

(reference: core/src/main/java/com/alibaba/alink/operator/common/tree/ —
parallelcart/BaseGbdtTrainBatchOp.java:408 histogram boosting,
ConstructLocalHistogram.java, CalcFeatureGain.java split search,
BaseRandomForestTrainBatchOp.java:221 forest growth.)

Quantile binning once up front on the host; level-wise growth of perfect
binary trees; the forest's per-level histograms run the hand-written CUDA
kernel ``tree_histogram`` (:mod:`.hist_cuda`) on the card. The impurity
trees (:func:`train_tree_impurity`) are not ported yet.
"""

from .binning import apply_bins, quantile_bins
from .grow import TreeEnsemble, train_forest, train_gbdt, train_tree_impurity

__all__ = [
    "quantile_bins",
    "apply_bins",
    "TreeEnsemble",
    "train_gbdt",
    "train_forest",
    "train_tree_impurity",
]
