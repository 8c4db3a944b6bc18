"""Stream operator layer — micro-batch streaming runtime (the core, the
foreign-model predict ops, online learning, evaluation, the relational
ops and sources, the connectors and the checkpoint tiers; the windows, the
file sources and the per-chunk twins of ``alink_tpu.operator.stream`` are
ROADMAP A7's next part)."""

from .base import (
    CsvSourceStreamOp,
    MapStreamOp,
    ModelMapStreamOp,
    StreamOperator,
    TableSourceStreamOp,
)
from .evaluation import EvalBinaryClassStreamOp, SummarizerStreamOp
from .modelstream import (
    FileModelStreamSink,
    ModelStreamFileSourceStreamOp,
    scan_model_dir,
)
from .modelpredict import (
    OnnxModelPredictStreamOp,
    StableHloModelPredictStreamOp,
    TFSavedModelPredictStreamOp,
    TorchModelPredictStreamOp,
)
from .onlinelearning import (
    BinaryClassModelFilterStreamOp,
    FtrlPredictStreamOp,
    FtrlTrainStreamOp,
    OnlineFmPredictStreamOp,
    OnlineFmTrainStreamOp,
    OnlineLearningStreamOp,
)
from .checkpoint import (
    AckCheckpointStreamOp,
    CheckpointCoordinator,
    CheckpointedSourceStreamOp,
    RecoverableStreamJob,
    SnapshotStore,
    StreamCheckpoint,
    TransactionalSink,
    run_with_recovery,
)
from .connectors import (
    DatahubSinkStreamOp,
    DatahubSourceStreamOp,
    GenerateFeatureOfWindowStreamOp,
    KafkaSinkStreamOp,
    KafkaSourceStreamOp,
    KvSinkStreamOp,
    LookupKvStreamOp,
)
from .relational import (
    AppendIdStreamOp,
    AsStreamOp,
    FilterStreamOp,
    MemSourceStreamOp,
    NumSeqSourceStreamOp,
    PrintStreamOp,
    RandomTableSourceStreamOp,
    RandomVectorSourceStreamOp,
    RebalanceStreamOp,
    SampleStreamOp,
    SelectStreamOp,
    SpeedControlStreamOp,
    SplitStreamOp,
    StratifiedSampleStreamOp,
    UnionAllStreamOp,
    WhereStreamOp,
)

__all__ = [
    "CsvSourceStreamOp",
    "MapStreamOp",
    "ModelMapStreamOp",
    "StreamOperator",
    "TableSourceStreamOp",
    "FileModelStreamSink",
    "ModelStreamFileSourceStreamOp",
    "scan_model_dir",
    "EvalBinaryClassStreamOp",
    "SummarizerStreamOp",
    "OnnxModelPredictStreamOp",
    "StableHloModelPredictStreamOp",
    "TFSavedModelPredictStreamOp",
    "TorchModelPredictStreamOp",
    "BinaryClassModelFilterStreamOp",
    "OnlineFmPredictStreamOp",
    "OnlineFmTrainStreamOp",
    "OnlineLearningStreamOp",
    "FtrlPredictStreamOp",
    "FtrlTrainStreamOp",
    "AckCheckpointStreamOp",
    "CheckpointedSourceStreamOp",
    "StreamCheckpoint",
    "DatahubSinkStreamOp",
    "DatahubSourceStreamOp",
    "GenerateFeatureOfWindowStreamOp",
    "KafkaSinkStreamOp",
    "KafkaSourceStreamOp",
    "KvSinkStreamOp",
    "LookupKvStreamOp",
    "AppendIdStreamOp", "AsStreamOp", "FilterStreamOp", "MemSourceStreamOp",
    "NumSeqSourceStreamOp", "PrintStreamOp", "RandomTableSourceStreamOp",
    "RandomVectorSourceStreamOp", "RebalanceStreamOp", "SampleStreamOp",
    "SelectStreamOp", "SpeedControlStreamOp", "SplitStreamOp",
    "StratifiedSampleStreamOp", "UnionAllStreamOp", "WhereStreamOp",
]
