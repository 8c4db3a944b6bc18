"""User-script execution ops — the TensorFlow2BatchOp analog (port of
``alink_tpu.operator.batch.script``).

Capability parity (reference: operator/batch/tensorflow/TensorFlow2BatchOp.java
+ TensorFlowBatchOp.java — an arbitrary user training script is shipped to a
formed TF cluster via DLLauncherBatchOp with dataset + TaskContext handed in;
params/dl/HasMainScriptFile.java, HasUserFiles.java, HasUserParams.java).

Re-design: there is no cluster to form — the "cluster" is the session's
device. The user supplies a script (``mainScriptFile`` path, or ``userFn``
as a live callable, python-first) defining ``main(ctx)``; the op hands it a
:class:`ScriptContext` carrying the session's one-rank device handle
(:class:`~alink_tpu_torch.parallel.mesh.DeviceMesh`, where the reference
hands its JAX mesh), a batched dataset iterator over the input table(s),
the parsed ``userParams``, and an ``output`` hook. Whatever the script
outputs (MTable / dict of columns / a DataFrame-like object) becomes the
op output. The script brings its own framework: the op imports none. The
legacy ``func`` shim hands the user a pandas DataFrame, and the port
imports no pandas: it raises the missing-plugin exception.
"""

from __future__ import annotations

import importlib.util
import json
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ...common.exceptions import (AkIllegalArgumentException,
                                  AkPluginNotExistException)
from ...common.mtable import MTable, TableSchema
from ...common.params import ParamInfo
from ...parallel.mesh import DeviceMesh
from .base import BatchOperator


class ScriptContext:
    """What the user ``main`` receives (the TaskContext analog)."""

    def __init__(self, inputs: List[MTable], mesh, user_params: dict,
                 batch_size: int, num_epochs: int):
        self.inputs = inputs
        self.mesh = mesh
        self.user_params = user_params
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self._output: Optional[MTable] = None

    # -- data ---------------------------------------------------------------
    def table(self, i: int = 0) -> MTable:
        return self.inputs[i]

    def dataset(self, batch_size: Optional[int] = None,
                epochs: Optional[int] = None, input_index: int = 0,
                cols: Optional[List[str]] = None,
                shuffle_seed: Optional[int] = 0,
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batched epoch iterator over an input table — the akdl
        dataset-from-TFRecords analog, without the file hop."""
        t = self.inputs[input_index]
        names = cols or t.names
        arrays = {n: np.asarray(t.col(n)) for n in names}
        n = t.num_rows
        bs = batch_size or self.batch_size
        rng = (np.random.default_rng(shuffle_seed)
               if shuffle_seed is not None else None)
        for _ in range(epochs or self.num_epochs):
            idx = rng.permutation(n) if rng is not None else np.arange(n)
            for s in range(0, n, bs):
                take = idx[s:s + bs]
                yield {k: v[take] for k, v in arrays.items()}

    # -- output ---------------------------------------------------------------
    def output(self, table) -> None:
        self._output = _coerce_table(table)


def _coerce_table(obj) -> MTable:
    if isinstance(obj, MTable):
        return obj
    if obj is None:
        return MTable({})
    if isinstance(obj, dict):
        return MTable({k: np.asarray(v) for k, v in obj.items()})
    if hasattr(obj, "columns") and hasattr(obj, "to_dict"):  # DataFrame
        return MTable({c: np.asarray(obj[c]) for c in obj.columns})
    raise AkIllegalArgumentException(
        f"script output must be MTable / dict / DataFrame, got {type(obj)}")


def _load_main(path: str) -> Callable:
    spec = importlib.util.spec_from_file_location("alink_user_script", path)
    if spec is None or spec.loader is None:
        raise AkIllegalArgumentException(f"cannot load script {path!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    main = getattr(mod, "main", None)
    if main is None:
        raise AkIllegalArgumentException(
            f"script {path!r} must define main(ctx)")
    return main


class JaxScriptBatchOp(BatchOperator):
    """Run a user script against the session's device + input tables.

    The script's ``main(ctx)`` gets a :class:`ScriptContext`; its return
    value (or ``ctx.output(...)``) becomes the op output (reference:
    operator/batch/tensorflow/TensorFlow2BatchOp.java — same role; the
    name is the reference's, the script may use any framework)."""

    MAIN_SCRIPT_FILE = ParamInfo("mainScriptFile", str)
    USER_FN = ParamInfo("userFn", object,
                        desc="main(ctx) as a live callable (python-first "
                             "alternative to mainScriptFile)")
    USER_PARAMS = ParamInfo("userParams", str, default="{}",
                            desc="JSON dict handed to the script")
    BATCH_SIZE = ParamInfo("batchSize", int, default=128)
    NUM_EPOCHS = ParamInfo("numEpochs", int, default=1)
    OUTPUT_SCHEMA_STR = ParamInfo(
        "outputSchemaStr", str,
        desc="declared output schema; default: derived from the output")
    # legacy shim: the pre-round-4 alias contract (a per-table pandas fn)
    FUNC = ParamInfo("func", object)

    _min_inputs = 0
    _max_inputs = 8

    def _resolve_main(self) -> Callable:
        fn = self.get(self.USER_FN)
        if fn is not None:
            return fn
        path = self.get(self.MAIN_SCRIPT_FILE)
        if path:
            return _load_main(path)
        if self.get(self.FUNC) is not None:
            # old TensorFlowBatchOp-alias behavior: the fn takes the whole
            # table as a pandas DataFrame
            raise AkPluginNotExistException(
                f"{type(self).__name__}(func=...) hands the table to func as "
                "a DataFrame of the 'pandas' package, which the port does "
                "not depend on; pass userFn=main(ctx) instead")
        raise AkIllegalArgumentException(
            "set mainScriptFile, userFn, or func")

    def _run(self, ins) -> MTable:
        main = self._resolve_main()
        try:
            user_params = json.loads(self.get(self.USER_PARAMS) or "{}")
        except ValueError as e:
            raise AkIllegalArgumentException(
                f"userParams must be a JSON object: {e}")
        ctx = ScriptContext(
            list(ins), DeviceMesh(self.env.device), user_params,
            self.get(self.BATCH_SIZE), self.get(self.NUM_EPOCHS))
        ret = main(ctx)
        out = ctx._output if ctx._output is not None else _coerce_table(ret)
        declared = self.get(self.OUTPUT_SCHEMA_STR)
        if declared:
            want = TableSchema.parse(declared)
            if list(want.names) != list(out.names):
                raise AkIllegalArgumentException(
                    f"script produced columns {out.names}, outputSchemaStr "
                    f"declares {want.names}")
            out = MTable({n: out.col(n) for n in want.names}, want)
        return out

    def _execute_impl(self, *ins: MTable) -> MTable:
        return self._run(ins)

    def _out_schema(self, *in_schemas):
        declared = self.get(self.OUTPUT_SCHEMA_STR)
        if declared:
            return TableSchema.parse(declared)
        if self.get(self.FUNC) is not None:
            # legacy pandas-fn shim: cheap + side-effect-free, probe it
            return super()._out_schema(*in_schemas)
        # a user TRAINING script must not run at schema-access time (it may
        # checkpoint, log externally, or assert non-empty data)
        from ...common.exceptions import AkIllegalOperationException

        raise AkIllegalOperationException(
            "JaxScriptBatchOp needs outputSchemaStr for static schema "
            "derivation — the user script is not probed with empty inputs")
