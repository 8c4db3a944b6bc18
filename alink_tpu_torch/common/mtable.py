"""MTable — the framework's in-memory table (a copy of
``alink_tpu.common.mtable`` with a torch device bridge).

Capability parity with the reference's ``MTable`` (reference:
core/src/main/java/com/alibaba/alink/common/MTable.java:1-833 — List<Row> + schema,
Kryo-serializable, printable/sortable), re-designed **columnar**: each column is a
numpy array (typed for numerics/strings, object-dtype for vectors/tensors/nested
tables), because the device data path wants contiguous column blocks, not row objects.

Key bridge methods:
- :meth:`MTable.to_device` — ship numeric/vector columns to the device as one dense
  ``torch.Tensor`` block (the single host→device boundary of the framework),
- row-oriented views (``rows()``, ``get_row``) kept for API/docs parity with the
  reference's row model.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .exceptions import (
    AkColumnNotFoundException,
    AkIllegalArgumentException,
    AkIllegalDataException,
)
from .linalg import DenseVector, SparseVector, parse_vector, stack_vectors

# ---------------------------------------------------------------------------
# Type tags (reference: common/AlinkTypes / linalg tensor family)
# ---------------------------------------------------------------------------


class AlinkTypes:
    DOUBLE = "DOUBLE"
    FLOAT = "FLOAT"
    LONG = "LONG"
    INT = "INT"
    BOOLEAN = "BOOLEAN"
    STRING = "STRING"
    DENSE_VECTOR = "DENSE_VECTOR"
    SPARSE_VECTOR = "SPARSE_VECTOR"
    VECTOR = "VECTOR"
    TENSOR = "TENSOR"
    MTABLE = "MTABLE"

    _NUMERIC = {DOUBLE, FLOAT, LONG, INT, BOOLEAN}

    @classmethod
    def is_numeric(cls, t: str) -> bool:
        return t in cls._NUMERIC

    @classmethod
    def is_vector(cls, t: str) -> bool:
        return t in (cls.DENSE_VECTOR, cls.SPARSE_VECTOR, cls.VECTOR)


_NP_OF_TYPE = {
    AlinkTypes.DOUBLE: np.float64,
    AlinkTypes.FLOAT: np.float32,
    AlinkTypes.LONG: np.int64,
    AlinkTypes.INT: np.int32,
    AlinkTypes.BOOLEAN: np.bool_,
}


def _infer_type(col: np.ndarray) -> str:
    if col.dtype == np.float64:
        return AlinkTypes.DOUBLE
    if col.dtype == np.float32:
        return AlinkTypes.FLOAT
    if col.dtype == np.int64:
        return AlinkTypes.LONG
    if col.dtype == np.int32:
        return AlinkTypes.INT
    if col.dtype == np.bool_:
        return AlinkTypes.BOOLEAN
    if col.dtype.kind in ("U", "S"):
        return AlinkTypes.STRING
    if col.dtype == object:
        for v in col:
            if v is None:
                continue
            if isinstance(v, DenseVector):
                return AlinkTypes.DENSE_VECTOR
            if isinstance(v, SparseVector):
                return AlinkTypes.SPARSE_VECTOR
            if isinstance(v, MTable):
                return AlinkTypes.MTABLE
            if isinstance(v, np.ndarray):
                return AlinkTypes.TENSOR
            if isinstance(v, str):
                return AlinkTypes.STRING
            if isinstance(v, bool):
                return AlinkTypes.BOOLEAN
            if isinstance(v, (int, np.integer)):
                return AlinkTypes.LONG
            if isinstance(v, (float, np.floating)):
                return AlinkTypes.DOUBLE
        return AlinkTypes.STRING
    if col.dtype.kind == "i":
        return AlinkTypes.LONG
    if col.dtype.kind == "f":
        return AlinkTypes.DOUBLE
    raise AkIllegalDataException(f"cannot infer Alink type for dtype {col.dtype}")


class TableSchema:
    """Ordered (name, type-tag) pairs (reference: Flink TableSchema as used in MTable)."""

    def __init__(self, names: Sequence[str], types: Sequence[str]):
        if len(names) != len(set(names)):
            raise AkIllegalArgumentException(f"duplicate column names: {list(names)}")
        if len(names) != len(types):
            raise AkIllegalArgumentException("schema names/types length mismatch")
        self.names: List[str] = list(names)
        self.types: List[str] = list(types)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise AkColumnNotFoundException(
                f"column {name!r} not in {self.names}"
            ) from None

    def type_of(self, name: str) -> str:
        return self.types[self.index_of(name)]

    def select(self, names: Sequence[str]) -> "TableSchema":
        return TableSchema(list(names), [self.type_of(n) for n in names])

    @staticmethod
    def parse(spec: str) -> "TableSchema":
        """Parse ``"f0 double, f1 string"``-style schema strings (reference:
        TableUtil.schemaStr2Schema)."""
        names, types = [], []
        for part in spec.split(","):
            toks = part.strip().split()
            if len(toks) != 2:
                raise AkIllegalArgumentException(f"bad schema fragment {part!r}")
            names.append(toks[0])
            types.append(_TYPE_ALIASES.get(toks[1].upper(), toks[1].upper()))
        return TableSchema(names, types)

    def to_str(self) -> str:
        return ", ".join(f"{n} {t}" for n, t in zip(self.names, self.types))

    def __eq__(self, other):
        return (
            isinstance(other, TableSchema)
            and self.names == other.names
            and self.types == other.types
        )

    def __repr__(self):
        return f"TableSchema({self.to_str()})"


_TYPE_ALIASES = {
    "DOUBLE": AlinkTypes.DOUBLE,
    "FLOAT": AlinkTypes.FLOAT,
    "BIGINT": AlinkTypes.LONG,
    "LONG": AlinkTypes.LONG,
    "INT": AlinkTypes.INT,
    "INTEGER": AlinkTypes.INT,
    "BOOLEAN": AlinkTypes.BOOLEAN,
    "BOOL": AlinkTypes.BOOLEAN,
    "STRING": AlinkTypes.STRING,
    "VARCHAR": AlinkTypes.STRING,
    "DENSE_VECTOR": AlinkTypes.DENSE_VECTOR,
    "SPARSE_VECTOR": AlinkTypes.SPARSE_VECTOR,
    "VECTOR": AlinkTypes.VECTOR,
    "TENSOR": AlinkTypes.TENSOR,
    "MTABLE": AlinkTypes.MTABLE,
}


class MTable:
    """Columnar in-memory table."""

    def __init__(
        self,
        columns: "Dict[str, Any] | None" = None,
        schema: "TableSchema | str | None" = None,
    ):
        if isinstance(schema, str):
            schema = TableSchema.parse(schema)
        cols: Dict[str, np.ndarray] = {}
        if columns:
            n = None
            for name, col in columns.items():
                arr = _as_column(col)
                if n is None:
                    n = arr.shape[0]
                elif arr.shape[0] != n:
                    raise AkIllegalDataException(
                        f"column {name!r} length {arr.shape[0]} != {n}"
                    )
                cols[name] = arr
        if schema is None:
            names = list(cols.keys())
            types = [_infer_type(cols[n]) for n in names]
            schema = TableSchema(names, types)
        else:
            # reorder/cast columns to schema
            ordered: Dict[str, np.ndarray] = {}
            for name, t in zip(schema.names, schema.types):
                if name not in cols:
                    raise AkColumnNotFoundException(f"schema column {name!r} missing")
                ordered[name] = _cast_column(cols[name], t)
            cols = ordered
        self._cols = cols
        self.schema = schema

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[Sequence[Any]], schema: "TableSchema | str") -> "MTable":
        if isinstance(schema, str):
            schema = TableSchema.parse(schema)
        ncol = len(schema.names)
        cols: Dict[str, list] = {n: [] for n in schema.names}
        for r in rows:
            if len(r) != ncol:
                raise AkIllegalDataException(f"row arity {len(r)} != schema arity {ncol}")
            for n, v in zip(schema.names, r):
                cols[n].append(v)
        return MTable(cols, schema)

    @staticmethod
    def from_dataframe(df) -> "MTable":
        cols = {str(c): df[c].to_numpy() for c in df.columns}
        return MTable(cols)

    @staticmethod
    def empty(schema: "TableSchema | str") -> "MTable":
        """Zero-row table with correctly-typed columns — the probe input for
        static schema derivation (ops run on it produce schemas, not data)."""
        if isinstance(schema, str):
            schema = TableSchema.parse(schema)
        cols = {
            n: np.empty(0, dtype=_NP_OF_TYPE.get(t, object))
            for n, t in zip(schema.names, schema.types)
        }
        return MTable(cols, schema)

    # -- basic accessors ---------------------------------------------------
    @property
    def num_rows(self) -> int:
        return next(iter(self._cols.values())).shape[0] if self._cols else 0

    @property
    def num_cols(self) -> int:
        return len(self.schema.names)

    @property
    def names(self) -> List[str]:
        return self.schema.names

    def col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise AkColumnNotFoundException(f"column {name!r} not in {self.names}")
        return self._cols[name]

    def get_row(self, i: int) -> Tuple:
        return tuple(self._cols[n][i] for n in self.names)

    def rows(self) -> Iterable[Tuple]:
        for i in range(self.num_rows):
            yield self.get_row(i)

    def to_rows(self) -> List[Tuple]:
        return list(self.rows())

    # -- relational ops (columnar, zero-copy where possible) ---------------
    def select(self, names: "Sequence[str] | str") -> "MTable":
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        return MTable({n: self.col(n) for n in names}, self.schema.select(names))

    def drop(self, names: Sequence[str]) -> "MTable":
        keep = [n for n in self.names if n not in set(names)]
        return self.select(keep)

    def with_column(self, name: str, col, type_tag: Optional[str] = None) -> "MTable":
        arr = _as_column(col)
        t = type_tag or _infer_type(arr)
        if name in self._cols:
            names = list(self.names)
            types = [t if n == name else ty for n, ty in zip(names, self.schema.types)]
        else:
            names = self.names + [name]
            types = self.schema.types + [t]
        cols = dict(self._cols)
        cols[name] = arr
        return MTable(cols, TableSchema(names, types))

    def rename(self, mapping: Dict[str, str]) -> "MTable":
        names = [mapping.get(n, n) for n in self.names]
        return MTable(
            {mapping.get(n, n): c for n, c in self._cols.items()},
            TableSchema(names, list(self.schema.types)),
        )

    def filter_mask(self, mask: np.ndarray) -> "MTable":
        mask = np.asarray(mask)
        return MTable({n: c[mask] for n, c in self._cols.items()}, self.schema)

    def take(self, indices: np.ndarray) -> "MTable":
        indices = np.asarray(indices, dtype=np.int64)
        return MTable({n: c[indices] for n, c in self._cols.items()}, self.schema)

    def head(self, n: int) -> "MTable":
        return self.take(np.arange(min(n, self.num_rows)))

    def slice(self, start: int, stop: int) -> "MTable":
        start = max(start, 0)
        stop = min(stop, self.num_rows)
        return self.take(np.arange(start, max(stop, start)))

    def sort_by(self, name: str, ascending: bool = True) -> "MTable":
        order = np.argsort(self.col(name), kind="stable")
        if not ascending:
            order = order[::-1]
        return self.take(order)

    def sample(self, ratio: float, seed: int = 0) -> "MTable":
        rng = np.random.default_rng(seed)
        mask = rng.random(self.num_rows) < ratio
        return self.filter_mask(mask)

    def shuffle(self, seed: int = 0) -> "MTable":
        rng = np.random.default_rng(seed)
        return self.take(rng.permutation(self.num_rows))

    @staticmethod
    def concat(tables: Sequence["MTable"]) -> "MTable":
        if not tables:
            raise AkIllegalArgumentException("concat of zero tables")
        first = tables[0]
        for t in tables[1:]:
            if t.schema.names != first.schema.names:
                raise AkIllegalDataException("concat schema mismatch")
        return MTable(
            {n: np.concatenate([t._cols[n] for t in tables]) for n in first.names},
            first.schema,
        )

    def split_at(self, i: int) -> Tuple["MTable", "MTable"]:
        idx = np.arange(self.num_rows)
        return self.take(idx[:i]), self.take(idx[i:])

    # -- device bridge -----------------------------------------------------
    def to_numeric_block(
        self, names: Sequence[str], dtype=np.float32, vector_size: Optional[int] = None
    ) -> np.ndarray:
        """Gather numeric + vector columns into one dense ``(n, d)`` block.
        Vector columns expand to their (padded) width; this is the host-side
        staging step before a single host→device transfer. Memoized per
        instance (columns are immutable after construction), so repeated
        jobs over the same table skip the concatenate.

        The returned array is **read-only and shared**: the same buffer is
        handed to every caller (including concurrent DAG-executor nodes) and
        keyed into the device staging cache by identity, so an in-place
        mutation would silently corrupt every other job's view and desync
        the staged copy. The write flag is cleared — mutating raises
        ``ValueError``; callers that need a scratch buffer must ``copy()``."""
        memo_key = (tuple(names), np.dtype(dtype).str, vector_size)
        memo = getattr(self, "_block_memo", None)
        if memo is None:
            memo = {}
            object.__setattr__(self, "_block_memo", memo)
        cached = memo.get(memo_key)
        if cached is not None:
            return cached
        blocks = []
        for n in names:
            t = self.schema.type_of(n)
            c = self._cols[n]
            if AlinkTypes.is_numeric(t):
                blocks.append(np.asarray(c, dtype=dtype).reshape(-1, 1))
            elif AlinkTypes.is_vector(t) or t == AlinkTypes.STRING:
                blocks.append(stack_vectors(c, size=vector_size, dtype=dtype))
            elif t == AlinkTypes.TENSOR:
                blocks.append(np.stack([np.asarray(v, dtype=dtype).reshape(-1) for v in c]))
            else:
                raise AkIllegalDataException(f"column {n!r} of type {t} is not numeric")
        if len(blocks) == 1:
            # own the memoized buffer: the single-column path can alias the
            # caller's source array, and an aliased memo would silently
            # track external mutations the multi-column (copied) path won't
            out = blocks[0]
            if out.base is not None:  # reshape view over the source column
                out = out.copy()
        else:
            out = np.concatenate(blocks, axis=1)
        out.setflags(write=False)  # shared across jobs; mutators must copy
        memo[memo_key] = out
        return out

    def to_device(self, names: Sequence[str], dtype=np.float32, device=None):
        """Ship the numeric block of ``names`` to ``device`` as one tensor
        (the single host→device boundary of the framework)."""
        import torch

        from .env import resolve_device

        block = self.to_numeric_block(names, dtype=dtype)
        return torch.as_tensor(block.copy(), device=resolve_device(device))

    def to_dataframe(self):
        import pandas as pd

        data = {}
        for n in self.names:
            c = self._cols[n]
            data[n] = [str(v) if isinstance(v, (DenseVector, SparseVector)) else v for v in c] \
                if c.dtype == object else c
        return pd.DataFrame(data)

    # -- display -----------------------------------------------------------
    def __repr__(self):
        return f"MTable({self.num_rows} rows, schema=[{self.schema.to_str()}])"

    def to_display_string(self, max_rows: int = 20) -> str:
        buf = io.StringIO()
        names = self.names
        widths = [max(len(n), 8) for n in names]
        sample = [
            [_fmt_cell(self._cols[n][i]) for n in names]
            for i in range(min(max_rows, self.num_rows))
        ]
        for row in sample:
            for j, cell in enumerate(row):
                widths[j] = max(widths[j], min(len(cell), 32))
        line = "|" + "|".join(n.ljust(w)[:w] for n, w in zip(names, widths)) + "|"
        buf.write(line + "\n")
        buf.write("|" + "|".join("-" * w for w in widths) + "|\n")
        for row in sample:
            buf.write("|" + "|".join(c.ljust(w)[:w] for c, w in zip(row, widths)) + "|\n")
        if self.num_rows > max_rows:
            buf.write(f"... ({self.num_rows} rows total)\n")
        return buf.getvalue()

    def __eq__(self, other):
        if not isinstance(other, MTable) or self.schema != other.schema:
            return False
        return all(
            np.array_equal(self._cols[n], other._cols[n], equal_nan=False)
            if self._cols[n].dtype != object
            else list(self._cols[n]) == list(other._cols[n])
            for n in self.names
        )

    # -- serialization (npz + json meta; the .ak payload format) -----------
    def to_payload(self) -> Tuple[bytes, str]:
        """Serialize to (npz-bytes, schema-json). Object columns (vectors etc.)
        are stored via their string codec; nested tensors as npy ragged lists."""
        arrays: Dict[str, np.ndarray] = {}
        for n, t in zip(self.names, self.schema.types):
            c = self._cols[n]
            key = f"col_{n}"
            if c.dtype == object:
                if t == AlinkTypes.TENSOR:
                    for i, v in enumerate(c):
                        arrays[f"{key}__t{i}"] = np.asarray(v)
                    arrays[key] = np.asarray([len(c)], dtype=np.int64)
                elif t == AlinkTypes.MTABLE:
                    sub = []
                    for v in c:
                        b, s = v.to_payload()
                        sub.append(json.dumps({"schema": s, "npz": b.hex()}))
                    arrays[key] = np.asarray(sub, dtype=object).astype(str)
                else:
                    arrays[key] = np.asarray(
                        ["" if v is None else str(v) for v in c], dtype=str
                    )
            else:
                arrays[key] = c
        bio = io.BytesIO()
        _savez_deterministic(bio, arrays)
        meta = json.dumps({"schema": self.schema.to_str()})
        return bio.getvalue(), meta

    @staticmethod
    def from_payload(data: bytes, meta: str) -> "MTable":
        schema = TableSchema.parse(json.loads(meta)["schema"])
        npz = np.load(io.BytesIO(data), allow_pickle=False)
        cols: Dict[str, Any] = {}
        for n, t in zip(schema.names, schema.types):
            key = f"col_{n}"
            if t == AlinkTypes.TENSOR:
                count = int(npz[key][0])
                cols[n] = [npz[f"{key}__t{i}"] for i in range(count)]
            elif t == AlinkTypes.MTABLE:
                vals = []
                for s in npz[key]:
                    obj = json.loads(str(s))
                    vals.append(MTable.from_payload(bytes.fromhex(obj["npz"]), obj["schema"]))
                cols[n] = vals
            elif AlinkTypes.is_vector(t):
                cols[n] = [parse_vector(str(s)) if str(s) else None for s in npz[key]]
            else:
                cols[n] = npz[key]
        return MTable(cols, schema)


def _savez_deterministic(bio: io.BytesIO, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez_compressed`` with fixed member timestamps.

    An npz is a zip of ``<name>.npy`` members, and ``np.savez`` stamps each
    with current localtime — so serializing the same table twice yields
    different bytes. The .ak payload must be content-deterministic (the
    modelstream publisher republishes after a crash and the retry has to be
    bit-identical to the fault-free write), hence a fixed epoch per member.
    ``np.load`` reads the result unchanged."""
    with zipfile.ZipFile(bio, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr),
                                      allow_pickle=False)
            zi = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            zi.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(zi, buf.getvalue())


def _as_column(col) -> np.ndarray:
    if isinstance(col, np.ndarray) and col.ndim == 1:
        return col
    if isinstance(col, np.ndarray):
        # 2-D numeric block → object column of per-row arrays is surprising;
        # treat as tensor column
        return np.asarray([row for row in col], dtype=object)
    vals = list(col)
    if any(isinstance(v, (DenseVector, SparseVector, MTable, np.ndarray)) for v in vals):
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = v
        return out
    if any(v is None for v in vals):
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = v
        return out
    arr = np.asarray(vals)
    if arr.ndim != 1:
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = np.asarray(v)
        return out
    return arr


def _cast_column(col: np.ndarray, type_tag: str) -> np.ndarray:
    if type_tag in _NP_OF_TYPE and col.dtype != object:
        return col.astype(_NP_OF_TYPE[type_tag], copy=False)
    if type_tag == AlinkTypes.STRING and col.dtype.kind not in ("U", "S", "O"):
        return col.astype(str)
    if AlinkTypes.is_vector(type_tag) and col.dtype != object:
        if col.dtype.kind in ("U", "S"):  # string cells (e.g. from_rows
            return col.astype(object)     # literals) parse lazily
        raise AkIllegalDataException("vector column must be object-dtype")
    if type_tag in _NP_OF_TYPE and col.dtype == object:
        return np.asarray([v for v in col], dtype=_NP_OF_TYPE[type_tag])
    return col


def _fmt_cell(v) -> str:
    if isinstance(v, float):
        return format(v, "g")
    if isinstance(v, MTable):
        return f"<MTable {v.num_rows}r>"
    if isinstance(v, np.ndarray):
        return f"<tensor {v.shape}>"
    return str(v)
