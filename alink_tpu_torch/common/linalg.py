"""Vector / matrix value types (a copy of ``alink_tpu.common.linalg``, kept
here so the port imports nothing of the JAX package).

Capability parity with the reference's linalg package
(reference: core/src/main/java/com/alibaba/alink/common/linalg/ — DenseVector,
SparseVector, DenseMatrix, BLAS, VectorUtil string codecs). The compute path
runs on tensors, so these classes are thin host-side value types whose job is:

- hold per-cell vector values inside :class:`~alink_tpu_torch.common.mtable.MTable` columns,
- parse/format the reference's string encodings (``"1.0 2.0 3.0"`` dense,
  ``"$5$1:2.0 3:4.0"`` sparse) so CSV/model tables round-trip,
- batch-convert columns to dense blocks ready for one host→device transfer
  (per-row BLAS calls are deliberately absent).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Union

import numpy as np

from .exceptions import AkIllegalDataException, AkParseErrorException


class DenseVector:
    """Dense f64 vector (reference: common/linalg/DenseVector.java)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data, dtype=np.float64).reshape(-1)

    # -- basic algebra (host-side convenience; bulk math runs on tensors) --
    def size(self) -> int:
        return self.data.shape[0]

    def get(self, i: int) -> float:
        return float(self.data[i])

    def set(self, i: int, v: float):
        self.data[i] = v

    def dot(self, other: "DenseVector | SparseVector") -> float:
        if isinstance(other, SparseVector):
            return other.dot(self)
        return float(self.data @ other.data)

    def plus(self, other: "DenseVector") -> "DenseVector":
        return DenseVector(self.data + other.data)

    def minus(self, other: "DenseVector") -> "DenseVector":
        return DenseVector(self.data - other.data)

    def scale(self, a: float) -> "DenseVector":
        return DenseVector(self.data * a)

    def norm_l2(self) -> float:
        return float(np.linalg.norm(self.data))

    def normalize(self, p: float = 2.0) -> "DenseVector":
        n = float(np.linalg.norm(self.data, ord=p))
        return DenseVector(self.data / n) if n > 0 else DenseVector(self.data)

    def to_dense(self) -> "DenseVector":
        return self

    def to_array(self) -> np.ndarray:
        return self.data

    # -- codecs ------------------------------------------------------------
    def __str__(self):
        return " ".join(format(v, "g") for v in self.data)

    __repr__ = __str__

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(self.data, other.data)

    def __len__(self):
        return self.size()


class SparseVector:
    """Sparse f64 vector with optional declared size
    (reference: common/linalg/SparseVector.java; string form ``$size$i:v i:v``)."""

    __slots__ = ("n", "indices", "values")

    def __init__(self, n: int = -1, indices=(), values=()):
        self.n = int(n)
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        val = np.asarray(values, dtype=np.float64).reshape(-1)
        if idx.shape != val.shape:
            raise AkIllegalDataException("sparse indices/values length mismatch")
        order = np.argsort(idx, kind="stable")
        self.indices = idx[order]
        self.values = val[order]
        if self.n >= 0 and self.indices.size and self.indices[-1] >= self.n:
            raise AkIllegalDataException(
                f"sparse index {self.indices[-1]} out of declared size {self.n}"
            )

    def size(self) -> int:
        return self.n if self.n >= 0 else (int(self.indices[-1]) + 1 if self.indices.size else 0)

    def get(self, i: int) -> float:
        pos = np.searchsorted(self.indices, i)
        if pos < self.indices.size and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def dot(self, other: "DenseVector | SparseVector") -> float:
        if isinstance(other, DenseVector):
            return float(other.data[self.indices] @ self.values)
        i = j = 0
        s = 0.0
        while i < self.indices.size and j < other.indices.size:
            a, b = self.indices[i], other.indices[j]
            if a == b:
                s += self.values[i] * other.values[j]
                i += 1
                j += 1
            elif a < b:
                i += 1
            else:
                j += 1
        return s

    def to_dense(self, n: Optional[int] = None) -> DenseVector:
        size = n if n is not None else self.size()
        out = np.zeros(size, dtype=np.float64)
        out[self.indices] = self.values
        return DenseVector(out)

    def to_array(self) -> np.ndarray:
        return self.to_dense().data

    def __str__(self):
        prefix = f"${self.n}$" if self.n >= 0 else ""
        return prefix + " ".join(
            f"{i}:{format(v, 'g')}" for i, v in zip(self.indices, self.values)
        )

    __repr__ = __str__

    def __eq__(self, other):
        return (
            isinstance(other, SparseVector)
            and self.n == other.n
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.values, other.values)
        )


Vector = Union[DenseVector, SparseVector]


class DenseMatrix:
    """Row-major f64 matrix (reference: common/linalg/DenseMatrix.java). Host-side
    value type for model payloads; heavy math runs on tensors."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data, dtype=np.float64)
        if self.data.ndim != 2:
            raise AkIllegalDataException("DenseMatrix must be 2-D")

    @property
    def num_rows(self):
        return self.data.shape[0]

    @property
    def num_cols(self):
        return self.data.shape[1]

    def multiplies(self, other: "DenseMatrix | DenseVector"):
        if isinstance(other, DenseVector):
            return DenseVector(self.data @ other.data)
        return DenseMatrix(self.data @ other.data)

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix(self.data.T)

    def __eq__(self, other):
        return isinstance(other, DenseMatrix) and np.array_equal(self.data, other.data)


# ---------------------------------------------------------------------------
# VectorUtil — string codecs (reference: common/linalg/VectorUtil.java)
# ---------------------------------------------------------------------------


def parse_vector(s: "str | Vector | Sequence[float]") -> Vector:
    if isinstance(s, (DenseVector, SparseVector)):
        return s
    if isinstance(s, (list, tuple, np.ndarray)):
        return DenseVector(s)
    s = s.strip()
    if not s:
        return DenseVector([])
    try:
        if s.startswith("$"):
            close = s.index("$", 1)
            n = int(s[1:close])
            body = s[close + 1:].strip()
            return _parse_sparse_body(body, n)
        if ":" in s:
            return _parse_sparse_body(s, -1)
        parts = s.replace(",", " ").split()
        return DenseVector([float(p) for p in parts])
    except (ValueError, IndexError) as e:
        raise AkParseErrorException(f"cannot parse vector from {s!r}: {e}")


def _parse_sparse_body(body: str, n: int) -> SparseVector:
    if not body:
        return SparseVector(n)
    idx, val = [], []
    for kv in body.replace(",", " ").split():
        i, v = kv.split(":")
        idx.append(int(i))
        val.append(float(v))
    return SparseVector(n, idx, val)


def format_vector(v: Vector) -> str:
    return str(v)


# ---------------------------------------------------------------------------
# Batch bridge: vector column → dense block
# ---------------------------------------------------------------------------


def stack_vectors(
    vectors: Iterable[Union[Vector, str, Sequence[float]]],
    size: Optional[int] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Stack a column of (possibly mixed dense/sparse/string) vectors into one
    dense ``(n, d)`` block ready to ship to the device. Sparse entries are
    scattered into the dense block; ``size`` pads/validates the feature dim."""

    vecs: List[Vector] = [parse_vector(v) for v in vectors]
    if size is None:
        size = max((v.size() for v in vecs), default=0)
    out = np.zeros((len(vecs), size), dtype=dtype)
    for r, v in enumerate(vecs):
        if isinstance(v, SparseVector):
            out[r, v.indices] = v.values
        else:
            d = min(v.size(), size)
            out[r, :d] = v.data[:d]
    return out


def pairwise_sq_dists(Q, X):
    """Blocked squared Euclidean distance matrix ||q-x||² as three matmul-
    friendly terms — the single home of this function (KMeans assign and
    the Lloyd loop call it). Generic over numpy arrays and torch tensors;
    fp32 cancellation can produce tiny negatives, which callers taking sqrt
    should clip."""
    return ((Q * Q).sum(1)[:, None] - 2.0 * (Q @ X.T)
            + (X * X).sum(1)[None, :])


class SparseBlock(NamedTuple):
    """ELL-padded sparse row block: ``idx`` (n, k) int32 column indices
    (0-padded), ``val`` (n, k) float32 (0-padded), so padded entries
    contribute 0 to any product. The "huge sparse" carrier (reference:
    common/linalg/SparseVector.java + the HugeSparseVector story): fixed
    shapes, gathers/scatter-adds instead of dense materialization. Holds
    numpy arrays on the host and tensors once staged on a device.
    """

    idx: "np.ndarray"
    val: "np.ndarray"


def to_sparse_block(
    cells: "Sequence[SparseVector]",
    dim: Optional[int] = None,
    append_intercept: bool = False,
) -> "tuple[SparseBlock, int]":
    """Pack SparseVector cells into one ELL block. Returns (block, dim).
    ``append_intercept`` adds one slot per row with index ``dim`` value 1."""
    n = len(cells)
    if dim is None:
        dim = max((int(c.n) if c.n >= 0 else
                   (int(c.indices[-1]) + 1 if c.indices.size else 0))
                  for c in cells) if n else 0
    max_nnz = max((c.indices.size for c in cells), default=0)
    extra = 1 if append_intercept else 0
    idx = np.zeros((n, max_nnz + extra), np.int32)
    val = np.zeros((n, max_nnz + extra), np.float32)
    for i, c in enumerate(cells):
        m = c.indices.size
        idx[i, :m] = c.indices
        val[i, :m] = c.values
        if append_intercept:
            idx[i, max_nnz] = dim
            val[i, max_nnz] = 1.0
    return SparseBlock(idx, val), int(dim)
