"""Helpers of the port's parity tests for the table-to-table families
(``tests/test_torch_features.py``, ``test_torch_dataproc.py``,
``test_torch_vector.py``): run one operator graph in both packages on the
same columns and hold the output tables against each other."""

import numpy as np


def reference_session():
    """A reference session on a one-device mesh; remove it when done."""
    import jax

    from alink_tpu.common.env import MLEnvironment, MLEnvironmentFactory
    from alink_tpu.parallel.mesh import default_mesh

    return MLEnvironmentFactory.get_new_environment_id(
        MLEnvironment(mesh=default_mesh(jax.devices()[:1])))


def remove_session(sid):
    from alink_tpu.common.env import MLEnvironmentFactory

    MLEnvironmentFactory.remove(sid)


def both(sid, cols, build, *more):
    """``build(ops, extra, src, *more_srcs)`` → an operator, in the
    reference (``extra`` carries its session) and in the port, on sources
    of ``cols`` (and of each dict in ``more``). Returns the two collected
    tables, reference first."""
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    out = []
    for ops, T, extra in ((R, RT, dict(MLEnvironmentId=sid)), (P, PT, {})):
        srcs = [ops.TableSourceBatchOp(T(dict(c))) for c in (cols, *more)]
        out.append(build(ops, extra, *srcs).collect())
    return out


def _is_vector(v):
    return type(v).__name__ in ("DenseVector", "SparseVector")


def same_value(a, b, rtol):
    if _is_vector(a) or _is_vector(b):
        assert type(a).__name__ == type(b).__name__, (a, b)
        if type(a).__name__ == "SparseVector":
            assert a.n == b.n
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_allclose(a.values, b.values, rtol=rtol)
        else:
            np.testing.assert_allclose(a.data, b.data, rtol=rtol,
                                       atol=rtol * max(1.0, np.abs(
                                           b.data).max(initial=0.0)))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        np.testing.assert_allclose(a, b, rtol=rtol)
    elif isinstance(b, float) and isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=rtol)
    else:
        assert a == b or (a != a and b != b), (a, b)


def same_table(port, ref, rtol=1e-12):
    """The port's table equals the reference's: names, schema, and every
    cell (floats and vector entries within ``rtol``, the rest exactly)."""
    assert port.names == ref.names
    assert str(port.schema) == str(ref.schema)
    for name in ref.names:
        p, r = np.asarray(port.col(name)), np.asarray(ref.col(name))
        assert p.shape == r.shape, name
        if p.dtype == object or r.dtype == object:
            for a, b in zip(p, r):
                same_value(a, b, rtol)
        elif p.dtype.kind == "f" or r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(p, r, err_msg=name)


def same_model(port, ref, rtol=1e-12):
    """Two model tables decode to the same meta and arrays."""
    from alink_tpu.common.model import table_to_model as r_t2m
    from alink_tpu_torch.common.model import table_to_model as p_t2m

    (pm, pa), (rm, ra) = p_t2m(port), r_t2m(ref)
    assert pm == rm
    assert pa.keys() == ra.keys()
    for k in ra:
        np.testing.assert_allclose(pa[k], ra[k], rtol=rtol, err_msg=k)
