"""Parity of the port's window feature generators with the reference on
the CPU: every case of ``tests/test_windowfe.py`` (but its stream twin) on
both packages, columns bit-identical (``rtol=0``). The trailing extremes
are pandas' rolling max/min in the reference and a sparse table in the
port; max and min are exact, so they must agree bit for bit, ties at a
window's left edge, repeated timestamps and NaN included.

Timestamp strings: the port parses ISO 8601 (a space or ``T``, an optional
fraction, a date alone) into epoch ns / 1e9, which is
``pd.to_datetime(...).as_unit("ns")``'s value; the reference divides
pandas' inferred unit by 1e9 (microseconds under pandas 3), so the strings
are held against pandas at ns, not against the reference's column
(ROADMAP, "Differences by design"). Any other string raises.
"""

import numpy as np
import pytest

from torch_table_parity import both, same_table


@pytest.fixture(scope="module")
def sid():
    from torch_table_parity import reference_session, remove_session

    s = reference_session()
    yield s
    remove_session(s)


def _table():
    return {"user": np.asarray(["u1"] * 4 + ["u2"] * 2, object),
            "t": np.asarray([10.0, 20.0, 70.0, 75.0, 5.0, 130.0]),
            "x": np.asarray([1.0, 2.0, 3.0, 4.0, 10.0, 20.0])}


def _tx(times, xs):
    return {"t": np.asarray(times, np.float64),
            "x": np.asarray(xs, np.float64)}


WINDOW_CASES = {
    "tumble": (_table(), {
        "groupCols": ["user"], "windowType": "TUMBLE", "windowTime": 60,
        "targetCols": ["x"], "statTypes": ["SUM", "COUNT", "MAX"]}),
    "hop": (_tx([10, 40, 70], [1, 1, 1]), {
        "groupCols": [], "windowType": "HOP", "windowTime": 60,
        "hopTime": 30, "targetCols": ["x"], "statTypes": ["COUNT"]}),
    "session": (_table(), {
        "groupCols": ["user"], "windowType": "SESSION",
        "sessionGapTime": 30, "windowTime": 30, "targetCols": ["x"],
        "statTypes": ["SUM"]}),
    "stddev": (_tx([0, 1, 2, 3], [3.0, 5.0, 9.0, 11.0]), {
        "groupCols": [], "windowType": "TUMBLE", "windowTime": 100,
        "targetCols": ["x"], "statTypes": ["STDDEV"]}),
    "tumble_boundary": (_tx([0, 10, 120], [1, 2, 7]), {
        "groupCols": [], "windowType": "TUMBLE", "windowTime": 60,
        "targetCols": ["x"], "statTypes": ["SUM"]}),
    "hop_first_event": (_tx([40, 70], [1, 1]), {
        "groupCols": [], "windowType": "HOP", "windowTime": 60,
        "hopTime": 30, "targetCols": ["x"], "statTypes": ["COUNT"]}),
    "multi_definition": (_tx([0, 10], [1, 5]), [
        {"groupCols": [], "windowType": "TUMBLE", "windowTime": 60,
         "targetCols": ["x"], "statTypes": ["SUM"]},
        {"groupCols": [], "windowType": "TUMBLE", "windowTime": 60,
         "targetCols": ["x"], "statTypes": ["MAX"]}]),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_cases_bit_identical(sid, case):
    cols, defs = WINDOW_CASES[case]
    ref, got = both(sid, cols, lambda B, e, s: (
        B.GenerateFeatureOfWindowBatchOp(timeCol="t", featureDefinitions=defs,
                                         **e).link_from(s)))
    same_table(got, ref, rtol=0)


def _random_events(n=400, groups=7, seed=0):
    rng = np.random.default_rng(seed)
    t = np.round(rng.uniform(0, 20 * 86400, n) / 3600) * 3600  # repeats
    x = rng.normal(size=n)
    x[rng.integers(0, n, 12)] = np.nan
    return {"g": np.asarray([f"g{i}" for i in rng.integers(0, groups, n)],
                            object), "t": t, "x": x}


@pytest.mark.parametrize("wtype", ["TUMBLE", "HOP", "SESSION"])
def test_window_every_stat_on_random_groups(sid, wtype):
    defs = {"groupCols": ["g"], "windowType": wtype, "windowTime": 86400,
            "hopTime": 21600, "sessionGapTime": 7200, "targetCols": ["x"],
            "statTypes": ["COUNT", "SUM", "AVG", "MAX", "MIN", "STDDEV",
                          "FIRST", "LAST"]}
    ref, got = both(sid, _random_events(), lambda B, e, s: (
        B.GenerateFeatureOfWindowBatchOp(timeCol="t", featureDefinitions=defs,
                                         **e).link_from(s)))
    same_table(got, ref, rtol=0)


TRAILING_CASES = {
    "latest_n": (_table(), "GenerateFeatureOfLatestBatchOp",
                 dict(groupCols=["user"], targetCols=["x"],
                      statTypes=["SUM", "MEAN", "MIN"], number=2)),
    "latest_ndays": (_tx([0, 30, 90], [1, 2, 4]),
                     "GenerateFeatureOfLatestNDaysBatchOp",
                     dict(targetCols=["x"], statTypes=["SUM"],
                          nDays=60.0 / 86400.0)),
    "declared_window": (_tx(np.asarray([0.0, 0.1, 0.2, 5.0, 11.0]) * 86400,
                            [1, 1, 1, 100, 1]),
                        "GenerateFeatureOfLatestNDaysBatchOp",
                        dict(targetCols=["x"], statTypes=["SUM", "MAX"],
                             nDays=7)),
    # a row exactly nDays after another: the left edge is inside (closed)
    "edge_ties": (_tx([0, 0, 86400, 86400, 86400, 172800, 172800.5],
                      [5, 1, 2, np.nan, 7, 3, 0]),
                  "GenerateFeatureOfLatestNDaysBatchOp",
                  dict(targetCols=["x"], statTypes=["MAX", "MIN", "SUM"],
                       nDays=1)),
    "random_ndays": (_random_events(), "GenerateFeatureOfLatestNDaysBatchOp",
                     dict(groupCols=["g"], targetCols=["x"],
                          statTypes=["MAX", "MIN", "AVG", "COUNT"],
                          nDays=2.5)),
    "random_rows": (_random_events(seed=1), "GenerateFeatureOfLatestBatchOp",
                    dict(groupCols=["g"], targetCols=["x"],
                         statTypes=["MAX", "MIN", "STDDEV", "LAST"],
                         number=6)),
}


@pytest.mark.parametrize("case", sorted(TRAILING_CASES))
def test_trailing_cases_bit_identical(sid, case):
    cols, op, params = TRAILING_CASES[case]
    ref, got = both(sid, cols, lambda B, e, s: getattr(B, op)(
        timeCol="t", **params, **e).link_from(s))
    same_table(got, ref, rtol=0)


def test_different_windows_raise():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.common.mtable import MTable

    op = P.GenerateFeatureOfWindowBatchOp(
        timeCol="t",
        featureDefinitions=[
            {"groupCols": [], "windowTime": 60, "targetCols": ["x"]},
            {"groupCols": ["u"], "windowTime": 30, "targetCols": ["x"]}])
    t = MTable.from_rows([("a", 0.0, 1.0)], "u string, t double, x double")
    with pytest.raises(AkIllegalArgumentException, match="share"):
        op.link_from(P.TableSourceBatchOp(t)).collect()


STAMPS = ["2021-03-01 10:00:00", "2021-03-01T10:00:30",
          "2021-03-01 10:01:00.5", "2021-03-01T10:02:00.123456789",
          "2021-03-02", "2021-03-01 10:03"]


def test_timestamp_strings_parse_to_epoch_seconds():
    import pandas as pd

    from alink_tpu_torch.operator.batch.windowfe import _epoch_seconds

    for s in STAMPS:
        want = pd.to_datetime(np.asarray([s], object)).as_unit("ns") \
            .astype("int64").to_numpy() / 1e9
        np.testing.assert_array_equal(_epoch_seconds(np.asarray([s], object)),
                                      want)
    got = _epoch_seconds(np.asarray(STAMPS, object))
    assert got.dtype == np.float64 and got[1] - got[0] == 30.0
    dt = np.asarray(STAMPS[:3], "datetime64[ns]")
    np.testing.assert_array_equal(_epoch_seconds(dt), got[:3])


def test_string_times_give_the_numeric_times_columns():
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.mtable import MTable
    from alink_tpu_torch.operator.batch.windowfe import _epoch_seconds

    stamps = np.asarray(STAMPS, object)
    x = np.arange(len(STAMPS), dtype=np.float64)
    secs = _epoch_seconds(stamps)
    outs = []
    for tcol in (stamps, secs):
        t = MTable({"t": tcol, "x": x})
        outs.append(P.GenerateFeatureOfLatestNDaysBatchOp(
            timeCol="t", targetCols=["x"], statTypes=["SUM", "MAX"],
            nDays=1.0 / 24).link_from(P.TableSourceBatchOp(t)).collect())
    for c in ("x_sum_d0.041666666666666664", "x_max_d0.041666666666666664"):
        np.testing.assert_array_equal(outs[0].col(c), outs[1].col(c))


@pytest.mark.parametrize("bad", ["03/01/2021", "2021-03-01 10:00:00+08:00",
                                 "yesterday", "2021-3-1"])
def test_unaccepted_timestamp_raises(bad):
    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkIllegalDataException
    from alink_tpu_torch.common.mtable import MTable

    t = MTable({"t": np.asarray(["2021-03-01", bad], object),
                "x": np.asarray([1.0, 2.0])})
    with pytest.raises(AkIllegalDataException, match="cannot parse"):
        P.GenerateFeatureOfLatestNDaysBatchOp(
            timeCol="t", targetCols=["x"]).link_from(
            P.TableSourceBatchOp(t)).collect()
