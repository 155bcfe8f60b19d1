"""The comparison treats ORDER BY ties and LIMIT boundaries as SQL defines
them, and counts every other difference."""

from gpubench import compare

Q_TOP = {"group_by": [0], "order_by": [[1, "desc"]], "limit": 2}
REF = [(1, 10, 0.5), (2, 7, 1.25), (3, 7, 2.0), (4, 1, 3.0)]


def rows(*rs):
    return compare.format_rows(rs)


def test_tied_rows_at_the_limit_may_be_either():
    assert compare.compare(rows(REF[0], REF[1]), REF, Q_TOP) == (0, 0.0)
    assert compare.compare(rows(REF[0], REF[2]), REF, Q_TOP) == (0, 0.0)


def test_wrong_order_missing_rows_and_rows_past_the_limit_count():
    assert compare.compare(rows(REF[1], REF[0]), REF, Q_TOP)[0] == 1
    assert compare.compare(rows(REF[0]), REF, Q_TOP)[0] == 1
    assert compare.compare(rows(REF[0], REF[3]), REF, Q_TOP)[0] == 1
    assert compare.compare(rows(REF[0], REF[0]), REF, Q_TOP)[0] == 1


def test_cells_ints_and_floats():
    q = {"group_by": [0], "order_by": [], "limit": None}
    bad = [["1", "11", "0.500000"], ["2", "7", "1.250001"], ["3", "7", "2.000000"], ["4", "1", "x"]]
    mismatches, gap = compare.compare(bad, REF, q)
    assert mismatches == 2
    assert abs(gap - 1.0) < 1e-3
    assert compare.compare([["9", "1", "1.0"]] + bad[1:], REF, q)[0] == 2


def test_string_keys_in_order():
    ref = [("A", "F", 3), ("N", "O", 1), ("A", "O", 2)]
    q = {"group_by": [0, 1], "order_by": [[0, "asc"], [1, "asc"]], "limit": None}
    good = compare.format_rows([ref[0], ref[2], ref[1]])
    assert compare.compare(good, ref, q) == (0, None)
    assert compare.compare(compare.format_rows(ref), ref, q)[0] == 1
