"""chip_smoke.py's copies of the fuzz corpora's generators against the
tests' own.

Phase 9 of chip_smoke.py replays the seeds of the port's CPU fuzz tests on
the card. It may import nothing of the tests or of the JAX package, so it
keeps copies of their table and query generators. Here every seed of each
corpus must give, from the copy, the same query and the same tables
(names, types, data, NULL masks, dictionaries) as from the generator the
CPU tests use.
"""

import os
import random
import sys

import numpy as np
import pytest

import test_fuzz_device_order as jax_order_fuzz
import test_fuzz_device_parity as jax_fuzz
import test_torch_fuzz_groupby as port_groupby_fuzz
import test_torch_join_routes as port_join_routes
import test_torch_order_routes as port_order_routes

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def _seeded(make_tables, make_query, base, names):
    def case(seed):
        rng = random.Random(base + seed)
        provider = make_tables(rng)
        return {n: provider.get_table_data(n) for n in names}, make_query(rng)
    return case


def _tables_of(case, names):
    def out(seed):
        provider, query = case(seed)
        return {n: provider.get_table_data(n) for n in names}, query
    return out


# corpus -> the CPU tests' generator of (tables, query) for a seed
ORIGINALS = {
    "groupby": _seeded(jax_fuzz._make_table, jax_fuzz._gen_query, 1000, ["t"]),
    "groupby_route": _tables_of(port_groupby_fuzz._route_case, ["t"]),
    "order": _seeded(jax_order_fuzz._make_table, jax_order_fuzz._gen_order_query, 3000, ["t"]),
    "scan_topk": _tables_of(port_order_routes._scan_topk_case, ["t"]),
    "join": _seeded(jax_fuzz._make_join_tables, jax_fuzz._gen_join_query, 5000,
                    ["facts", "dims"]),
    "join_routable": _tables_of(port_join_routes._routable_case, ["facts", "dims"]),
}

CASES = [(name, seed) for name, corpus in chip_smoke.FUZZ_CORPORA.items()
         for seed in range(corpus.seeds)]


def test_the_corpora_are_the_cpu_tests():
    """Phase 9 replays each corpus with the CPU tests' seed count."""
    assert set(chip_smoke.FUZZ_CORPORA) == set(ORIGINALS)
    assert {n: c.seeds for n, c in chip_smoke.FUZZ_CORPORA.items()} == {
        "groupby": len(port_groupby_fuzz.SEEDS), "groupby_route": len(port_groupby_fuzz.ROUTE_SEEDS),
        "order": len(port_order_routes.SEEDS), "scan_topk": 25,
        "join": len(port_join_routes.SEEDS), "join_routable": len(port_join_routes.SEEDS)}


@pytest.mark.parametrize("name,seed", CASES)
def test_copied_generators_give_the_tests_tables(name, seed):
    want_tables, want_query = ORIGINALS[name](seed)
    got_tables, got_query = chip_smoke.FUZZ_CORPORA[name].case(seed)
    assert got_query == want_query
    assert sorted(got_tables) == sorted(want_tables)
    for table, want in want_tables.items():
        got = got_tables[table]
        assert got.names == want.names and got.num_rows == want.num_rows
        for a, b in zip(got.columns, want.columns):
            assert int(a.stype) == int(b.stype)
            assert a.data.dtype == b.data.dtype
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.valid, b.valid)
            if b.dictionary is None:
                assert a.dictionary is None
            else:
                assert list(a.dictionary) == list(b.dictionary)


def test_mod_by_zero_case_is_the_tests():
    """Phase 9's modulo-by-zero table is test_mod_by_zero_raises_on_device_path's."""
    want = jax_fuzz._make_table(random.Random(7)).get_table_data("t")
    got = chip_smoke.fuzz_group_table(random.Random(7))["t"]
    for a, b in zip(got.columns, want.columns):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.valid, b.valid)
