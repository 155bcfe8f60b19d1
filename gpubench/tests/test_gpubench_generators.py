"""Each generator is deterministic from its seed and keeps to its
configuration file's schema and ranges."""

import pytest
import torch

from gpubench import harness
from gpubench.tests.tiny import ALL_CONFIGS, sizes

SEED = 2**31 + 11


def _cell(config, bench=None):
    """A cell of the configuration, at its test sizes."""
    name = next(w["name"] for w in harness._json(bench or harness.BENCHMARK)["workloads"]
                if w["config"] == config)
    return harness.Cell(name, sizes=sizes(name, bench), bench=bench)


def _generate(config, seed, bench=None):
    return _cell(config, bench).generate(seed, "cpu")


@pytest.mark.parametrize("bench, config", ALL_CONFIGS)
def test_same_seed_same_tables_other_seed_other_tables(bench, config):
    a, b, c = _generate(config, SEED, bench), _generate(config, SEED, bench), _generate(config, SEED + 1, bench)
    for t in a:
        for name in a[t]:
            assert torch.equal(a[t][name], b[t][name]), name
        assert any(a[t][n].shape != c[t][n].shape or not torch.equal(a[t][n], c[t][n]) for n in a[t])


@pytest.mark.parametrize("bench, config", ALL_CONFIGS)
def test_schema_and_ranges(bench, config):
    cell = _cell(config, bench)
    cfg, tables = cell.config, cell.generate(SEED, "cpu")
    assert set(tables) == set(cfg["tables"])
    for t, specs in cfg["tables"].items():
        assert list(tables[t]) == [s["name"] for s in specs]
        n = {v.numel() for v in tables[t].values()}
        assert len(n) == 1 and n.pop() > 0
        for s in specs:
            v = tables[t][s["name"]]
            if s["type"] == "STRING":
                assert v.dtype == torch.int32
                assert 0 <= int(v.min()) and int(v.max()) < len(s["values"])
                assert s["values"] == sorted(s["values"])
            else:
                assert s["type"] == "UINT64" and v.dtype == torch.int64
                lo, hi = s["range"]
                assert lo <= int(v.min()) and int(v.max()) <= hi, s["name"]


def test_tpch_rules():
    cfg = _cell("tpch_sf10_lineitem").config
    li = _generate("tpch_sf10_lineitem", SEED)["lineitem"]
    n_orders = cfg["orders"]
    assert n_orders <= li["l_quantity"].numel() <= 7 * n_orders
    q, p = li["l_quantity"], li["l_extendedprice"]
    assert torch.all(p % q == 0)
    retail = p // q
    assert int(retail.min()) >= 90000 and int(retail.max()) <= 209900
    today = 9298
    status_o = li["l_linestatus"] == 1
    assert torch.equal(status_o, li["l_shipdate"] > today)
    # N (id 1) exactly where the receipt (ship + 1..30) lies after today
    flag_n = li["l_returnflag"] == 1
    assert torch.all(flag_n[li["l_shipdate"] > today])
    assert not torch.any(flag_n[li["l_shipdate"] + 30 <= today])


def test_hits_distinct_users_and_shares():
    cfg = _cell("clickbench_hits").config
    hits = _generate("clickbench_hits", SEED)["hits"]
    assert hits["UserID"].numel() == cfg["rows"]
    assert torch.unique(hits["UserID"]).numel() == cfg["distinct_users"]
    assert int(hits["UserID"].min()) > 0
    # one home region a user
    pairs = torch.unique(torch.stack([hits["UserID"], hits["RegionID"]]), dim=1)
    assert pairs.shape[1] == cfg["distinct_users"]
    nonzero = hits["AdvEngineID"] != 0
    assert 0.002 < float(nonzero.double().mean()) < 0.012
    assert set(hits["AdvEngineID"][nonzero].tolist()) <= set(cfg["adv_engine_ids"])
    assert set(hits["ResolutionWidth"].tolist()) <= set(cfg["resolution_widths"])
