"""The port's DRAW charts (exec/chart.py, exec/chart_style.py) against
the JAX package's.

Every DRAW statement of the JAX package's test_charts.py, its error
cases and a few more, over a city-temperature table this file writes
with a seeded generator (the same columns as the reference's fixture,
which these tests do not read), through three engines: the JAX package's
Runtime(), the port's host engine (Runtime(device=None)) and the port on
the kernels' plain versions (Runtime(device="cpu")). The SVG strings are
equal byte for byte and each error message is the same. A DRAW whose
sub-query takes the port's GROUP BY route shows its route counter
rising. The renderer's domain and bar helpers run through both packages.
"""

import importlib

import numpy as np
import pytest

from eventql_tpu_torch.exec import device_exec

PACKAGES = ("eventql_tpu", "eventql_tpu_torch")
CITIES = ["Tokyo", "London", "New York", "Berlin", "Lima"]


@pytest.fixture(scope="module")
def city_csv(tmp_path_factory):
    """city, month, temperature: one row a city and month, the
    temperatures drawn from a seeded generator."""
    rng = np.random.default_rng(2024)
    lines = ["city,month,temperature"]
    for city in CITIES:
        for month in range(1, 13):
            lines.append(f"{city},2016-{month:02d},{rng.integers(-150, 350) / 10:.1f}")
    path = tmp_path_factory.mktemp("charts") / "city_temperatures.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _engines():
    """(label, package root, Runtime keyword arguments)."""
    return [("jax", "eventql_tpu", {}), ("port host engine", "eventql_tpu_torch",
                                        {"device": None}),
            ("port device cpu", "eventql_tpu_torch", {"device": "cpu"})]


def _render(root, runtime_kw, tables, query):
    """The SVG, or the error message prefixed with 'error: '."""
    rt = _mod(root, "exec.runtime").Runtime(**runtime_kw)
    try:
        res = rt.build_query_plan(rt.new_transaction(tables), query).execute(0)
    except Exception as e:  # noqa: BLE001 (the message is what is compared)
        return f"error: {type(e).__name__}: {e}"
    assert res.columns == ["__chart"]
    return res.get_row(0)[0]


def _city_tables(root, path):
    providers = _mod(root, "columnar.providers")
    tables = providers.CompositeTableProvider()
    tables.add(providers.CSVTableProvider("city_temperatures", path))
    return tables


BAR_QUERY = """
    DRAW BARCHART{};
    SELECT city AS x, max(temperature) AS y
      FROM city_temperatures
      GROUP BY city
      ORDER BY y DESC
      LIMIT 4;
"""

LINE = "SELECT temperature AS x, temperature AS y FROM city_temperatures"

# test_charts.py's statements, then error cases
DRAW_QUERIES = {
    "bar_vertical": BAR_QUERY.format(""),
    "bar_horizontal_stacked_labels": BAR_QUERY.format(
        " WITH ORIENTATION HORIZONTAL STACKED LABELS"),
    "bar_axis_bottom": BAR_QUERY.format(" WITH AXIS BOTTOM"),
    "bar_horizontal_axis_bottom": BAR_QUERY.format(" WITH ORIENTATION HORIZONTAL AXIS BOTTOM"),
    "bar_grid_vertical": BAR_QUERY.format(" WITH GRID VERTICAL"),
    "area": f"DRAW AREACHART; {LINE} LIMIT 5;",
    "point": f"DRAW POINTCHART; {LINE} LIMIT 5;",
    "line_grid": f"DRAW LINECHART GRID HORIZONTAL VERTICAL AXIS BOTTOM; {LINE} LIMIT 6;",
    "line_legend": (
        'DRAW LINECHART LEGEND TOP RIGHT OUTSIDE TITLE "cities" AXIS BOTTOM;'
        " SELECT city AS series, temperature AS x, temperature AS y FROM city_temperatures;"),
    "line_ydomain": f"DRAW LINECHART YDOMAIN 0, 100 AXIS LEFT; {LINE};",
    "line_ydomain_invert": f"DRAW LINECHART YDOMAIN 0, 100 INVERT AXIS LEFT; {LINE};",
    "line_ydomain_log": ("DRAW LINECHART YDOMAIN LOGARITHMIC AXIS LEFT; SELECT temperature AS x,"
                         " temperature + 50 AS y FROM city_temperatures;"),
    "line_series_ordered": ("DRAW LINECHART AXIS BOTTOM AXIS LEFT; SELECT temperature AS x,"
                            " temperature * 2 AS y, city AS series FROM city_temperatures"
                            " ORDER BY x;"),
    "error_no_x": "DRAW LINECHART; SELECT temperature AS y FROM city_temperatures;",
    "error_no_y": "DRAW POINTCHART; SELECT temperature AS x FROM city_temperatures;",
    "error_log_of_negative": ("DRAW LINECHART YDOMAIN LOGARITHMIC; SELECT temperature AS x,"
                              " temperature - 100 AS y FROM city_temperatures;"),
    "error_log_of_discrete": BAR_QUERY.format(" WITH XDOMAIN LOGARITHMIC"),
    "error_area_string_x": "DRAW AREACHART; SELECT city AS x, temperature AS y FROM"
                           " city_temperatures;",
}


@pytest.mark.parametrize("name", list(DRAW_QUERIES))
def test_draw_renders_alike_in_both_packages(city_csv, name):
    out = {label: _render(root, kw, _city_tables(root, city_csv), DRAW_QUERIES[name])
           for label, root, kw in _engines()}
    assert out["port host engine"] == out["jax"]
    assert out["port device cpu"] == out["jax"]
    if name.startswith("error"):
        assert out["jax"].startswith("error: ")
    else:
        assert out["jax"].startswith("<svg")


def test_the_fixtures_statements_draw_what_test_charts_asserts(city_csv):
    """The assertions test_charts.py makes of the reference fixture hold
    for the generated one, in the port."""
    def draw(name):
        return _render("eventql_tpu_torch", {"device": "cpu"},
                       _city_tables("eventql_tpu_torch", city_csv), DRAW_QUERIES[name])

    svg = draw("bar_vertical")
    assert "<g class='bars vertical'>" in svg and svg.count("class='bar ") == 4
    assert "Tokyo" in draw("bar_axis_bottom")
    assert draw("area").count("class='area ") == 1
    assert draw("point").count("<circle") == 5
    assert draw("line_grid").count("class='gridline'") >= 6
    legend = draw("line_legend")
    assert "<g class='legend'>" in legend and ">cities</text>" in legend
    assert ">100.0</text>" in draw("line_ydomain")
    assert draw("line_ydomain") != draw("line_ydomain_invert")


def _numeric_tables(root, n=4000):
    """A table the port's GROUP BY route serves: a string key of 40
    values and a u64 value."""
    rel = _mod(root, "exec.relation")
    types = _mod(root, "core.types")
    rng = np.random.default_rng(7)
    ones = np.ones(n, bool)
    dictionary = np.array([b"k%02d" % i for i in range(40)], dtype=object)
    relation = rel.Relation(
        ["k", "v"],
        [rel.Column(types.SType.STRING, rng.integers(0, 40, n).astype(np.int32), ones,
                    dictionary),
         rel.Column(types.SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64), ones)],
        n)
    provider = _mod(root, "exec.runtime").RelationTableProvider()
    provider.add_table("t", relation)
    return provider


ROUTED_DRAW = ("DRAW BARCHART WITH AXIS BOTTOM AXIS LEFT; SELECT k AS x, sum(v) AS y FROM t"
               " WHERE v < 800 GROUP BY k ORDER BY x;")


def test_draw_over_the_device_route():
    """The chart's sub-query takes the port's GROUP BY route on the
    kernels' plain versions; the SVG equals the JAX package's."""
    want = _render("eventql_tpu", {}, _numeric_tables("eventql_tpu"), ROUTED_DRAW)
    before = device_exec.FUSED_GROUPBY_COUNT
    got = _render("eventql_tpu_torch", {"device": "cpu"},
                  _numeric_tables("eventql_tpu_torch"), ROUTED_DRAW)
    assert device_exec.FUSED_GROUPBY_COUNT == before + 1
    assert got == want and got.count("class='bar ") == 40


@pytest.mark.parametrize("root", PACKAGES)
def test_discrete_domain_reference_quirks(root):
    chart = _mod(root, "exec.chart")
    d = chart.DiscreteDomain()
    for v in ("a", "b", "c", "a"):
        d.add_value(v)
    assert d.scale("a") == pytest.approx((3 - 0.5) / 3)
    assert d.scale("c") == pytest.approx((1 - 0.5) / 3)
    assert d.scale_range("a") == (pytest.approx(2 / 3), pytest.approx(1.0))
    assert d.get_ticks() == [0.0, pytest.approx(1.0), pytest.approx(2 / 3), pytest.approx(1 / 3)]
    with pytest.raises(Exception, match="can't scale value"):
        d.scale("missing")


@pytest.mark.parametrize("root", PACKAGES)
def test_barchart_negative_values_and_stacking(root):
    chart = _mod(root, "exec.chart")
    bars = chart.BarChart()
    s = chart.Series("")
    s.points = [("a", 5.0, "a: 5"), ("b", -3.0, "b: -3")]
    bars.add_series(s, x_is_time=False)
    assert bars._bars["a"]["ys"] == [(0.0, 5.0)]
    assert bars._bars["b"]["ys"] == [(-3.0, 0.0)]
    bars.set_stacked(True)
    assert bars.y_domain.max_value >= 5.0


@pytest.mark.parametrize("root", PACKAGES)
def test_continuous_domain_min_max_invert_log(root):
    chart = _mod(root, "exec.chart")
    d = chart.ContinuousDomain()
    d.add_value(5.0)
    d.add_value(42.0)
    d.set_min(0)
    d.set_max(100)
    d.build()
    assert d.scale(50) == 0.5
    d.set_inverted(True)
    assert d.scale(25) == 0.75
    d2 = chart.ContinuousDomain()
    d2.add_value(1.0)
    d2.add_value(100.0)
    d2.set_logarithmic(True)
    d2.build()
    assert abs(d2.scale(10) - 0.5) < 1e-9
