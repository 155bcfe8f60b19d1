"""The expression program (exec/torch_expr.py on a CUDA device) on the CPU.

``torch_expr.compile_expr`` compiles an expression into one program for
the kernel of kernels/csrc/expr_program.cu. Here a small numpy
interpreter of that program (``interpret``: the program as the launcher
receives it, ``kernels.expr_program.HostProgram``) takes the kernel's
place, and every result is held against the PyTorch path
(``torch_expr.compile_torch``): integers bit for bit, floats value for
value (NaN where NaN, the sign of a zero included), validity equal. The
corpus is tests/test_torch_expr.py's snippets (kept here, without the JAX
package, so that the card's tests in tests/test_torch_cuda.py run it too)
and the benchmark's expressions (gpubench/traffic: TPC-H Q1's WHERE and
five arguments, Q6's WHERE and product, ClickBench's
``mean(ResolutionWidth)``), each through its route. Also: the rule that
sends an expression to the PyTorch path, reads through a scan's select
list without a widened copy, literals above 2^63, one program a plan.
"""

import json
import os

import numpy as np
import pytest
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec, torch_expr
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import PlanCache, RelationTableProvider, Runtime
from eventql_tpu_torch.kernels import expr_program as kp
from eventql_tpu_torch.plan.exprs import ColumnReferenceNode

N = 2000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPETS = [
    # arithmetic, wrapping mod 2^64
    "u + u2", "u - u2", "u * u2", "i + small", "i * 3", "i - small * 1000",
    "un + w", "w * w", "un * 65535 + 1", "f * 2.5", "f + fp", "f - 1.5",
    # float division of every integer kind (u64 -> f64 above 2^63)
    "u / u2", "i / small", "un / 7", "f / 0.0",
    # unsigned order above 2^63; signed; narrowed operands; floats
    "u < u2", "u <= u2", "u > u2", "u >= u2", "u = u2", "u != u2",
    "u > 9223372036854775808", "u2 <= 18446744073709551615",
    "i < 0", "i >= small", "small = -7", "small != -7", "un < 500",
    "w >= 2147483648", "f > 0.5", "f <= fp", "ts < 1125899906842624",
    # strings compare as dictionary ids
    "s = s2", "s != s2", "s < s2",
    # logic
    "u < u2 and i < 0", "u < u2 or i < 0", "!(f > 0.5)",
    "(un < 500 or w >= 2147483648) and small != -3",
    # if
    "if(i < 0, u, u2)", "if(un < 500, small, i)", "if(f > 0, f, fp)",
    "if(u < u2, un, w)",
    # negation
    "-u", "-i", "-small", "-f", "-un",
    # conversions
    "to_int64(u)", "to_uint64(i)", "to_float64(u)", "to_float64(i)",
    "to_float64(w)", "to_uint64(fp)", "to_int64(f)", "truncate(f)",
    "truncate(u)", "to_uint64(small < 0)", "to_float64(un < 500)",
    "to_timestamp64(i)", "to_int64(ts)", "to_uint64(ts)",
    # modulo with a non-zero literal divisor, pow, timestamps
    "u % 1000", "u % 9223372036854775809", "un % 7", "i % -7", "small % -5",
    "f % 2.5", "pow(un, 2)", "pow(small, 2)", "from_timestamp(small)",
    "from_timestamp(f)", "to_uint64(f)", "to_int64(fp)", "to_int64(f / 0.0)",
    "to_uint64(f / 0.0)",
    # null tags: refs propagate, calls clear, isnull reads them
    "un", "s2", "isnull(un)", "isnull(un + 1)", "if(isnull(un), w, un)",
    "if(small < 0, un, w)",
]

# beyond the shared corpus: stored columns as they are, validity computed by
# the program, literals above 2^63, bools, every narrowed kind, NaN and -0.0
EXTRA = [
    "u", "f", "i", "if(i < 0, un, w)", "if(isnull(un), un, 7)",
    "u + 18446744073709551615", "u * 9223372036854775808", "u2 > 18446744073709551614",
    "(u < 9223372036854775809) = (un < 500)", "small * small - w", "to_float64(small)",
    "to_float64(un) * 0.5 + f", "-(f * 0.0)", "if(f > 0, -0.0, f)", "to_int64(-f * 100000000000000000000.0)",
    "to_uint64(f * 100000000000000000.0)", "truncate(fp)", "isnull(un) or isnull(w)", "!isnull(un)",
    "if(small < 0, u, 1) * (100 - un)", "w * (100 - un) * (100 + small)",
    # a stored BOOL column: as it is, and read as an integer or a float
    "b", "to_int64(b)", "to_uint64(b)", "to_float64(b)", "if(b, u, u2)", "b and un < 500",
    "!b",
]

# the snippets the program leaves to the PyTorch path: division, modulo,
# pow, from_timestamp, a string argument, a constant (no column to read)
FALLBACK = {s for s in SNIPPETS if any(t in s for t in ("/", "%", "pow(", "from_timestamp"))}
FALLBACK |= {"s = s2", "s != s2", "s < s2", "s2", "isnull(un + 1)"}
# the snippets whose data is a stored column as it is stored: no launch
IDENTITY = {"u", "f", "i", "to_int64(u)", "to_uint64(i)", "truncate(u)", "to_timestamp64(i)",
            "to_int64(ts)", "to_uint64(ts)", "b"}


def corpus_relation(n, seed=41):
    """test_torch_expr.py's table at n rows, as the port's Relation."""
    rng = np.random.default_rng(seed)
    ones = np.ones(n, bool)
    u = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    u[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1][:n]
    u2 = rng.integers(1, 1 << 64, n, dtype=np.uint64)
    u2[:4] = [(1 << 64) - 1, 1 << 63, (1 << 63) - 1, 1][:n]
    i = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    small = rng.integers(-300, 300, n).astype(np.int64)  # narrows to i16
    un_valid = rng.random(n) < 0.85
    un = np.where(un_valid, rng.integers(0, 60000, n), 0).astype(np.uint64)  # u16
    w = rng.integers(0, 1 << 32, n).astype(np.uint64)  # u32
    f = rng.standard_normal(n) * 1000.0
    f[:3] = [np.nan, -0.0, 0.0][:n]
    fp = rng.random(n) * 1.8e19
    ts = rng.integers(0, 1 << 51, n).astype(np.uint64)
    dictionary = np.array([b"k%03d" % k for k in range(40)], dtype=object)
    s = rng.integers(0, 40, n).astype(np.int32)
    s2 = rng.integers(0, 40, n).astype(np.int32)
    U, I, F, T, S = (int(t) for t in (SType.UINT64, SType.INT64, SType.FLOAT64,
                                      SType.TIMESTAMP64, SType.STRING))
    cols = [("u", U, u, ones), ("u2", U, u2, ones), ("i", I, i, ones),
            ("small", I, small, ones), ("un", U, un, un_valid), ("w", U, w, ones),
            ("f", F, f, ones), ("fp", F, fp, ones), ("ts", T, ts, ones)]
    spec = [(st, d, v, None) for _n, st, d, v in cols]
    spec += [(S, s, ones, dictionary), (S, s2, rng.random(n) < 0.9, dictionary)]
    b = rng.random(n) < 0.5  # stored as torch.bool
    spec.append((int(SType.BOOL), b, ones, None))
    return relation_from_numpy([c[0] for c in cols] + ["s", "s2", "b"], spec)


def provider_of(**tables):
    p = RelationTableProvider()
    for name, rel in tables.items():
        p.add_table(name, rel)
    return p


def scan_of(node):
    while not hasattr(node, "input_columns"):
        node = node.table
    return node


def planned(snippet, provider, device):
    """(the scan, its first select expression, its input columns on
    ``device``) of ``select <snippet> from t``."""
    rt = Runtime(device=None)
    scan = scan_of(rt.build_query_plan(
        rt.new_transaction(provider), f"select {snippet} from t;").nodes[0])
    t = provider.get_table_data("t")
    cols = device_exec._to_device_cols(t.columns, t.names, scan.input_columns, device)
    return scan, scan.select_list[0].expr, cols


def bits(t):
    """A result plane as comparable numpy words: integers and bools as
    they are, floats by their bits with every NaN as one word."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.float64:
        nan = np.isnan(a)
        a = a.view(np.uint64).copy()
        a[nan] = 0x7FF8000000000000
    return a


def assert_same(got, want, n, what=""):
    assert got.stype == want.stype, what
    assert got.data.dtype == want.data.dtype, what
    g, w = got.full(n), want.full(n)
    assert g.data.shape == w.data.shape == (n,), what
    assert np.array_equal(bits(g.data), bits(w.data)), what
    assert np.array_equal(bits(g.valid), bits(w.valid)), what


# -- the numpy interpreter ------------------------------------------------------

_SIGN = np.uint64(1 << 63)
_TWO63, _TWO64 = 2.0 ** 63, 2.0 ** 64


def _f(x):
    return x.view(np.float64)


def _u(x):
    return np.ascontiguousarray(x).view(np.uint64)


def _s(x):
    return x.view(np.int64)


def _b(x):
    return x.astype(np.uint64)


def _f2i(a):
    x = _f(a)
    out = np.zeros(len(x), np.int64)
    inner = (x < _TWO63) & (x > -_TWO63)
    out[inner] = x[inner].astype(np.int64)
    out[x >= _TWO63] = np.iinfo(np.int64).max
    out[x <= -_TWO63] = np.iinfo(np.int64).min
    return out.view(np.uint64)


def _f2u(a):
    x = _f(a)
    out = np.zeros(len(x), np.uint64)
    low = (x > 0) & (x < _TWO63)
    out[low] = x[low].astype(np.uint64)
    high = (x >= _TWO63) & (x < _TWO64)
    out[high] = (x[high] - _TWO63).astype(np.uint64) | _SIGN
    out[x >= _TWO64] = np.iinfo(np.uint64).max
    return out


_OPS = {
    "mov": lambda a, b, c: a,
    "iadd": lambda a, b, c: a + b,
    "isub": lambda a, b, c: a - b,
    "imul": lambda a, b, c: a * b,
    "fadd": lambda a, b, c: _u(_f(a) + _f(b)),
    "fsub": lambda a, b, c: _u(_f(a) - _f(b)),
    "fmul": lambda a, b, c: _u(_f(a) * _f(b)),
    "ilt": lambda a, b, c: _b(_s(a) < _s(b)),
    "ile": lambda a, b, c: _b(_s(a) <= _s(b)),
    "igt": lambda a, b, c: _b(_s(a) > _s(b)),
    "ige": lambda a, b, c: _b(_s(a) >= _s(b)),
    "ult": lambda a, b, c: _b(a < b),
    "ule": lambda a, b, c: _b(a <= b),
    "ugt": lambda a, b, c: _b(a > b),
    "uge": lambda a, b, c: _b(a >= b),
    "ieq": lambda a, b, c: _b(a == b),
    "ine": lambda a, b, c: _b(a != b),
    "flt": lambda a, b, c: _b(_f(a) < _f(b)),
    "fle": lambda a, b, c: _b(_f(a) <= _f(b)),
    "fgt": lambda a, b, c: _b(_f(a) > _f(b)),
    "fge": lambda a, b, c: _b(_f(a) >= _f(b)),
    "feq": lambda a, b, c: _b(_f(a) == _f(b)),
    "fne": lambda a, b, c: _b(_f(a) != _f(b)),
    "and": lambda a, b, c: a & b,
    "or": lambda a, b, c: a | b,
    "not": lambda a, b, c: a ^ np.uint64(1),
    "ineg": lambda a, b, c: np.uint64(0) - a,
    "fneg": lambda a, b, c: a ^ _SIGN,
    "i2f": lambda a, b, c: _u(_s(a).astype(np.float64)),
    "u2f": lambda a, b, c: _u(a.astype(np.float64)),
    "f2i": lambda a, b, c: _f2i(a),
    "f2u": lambda a, b, c: _f2u(a),
    "ftrunc": lambda a, b, c: _u(np.trunc(_f(a))),
    "sel": lambda a, b, c: np.where(a != 0, b, c),
}
assert set(_OPS) == set(kp.OPS)


def _widen(kind, a):
    if kind == "u16":
        return a.view(np.uint16).astype(np.uint64)
    if kind == "u32":
        return a.view(np.uint32).astype(np.uint64)
    if kind in ("i16", "i32"):
        return a.astype(np.int64).view(np.uint64)
    if kind == "b8":
        return (a != 0).astype(np.uint64)
    return np.ascontiguousarray(a).view(np.uint64)


def interpret(host, streams, n):
    """Run ``host`` (a HostProgram) over the tensors ``streams``: (its
    result as 64-bit words, the validity it computes or None)."""
    kinds = [kp.KINDS[host.kind[i]] for i in range(host.nstreams)]
    data = [_widen(k, t.cpu().numpy()) for k, t in zip(kinds, streams)]
    assert all(len(d) == n for d in data)
    slots, acc = {}, np.zeros(n, np.uint64)

    def fetch(src, idx):
        if src == kp.ACC:
            return acc
        if src == kp.SLOT:
            return slots[idx]
        if src == kp.IMM:
            return np.full(n, host.imm[idx], np.uint64)
        if src == kp.STREAM:
            return data[idx]
        assert src == kp.NONE
        return None

    with np.errstate(all="ignore"):
        for i in range(host.nins):
            ins = host.ins[i]
            value = _OPS[kp.OPS[ins.op & ((1 << kp.COMBINE_SHIFT) - 1)]](
                fetch(ins.ak, ins.a), fetch(ins.bk, ins.b), fetch(ins.ck, ins.c))
            combine = ins.op >> kp.COMBINE_SHIFT
            assert combine in kp.COMBINE.values()
            acc = acc & value if combine == kp.COMBINE["and"] else \
                acc | value if combine == kp.COMBINE["or"] else value
            if ins.save != kp.NO_SLOT:
                assert ins.save < host.nslots
                slots[ins.save] = acc
    valid = slots[host.valid_slot] != 0 if host.valid_slot >= 0 else None
    return acc, valid


def numpy_launch(program, streams, n, out, valid_out=None):
    """kernels.expr_program.launch with the numpy interpreter in the
    kernel's place."""
    data, valid = interpret(program, streams, n)
    assert bool(program.out_bool) == (out.dtype == torch.bool)
    if out.dtype == torch.bool:
        out.copy_(torch.from_numpy(data != 0))
    else:
        out.copy_(torch.from_numpy(data.view(np.int64)).view(out.dtype))
    assert (valid is None) == (valid_out is None)
    if valid_out is not None:
        valid_out.copy_(torch.from_numpy(valid))


@pytest.fixture
def program_on_cpu(monkeypatch):
    """compile_expr takes the program on the CPU too, and the numpy
    interpreter runs it."""
    monkeypatch.setattr(torch_expr, "_takes_program", lambda device: True)
    monkeypatch.setattr(kp, "launch", numpy_launch)


def counters():
    return torch_expr.PROGRAM_LAUNCHES, torch_expr.PROGRAM_FALLBACKS


_CORPUS = {}


def corpus_provider():
    if not _CORPUS:
        _CORPUS["p"] = provider_of(t=corpus_relation(N))
    return _CORPUS["p"]


# -- the corpus -------------------------------------------------------------------


@pytest.mark.parametrize("snippet", SNIPPETS + EXTRA)
def test_program_matches_the_torch_path(snippet, program_on_cpu):
    """The snippet over the stored columns: one program launch (or a
    fallback, or the stored column itself) whose result equals the
    PyTorch path's."""
    _scan, expr, cols = planned(snippet, corpus_provider(), torch.device("cpu"))
    want = torch_expr.compile_torch(expr, cols, N)
    before = counters()
    got = torch_expr.compile_expr(expr, cols, N, torch.device("cpu"))
    assert_same(got, want, N, snippet)
    launches, fallbacks = (a - b for a, b in zip(counters(), before))
    prog = torch_expr.program_for(expr, cols)
    if snippet in FALLBACK:
        assert prog is None and (launches, fallbacks) == (0, 1)
    elif snippet in IDENTITY:
        assert prog.identity is not None and (launches, fallbacks) == (0, 0)
        assert got.data is cols[prog.identity].data
    else:
        assert prog is not None and prog.identity is None
        assert (launches, fallbacks) == (1, 0)
        assert 0 < prog.ops <= kp.MAX_INS


@pytest.mark.parametrize("snippet", SNIPPETS + EXTRA)
def test_program_reads_through_the_select_list(snippet, program_on_cpu):
    """The same snippet as a reference to the scan's output (as the
    GROUP BY, ORDER BY and join routes see aggregate arguments and keys):
    the program reads the stored columns under it and leaves the scan's
    select list unevaluated (no widened copy); the result equals the
    PyTorch path's over the materialised select list."""
    scan, expr, cols = planned(snippet, corpus_provider(), torch.device("cpu"))
    ref = ColumnReferenceNode(None, expr.return_type(), 0)
    want = torch_expr.compile_torch(ref, device_exec._LazyScanCols(scan, cols, N, "cpu"), N)
    scan_cols = device_exec._LazyScanCols(scan, cols, N, "cpu")
    got = torch_expr.compile_expr(ref, scan_cols, N, torch.device("cpu"))
    assert_same(got, want, N, snippet)
    prog = torch_expr.program_for(ref, scan_cols)
    if snippet not in FALLBACK:
        assert scan_cols._cols == {}, "the program widened a copy of the select list"
        assert prog.streams == torch_expr.program_for(expr, cols).streams
        for j, plane, kind in prog.streams:
            t = cols[j].data if plane == "data" else cols[j].valid
            assert kind == stored_kind(cols[j].stype, t.dtype), snippet


def stored_kind(stype, dtype):
    """The kind of stream the kernel reads a stored plane as."""
    named = {torch.float64: "f64", torch.bool: "b8", torch.int64: "i64"}.get(dtype)
    if named:
        return named
    bits = {torch.int16: 16, torch.int32: 32}[dtype]
    return f"{'i' if stype == SType.INT64 else 'u'}{bits}"


@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1025])
def test_program_at_small_and_ragged_sizes(n, program_on_cpu):
    """Every launching snippet at sizes around the kernel's block."""
    provider = provider_of(t=corpus_relation(n, seed=n))
    for snippet in SNIPPETS + EXTRA:
        if snippet in FALLBACK or snippet in IDENTITY:
            continue
        _scan, expr, cols = planned(snippet, provider, torch.device("cpu"))
        want = torch_expr.compile_torch(expr, cols, n)
        assert_same(torch_expr.compile_expr(expr, cols, n, torch.device("cpu")), want, n,
                    snippet)


# -- the rule ---------------------------------------------------------------------


@pytest.mark.parametrize("snippet,why", [
    ("un % 7", "mod"), ("pow(small, 2)", "pow"), ("f / 2.0", "div"),
    ("s = s2", "string"), ("from_timestamp(small)", "from_timestamp"),
    ("if(un < 500, s, s2)", "string if"),
])
def test_fallback_rule(snippet, why, program_on_cpu):
    """Nodes the program does not reproduce send the whole expression to
    the PyTorch path, counted as a fallback."""
    _scan, expr, cols = planned(snippet, corpus_provider(), torch.device("cpu"))
    assert torch_expr.program_for(expr, cols) is None, why
    before = counters()
    try:
        want = torch_expr.compile_torch(expr, cols, N)
    except torch_expr.UnsupportedExpression:
        with pytest.raises(torch_expr.UnsupportedExpression):
            torch_expr.compile_expr(expr, cols, N, torch.device("cpu"))
    else:
        assert_same(torch_expr.compile_expr(expr, cols, N, torch.device("cpu")), want, N)
    assert counters() == (before[0], before[1] + 1)


@pytest.mark.parametrize("dtype,stype", [
    (torch.int8, SType.INT64), (torch.uint8, SType.UINT64), (torch.float32, SType.FLOAT64),
    (torch.int32, SType.FLOAT64), (torch.int16, SType.BOOL),
])
def test_fallback_on_a_width_the_kernel_does_not_load(dtype, stype, program_on_cpu):
    """A column stored at a width or dtype the kernel does not read goes
    to the PyTorch path."""
    _scan, expr, cols = planned("un + w", corpus_provider(), torch.device("cpu"))
    odd = torch_expr.DeviceCol(stype, torch.arange(N).to(dtype), cols[0].valid)
    cols = [odd if k == 0 else c for k, c in enumerate(cols)]
    assert torch_expr.program_for(expr, cols) is None
    before = counters()
    torch_expr.compile_expr(expr, cols, N, torch.device("cpu"))
    assert counters() == (before[0], before[1] + 1)


@pytest.mark.parametrize("case", ["sliced", "short", "broadcast valid"])
def test_fallback_on_a_stream_that_is_not_n_contiguous_rows(case, program_on_cpu):
    """The shape is read at each launch: a stream that is not n
    contiguous rows sends that call to the PyTorch path."""
    _scan, expr, cols = planned("if(isnull(un), w, un)", corpus_provider(),
                                torch.device("cpu"))
    k = next(k for k, c in enumerate(cols) if c.data.dtype == torch.int16)
    c = cols[k]
    if case == "sliced":
        c = torch_expr.DeviceCol(c.stype, torch.stack([c.data, c.data], 1)[:, 0], c.valid)
    elif case == "short":
        c = torch_expr.DeviceCol(c.stype, c.data[:-1], c.valid[:-1])
    else:
        c = torch_expr.DeviceCol(c.stype, c.data, torch.ones((), dtype=torch.bool))
    cols = [c if j == k else x for j, x in enumerate(cols)]
    assert torch_expr.program_for(expr, cols) is not None
    before = counters()
    if case == "short":
        with pytest.raises(RuntimeError):
            torch_expr.compile_expr(expr, cols, N, torch.device("cpu"))
    else:
        want = torch_expr.compile_torch(expr, cols, N)
        assert_same(torch_expr.compile_expr(expr, cols, N, torch.device("cpu")), want, N)
    assert counters() == (before[0], before[1] + 1)


@pytest.mark.parametrize("snippet,words", [
    ("u > 9223372036854775808", {1 << 63}),
    ("u2 <= 18446744073709551615", {(1 << 64) - 1}),
    ("u + 18446744073709551615", {(1 << 64) - 1}),
    ("u * 9223372036854775808", {1 << 63}),
])
def test_literals_above_two_to_the_63(snippet, words, program_on_cpu):
    """A u64 literal travels as its 64 bits, and the unsigned compares
    order above 2^63."""
    _scan, expr, cols = planned(snippet, corpus_provider(), torch.device("cpu"))
    prog = torch_expr.program_for(expr, cols)
    assert set(prog.imms) == words
    assert set(prog.host.imm[i] for i in range(len(prog.imms))) == words
    want = torch_expr.compile_torch(expr, cols, N)
    assert_same(torch_expr.compile_expr(expr, cols, N, torch.device("cpu")), want, N)


# -- the benchmark's expressions, through their routes ------------------------------


def _traffic_sql(name, **params):
    with open(os.path.join(ROOT, "gpubench", "traffic", f"{name}.json")) as f:
        return [q["sql"].format(**params) for q in json.load(f)["queries"]]


def lineitem_relation(n, seed=7):
    """TPC-H LINEITEM's Q1 / Q6 columns at n rows, with the spans
    gpubench/configs/tpch_sf10_lineitem.json states (so they narrow
    alike: u16 quantity, discount, tax, ship date; u32 price)."""
    rng = np.random.default_rng(seed)
    ones = np.ones(n, bool)
    U, S = int(SType.UINT64), int(SType.STRING)
    span = lambda lo, hi: rng.integers(lo, hi + 1, n).astype(np.uint64)
    return relation_from_numpy(
        ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
         "l_returnflag", "l_linestatus"],
        [(U, span(1, 50), ones, None), (U, span(90000, 10495000), ones, None),
         (U, span(0, 10), ones, None), (U, span(0, 8), ones, None),
         (U, span(8036, 10561), ones, None),
         (S, rng.integers(0, 3, n).astype(np.int32), ones,
          np.array([b"A", b"N", b"R"], dtype=object)),
         (S, rng.integers(0, 2, n).astype(np.int32), ones,
          np.array([b"F", b"O"], dtype=object))])


def hits_relation(seed=9):
    """ClickBench hits' four columns of Q2, Q7, Q8, Q9: 90 regions, region
    k on k rows, each row its own user, and 20 advertising engines, engine
    j on j rows, so that no two groups tie on the orders the queries ask."""
    rng = np.random.default_rng(seed)
    region = np.repeat(np.arange(1, 91) * 331, np.arange(1, 91)).astype(np.uint64)
    n = len(region)
    adv = np.zeros(n, np.uint64)
    adv[:210] = np.repeat(np.arange(1, 21) * 2 + 11, np.arange(1, 21))
    order = rng.permutation(n)
    ones = np.ones(n, bool)
    U = int(SType.UINT64)
    width = rng.choice([1920, 1366, 1280, 360, 2048], n).astype(np.uint64)
    user = rng.permutation(1 << 20)[:n].astype(np.uint64) * 8796093022207
    return relation_from_numpy(
        ["AdvEngineID", "ResolutionWidth", "RegionID", "UserID"],
        [(U, adv[order], ones, None), (U, width, ones, None), (U, region[order], ones, None),
         (U, user, ones, None)])


# (query, its table, the program launches it makes)
BENCH_QUERIES = [
    ("tpch_q1", _traffic_sql("tpch_q1", cutoff=10471)[0], "lineitem", 6),
    ("tpch_q6", _traffic_sql("tpch_q6", date=[8766, 9131], disc=[5, 7], quantity=24)[0],
     "lineitem", 2),
    *[(f"hits_{q}", sql, "hits", k) for q, sql, k in zip(
        ("q2", "q7", "q8", "q9"), _traffic_sql("hits_dashboard"), (1, 0, 0, 1))],
]


def bench_provider(n=4099):
    return provider_of(lineitem=lineitem_relation(n), hits=hits_relation())


@pytest.mark.parametrize("name,sql,table,launches", BENCH_QUERIES,
                         ids=[q[0] for q in BENCH_QUERIES])
def test_benchmark_queries_run_one_program_an_expression(name, sql, table, launches,
                                                         program_on_cpu, monkeypatch):
    """Each benchmark query through its route on the CPU device with the
    program taken: the launches the cell expects, no fallback, no
    select-list copy, each program's result equal to the PyTorch path's,
    and the rows equal to the host engine's."""
    provider = bench_provider()
    results = []
    compile_expr = torch_expr.compile_expr

    def checked(expr, columns, n, device=None):
        got = compile_expr(expr, columns, n, device)
        plain = columns
        if hasattr(columns, "exprs"):  # the select list, materialised apart
            plain = [torch_expr.compile_torch(e, columns.stored, n, device).full(n)
                     for e in columns.exprs]
        want = torch_expr.compile_torch(expr, plain, n, device)
        assert_same(got, want, n, name)
        results.append(got)
        return got

    def refuse(self, i):
        raise AssertionError("a select-list column was materialised")

    monkeypatch.setattr(torch_expr, "compile_expr", checked)
    monkeypatch.setattr(device_exec._LazyScanCols, "__getitem__", refuse)
    rt = Runtime(device="cpu")
    before = counters()
    got = rt.build_query_plan(rt.new_transaction(provider), sql).execute(0).rows
    assert counters() == (before[0] + launches, before[1]), name
    assert len(results) >= launches
    host = Runtime(device=None)
    assert got == host.build_query_plan(host.new_transaction(provider), sql).execute(0).rows


def test_one_program_a_plan_reused_across_queries(program_on_cpu, monkeypatch):
    """Q1 and Q6 run three times each through a plan cache: each
    expression's program is built once, the first time, and the same
    object serves the later queries."""
    built = []
    build = torch_expr._build

    def counted(*args):
        prog = build(*args)
        built.append(prog)
        return prog

    monkeypatch.setattr(torch_expr, "_build", counted)
    provider = bench_provider()
    rt = Runtime(plan_cache=PlanCache(), device="cpu")
    for name, sql, _table, launches in BENCH_QUERIES[:2]:
        before = len(built)
        for k in range(3):
            rt.build_query_plan(rt.new_transaction(provider), sql).execute(0)
            assert len(built) == before + launches, (name, k)
    assert len({id(p) for p in built}) == 8


# -- every route takes the program -------------------------------------------------


def route_provider(n=5003, seed=12, mesh_shards=None, mesh_device="cpu"):
    """A fact table t (string key k, u16 v, u32 w, u64 ts, join key dk)
    and a dimension table d1 (k, region); over ``mesh_shards`` shards on
    ``mesh_device`` where given."""
    from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

    rng = np.random.default_rng(seed)
    ones = np.ones(n, bool)
    U, S = int(SType.UINT64), int(SType.STRING)
    keys = np.array([b"k%02d" % i for i in range(30)], dtype=object)
    t = relation_from_numpy(
        ["k", "v", "w", "ts", "dk"],
        [(S, rng.integers(0, 30, n).astype(np.int32), ones, keys),
         (U, rng.integers(0, 1000, n).astype(np.uint64), ones, None),
         (U, rng.integers(0, 1 << 20, n).astype(np.uint64), ones, None),
         (U, rng.permutation(n).astype(np.uint64) * np.uint64(2654435761) << np.uint64(8), ones,
          None),
         (U, rng.integers(0, 128, n).astype(np.uint64) * 7 + 3, ones, None)])
    regions = np.array([b"r%d" % i for i in range(9)], dtype=object)
    d1 = relation_from_numpy(
        ["k", "region"],
        [(U, rng.permutation(64).astype(np.uint64) * 7 + 3, np.ones(64, bool), None),
         (S, rng.integers(0, 9, 64).astype(np.int32), np.ones(64, bool), regions)])
    p = MeshTableProvider(n_shards=mesh_shards, device=mesh_device) if mesh_shards else \
        RelationTableProvider()
    p.add_table("t", t)
    p.add_table("d1", d1)
    return p


# (name, sql, route counter, module of the counter, program launches a query)
ROUTE_QUERIES = [
    ("topk", "select ts, v from t where v < 800 and w >= 1000 order by ts limit 10;",
     "SCAN_TOPK_COUNT", "device_exec", 1),
    ("order", "select v + w, ts from t where v < 10 order by v + w desc, ts;",
     "SCAN_ORDER_COUNT", "device_exec", 2),
    ("join", "select d1.region, count(1), sum(t.v * 2) from t join d1 on t.dk = d1.k"
     " where t.v < 800 and t.w < 524288 group by d1.region;",
     "JOIN_GROUPBY_COUNT", "device_exec", 2),
    ("general", "select k, min(v * 3), mean(w) from t where v < 800 and w < 524288 group by k;",
     "GENERAL_GROUPBY_COUNT", "device_exec", 3),
    ("mesh_groupby", "select k, count(1), sum(v) from t where v < 800 and w < 524288"
     " group by k;", "MESH_GROUPBY_RUNS", "mesh_exec", 4),
]


def run_route_query(provider, sql, device):
    rt = Runtime(device=device)
    return rt.build_query_plan(rt.new_transaction(provider), sql).execute(0).rows


@pytest.mark.parametrize("name,sql,counter,module,launches", ROUTE_QUERIES,
                         ids=[q[0] for q in ROUTE_QUERIES])
def test_every_route_takes_the_program(name, sql, counter, module, launches, program_on_cpu):
    """The ORDER BY, top-k, join, general GROUP BY and mesh routes call
    compile_expr and take the program by the same rule (the mesh: one
    launch a shard), with no fallback; their rows equal the host
    engine's."""
    from eventql_tpu_torch.exec import mesh_exec

    mod = {"device_exec": device_exec, "mesh_exec": mesh_exec}[module]
    mesh = module == "mesh_exec"
    provider = route_provider(mesh_shards=4 if mesh else None)
    before, routed = counters(), getattr(mod, counter)
    got = run_route_query(provider, sql, None if mesh else "cpu")
    assert getattr(mod, counter) == routed + 1, name
    assert counters() == (before[0] + launches, before[1]), name
    assert got == run_route_query(route_provider(), sql, None), name


def test_probe_rehearses_on_the_cpu(program_on_cpu):
    """The probe of the kernel alone (eventql_tpu_torch/scripts/
    probe_expr_program.py) runs its four cases on the CPU: each program
    equal to the PyTorch path, no time measured."""
    from eventql_tpu_torch.scripts import probe_expr_program

    res = probe_expr_program.main(["--device", "cpu", "--n", "5003"])
    assert {k: (c["ops"], c["streams"]) for k, c in res["cases"].items()} == {
        "q1_charge": (4, ["u32", "u16", "u16"]), "q1_mean_quantity": (1, ["u16"]),
        "q6_where": (5, ["u16", "u16", "u16"]), "q6_revenue": (1, ["u32", "u16"])}
    assert all(c["ms"] is None and c["bytes"] > 0 for c in res["cases"].values())


def test_concurrent_queries_build_each_program_once(program_on_cpu, monkeypatch):
    """Sixteen threads (more than the cores) evaluate the same three
    expressions of one plan at once, with a short switch interval: each
    program is built once, every thread gets it, and every result equals
    the PyTorch path's."""
    import sys
    import threading

    built = []
    build = torch_expr._build

    def counted(*args):
        built.append(args[0])
        return build(*args)

    monkeypatch.setattr(torch_expr, "_build", counted)
    planned_exprs = [planned(s, corpus_provider(), torch.device("cpu"))
                     for s in ("u < u2 and i < 0", "w * (100 - un) * (100 + small)",
                               "if(isnull(un), w, un)")]
    wants = [torch_expr.compile_torch(e, c, N) for _s, e, c in planned_exprs]
    errors, done = [], []

    def work():
        try:
            for _ in range(5):
                for (_s, e, c), want in zip(planned_exprs, wants):
                    assert_same(torch_expr.compile_expr(e, c, N, torch.device("cpu")), want, N)
            done.append(1)
        except Exception as e:  # recorded for the main thread's assert
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(done) == 16, errors[:1]
    assert sorted(map(id, built)) == sorted(id(e) for _s, e, _c in planned_exprs)
