"""The port's counterparts of the repository's three TPU probe kernels
(``scripts/probe_*.py``) against the probes' JAX functions.

The probe scripts are loaded by file path and their Pallas kernels run
in TPU interpret mode (``pltpu.force_tpu_interpret_mode()``) on the CPU:
``placement`` (probe_radix.py) against ``kernels/probes.place_runs``,
``sum_count_i8`` (probe_groupby_i8.py) against ``groupby_agg_plain``,
and the five int8 kernel bodies of probe_int8_ops.py against
``int8_form``. On CPU tensors the wrappers are their plain versions.
Inputs are made with numpy from a seed; tolerance: exact equality.
Also pinned: ROADMAP C18 (``sum_count_i8`` raises below 897 buckets,
where ``groupby_agg_plain`` is exact), the plain versions' edges, and the
port's probe scripts end to end on the CPU.
"""

import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from eventql_tpu_torch.kernels import probes
from eventql_tpu_torch.kernels.groupby_agg import groupby_agg, groupby_agg_plain
from eventql_tpu_torch.scripts import probe_groupby_i8, probe_int8_ops, probe_radix

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_RADIX = _script("probe_radix")
JAX_I8 = _script("probe_groupby_i8")
JAX_OPS = _script("probe_int8_ops")

# the five bodies in the order of probe_int8_ops.py's main and INT8_CASES
JAX_FORMS = [JAX_OPS.k_select_i8, JAX_OPS.k_muli_i8, JAX_OPS.k_convert_i8,
             JAX_OPS.k_select_i8_var, JAX_OPS.k_mul_i32_to_i8]


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _words(rng, rows):
    return rng.integers(0, 2**32, (rows, 128), dtype=np.uint32)


# -- P1: run placement ----------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 2, 8])
def test_place_runs_equals_the_jax_placement(rows):
    """Runs that cover the array, each to a permuted slot."""
    rng = np.random.default_rng(100 + rows)
    nruns = 16
    src = _words(rng, nruns * rows)
    perm = rng.permutation(nruns)
    src_off = (np.arange(nruns) * rows).astype(np.int32)
    dst_off = (perm * rows).astype(np.int32)
    want = np.asarray(JAX_RADIX.placement(jnp.asarray(src), jnp.asarray(src_off),
                                          jnp.asarray(dst_off), rows=rows, nruns=nruns))
    got = probes.place_runs(torch.from_numpy(src.view(np.int32)), torch.from_numpy(src_off),
                            torch.from_numpy(dst_off), rows)
    assert got.dtype == torch.int32 and got.shape == src.shape
    assert (got.numpy().view(np.uint32) == want).all()
    for i in range(nruns):  # and the contract, written out
        assert (want[perm[i] * rows:(perm[i] + 1) * rows] == src[i * rows:(i + 1) * rows]).all()


def test_place_runs_with_no_runs_leaves_out_as_it_was():
    src = torch.from_numpy(_words(np.random.default_rng(1), 4).view(np.int32))
    none = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(probes.place_runs(src, none, none, 2), torch.zeros_like(src))
    out = torch.full_like(src, 5)
    assert probes.place_runs(src, none, none, 2, out=out) is out
    assert bool((out == 5).all())


def test_place_runs_keeps_the_rows_no_run_writes():
    rng = np.random.default_rng(2)
    src = torch.from_numpy(_words(rng, 12).view(np.int32))
    out = torch.full((20, 128), -3, dtype=torch.int32)
    got = probes.place_runs(src, torch.tensor([8, 0], dtype=torch.int32),
                            torch.tensor([2, 14], dtype=torch.int32), 4, out=out.clone())
    want = out.clone()
    want[2:6], want[14:18] = src[8:12], src[0:4]
    assert torch.equal(got, want)
    assert torch.equal(probes.place_runs_plain(src, torch.tensor([8, 0], dtype=torch.int32),
                                               torch.tensor([2, 14], dtype=torch.int32), 4,
                                               out=out.clone()), want)


def test_place_runs_skips_runs_that_leave_their_array():
    src = torch.arange(6 * 128, dtype=torch.int32).view(6, 128)
    so = torch.tensor([0, -1, 5, 2, 4], dtype=torch.int32)
    do = torch.tensor([0, 2, 2, 5, 2], dtype=torch.int32)  # rows 2-3 of 6 and 5-6 of 6 leave
    got = probes.place_runs(src, so, do, 2)
    want = torch.zeros_like(src)
    want[0:2], want[2:4] = src[0:2], src[4:6]
    assert torch.equal(got, want)


def test_place_runs_checks_its_arguments():
    src = torch.zeros((4, 128), dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        probes.place_runs(src.to(torch.int64), off, off, 1)
    with pytest.raises(ValueError, match="128"):
        probes.place_runs(torch.zeros((4, 64), dtype=torch.int32), off, off, 1)
    with pytest.raises(ValueError, match="int32"):
        probes.place_runs(src, off.to(torch.int64), off, 1)
    with pytest.raises(ValueError, match="differ"):
        probes.place_runs(src, off, torch.zeros(2, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="at least 1"):
        probes.place_runs(src, off, off, 0)
    with pytest.raises(ValueError, match="share memory"):
        probes.place_runs(src, off, off, 1, out=src)


# -- P2: the int8-plane sum / count ---------------------------------------------------


def _sum_count_data(n, K, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, K, n).astype(np.int32)
    values = rng.integers(0, 1000, n).astype(np.uint64)
    return gid, values, values < 800


def _numpy_sum_count(gid, values, mask, K, value_bits=16):
    kept = mask & (gid >= 0) & (gid < K)
    low = values[kept] & np.uint64((1 << value_bits) - 1)
    counts = np.bincount(gid[kept], minlength=K)
    sums = np.zeros(K, np.uint64)
    np.add.at(sums, gid[kept], low)
    return counts, sums


def _port_sum_count(gid, values, mask, K, value_bits=16):
    out = groupby_agg_plain(torch.from_numpy(gid), len(gid), K,
                            values=torch.from_numpy(values.view(np.int64)),
                            value_bits=value_bits, mask=torch.from_numpy(mask))
    return out[0].numpy(), out[1].numpy().view(np.uint64)


@pytest.mark.parametrize("K", [1024, 2048])
def test_groupby_agg_equals_the_jax_sum_count_i8(K):
    gid, values, mask = _sum_count_data(16384, K, K)
    c8, s8 = JAX_I8.sum_count_i8(jnp.asarray(mask), jnp.asarray(gid), jnp.asarray(values), K,
                                 value_bits=16)
    counts, sums = _port_sum_count(gid, values, mask, K)
    assert counts.tolist() == np.asarray(c8).tolist()
    assert sums.tolist() == np.asarray(s8).tolist()
    want = _numpy_sum_count(gid, values, mask, K)
    assert counts.tolist() == want[0].tolist() and sums.tolist() == want[1].tolist()
    # the wrapper on CPU tensors is the plain version
    wrapped = groupby_agg(torch.from_numpy(gid), len(gid), K,
                          values=torch.from_numpy(values.view(np.int64)), value_bits=16,
                          mask=torch.from_numpy(mask))
    assert wrapped[0].tolist() == counts.tolist()


def test_c18_sum_count_i8_raises_below_897_buckets_where_groupby_agg_is_exact():
    """ROADMAP C18, a fault of the JAX-side probe: its iota8_k1 scratch has
    max(k1, 8) rows and is compared with a (k1, B) plane, so every K below
    7 * 128 + 1 fails to trace."""
    K = 300
    gid, values, mask = _sum_count_data(16384, K, 3)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JAX_I8.sum_count_i8(jnp.asarray(mask), jnp.asarray(gid), jnp.asarray(values), K,
                            value_bits=16)
    counts, sums = _port_sum_count(gid, values, mask, K)
    want = _numpy_sum_count(gid, values, mask, K)
    assert counts.tolist() == want[0].tolist() and sums.tolist() == want[1].tolist()


# -- P3: the five int8 forms ----------------------------------------------------------


def _jax_form(kernel, a, b):
    """One probe body over an (8, 128) tile, launched as run_case does."""
    f = pl.pallas_call(
        kernel,
        out_specs=pl.BlockSpec((8, 128), lambda: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        in_specs=[pl.BlockSpec((8, 128), lambda: (0, 0), memory_space=pltpu.VMEM)] * 2,
    )
    return np.asarray(f(jnp.asarray(a), jnp.asarray(b)))


def _tiles():
    tile = np.arange(8 * 128).reshape(8, 128)
    return {"the probe's tile": ((tile % 7).astype(np.int32), (tile % 5).astype(np.int32)),
            "around +-128": probe_int8_ops.probe_inputs((8, 128), 5),
            "negative and wide": (
                np.random.default_rng(6).integers(-2**31, 2**31, (8, 128)).astype(np.int32),
                np.random.default_rng(7).integers(-2**31, 0, (8, 128)).astype(np.int32))}


def _numpy_form(k, a, b):
    """The five forms, written out in numpy (astype(int8) wraps)."""
    i8 = lambda x: x.astype(np.int8).astype(np.int32)  # noqa: E731
    eq = (a == b).astype(np.int32)
    return [eq, i8(i8(a) * i8(b)), i8(a), np.where(a == b, i8(b), 0), i8(b * eq)][k]


@pytest.mark.parametrize("tile", list(_tiles()))
@pytest.mark.parametrize("case", probes.INT8_CASES)
def test_int8_form_equals_the_jax_probe_body(case, tile):
    a, b = _tiles()[tile]
    k = probes.INT8_CASES.index(case)
    want = _jax_form(JAX_FORMS[k], a, b)
    got = probes.int8_form(torch.from_numpy(a), torch.from_numpy(b), case)
    assert got.dtype == torch.int32 and got.shape == (8, 128)
    assert (got.numpy() == want).all()
    assert (got.numpy() == _numpy_form(k, a, b)).all()


@pytest.mark.parametrize("case", probes.INT8_CASES)
def test_int8_form_plain_on_negative_inputs_and_any_shape(case):
    rng = np.random.default_rng(8)
    a = rng.integers(-1000, 0, 1001).astype(np.int32)
    b = np.where(rng.random(1001) < 0.5, a, rng.integers(-1000, 0, 1001)).astype(np.int32)
    k = probes.INT8_CASES.index(case)
    got = probes.int8_form_plain(torch.from_numpy(a), torch.from_numpy(b), case)
    assert (got.numpy() == _numpy_form(k, a, b)).all()
    assert bool((got.abs() <= 128).all())
    empty = torch.zeros((0, 3), dtype=torch.int32)
    assert probes.int8_form(empty, empty, case).shape == (0, 3)


@pytest.mark.parametrize("tile", list(_tiles()))
@pytest.mark.parametrize("case", list(probe_int8_ops.LIBRARY))
def test_int8_library_call_computes_its_form(case, tile):
    """The one PyTorch call the probe times beside a form computes it."""
    a, b = _tiles()[tile]
    _, call = probe_int8_ops.LIBRARY[case]
    got = call(torch.from_numpy(a), torch.from_numpy(b), torch.empty((8, 128), dtype=torch.int32))
    assert (got.numpy() == _numpy_form(probes.INT8_CASES.index(case), a, b)).all()


def test_int8_form_bytes_count_what_each_form_reads():
    assert [probes.int8_form_bytes(c, 10) for c in probes.INT8_CASES] == [120, 120, 80, 120, 120]


def test_int8_form_checks_its_arguments():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown int8 form"):
        probes.int8_form(a, a, "add_i8")
    with pytest.raises(ValueError, match="unknown int8 form"):
        probes.int8_form(a, a, 1)
    with pytest.raises(ValueError, match="int32"):
        probes.int8_form(a.to(torch.int64), a, 0)
    with pytest.raises(ValueError, match="differ"):
        probes.int8_form(a, torch.zeros(5, dtype=torch.int32), 0)


# -- the port's probe scripts on the CPU --------------------------------------------------


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args)
    return result, out.getvalue()


def test_probe_radix_runs_on_the_cpu_and_measures_nothing():
    result, text = _quiet(probe_radix.main, ["--device", "cpu", "--n", "32768"])
    assert [r["run"] for r in result["placement"]] == list(probe_radix.RUNS)
    assert [r["buckets"] for r in result["histogram"]] == [256, 2048]
    assert len(result["sorts"]) == 4 and len(result["gather"]) == 2
    assert all(r["ms"] is None for part in ("sorts", "placement", "histogram", "gather")
               for r in result[part])
    assert text.count("not measured") >= 12 and "bound" in text


def test_probe_groupby_i8_and_int8_ops_run_on_the_cpu():
    result, text = _quiet(probe_groupby_i8.main, ["--device", "cpu", "--rows", "20000"])
    assert result["exact"] and result["value_bits"] == 16 and result["ms"] is None
    forms, text = _quiet(probe_int8_ops.main, ["--device", "cpu", "--n", "999"])
    assert list(forms) == list(probes.INT8_CASES)
    # the samples the TPU probe prints for its own tile
    assert [forms[c]["sample"] for c in probes.INT8_CASES] == [
        [1, 1, 1, 1], [0, 1, 4, 9], [0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3]]
    assert [forms[c]["library"].startswith("none") for c in probes.INT8_CASES] == [
        False, False, False, True, True]
    assert probes.LAUNCHES == {"place_runs": 0, "int8_form": 0}


def test_probes_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (probe_radix.main, probe_groupby_i8.main, probe_int8_ops.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
