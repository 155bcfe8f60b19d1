"""The port's CUDA kernels on a real card.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q

Everywhere else these tests skip (the decision is made inside the
fixture, at run time). They drive the same cases as chip_smoke.py's
phases 3, 4 and 5 at a small size: every kernel wrapper against its plain
PyTorch version on CUDA tensors, and the SQL routes on the card (GROUP BY
sum/count, ORDER BY, ORDER BY ... LIMIT, fact-dim JOIN + GROUP BY)
against numpy and the port's host engine. Tolerance: exact equality.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.cuda


KERNELS = {"groupby_agg", "groupby_multi_agg", "extract_ge", "dim_join_gid",
           "probe_join_gid", "hash_groupby"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", torch.cuda.current_device())


def test_kernels_equal_plain_versions_on_the_card(cuda_device):
    import chip_smoke

    before = chip_smoke.launch_counts()
    chip_smoke.phase_kernels(cuda_device, 200_003)
    after = chip_smoke.launch_counts()
    assert set(after) == KERNELS
    assert all(after[k] > before[k] for k in before)


def test_probe_kernels_equal_plain_versions_on_the_card(cuda_device):
    """place_runs and int8_form: chip_smoke.py phase 3's cases at 2^20
    words (covering and partial runs, runs leaving the array, inputs off
    a 16-byte boundary, int8 wrapping)."""
    import chip_smoke
    from eventql_tpu_torch.kernels import probes

    before = dict(probes.LAUNCHES)
    cases, errs = chip_smoke.probe_kernel_cases(cuda_device, 1 << 20)
    assert cases > 20 and errs == {"place_runs": 0, "int8_form": 0}
    assert all(probes.LAUNCHES[k] > before[k] for k in before)


def test_extract_ge_look_back_cases_on_the_card(cuda_device):
    """extract_ge: chip_smoke.py phase 3's cases at 2^20 rows (the corners
    of the look-back over tiles: matches only in the last tile, the cap
    reached in the first, one match a tile, n either side of a tile), each
    on values aligned and 1, 2 and 3 elements off a 16-byte boundary,
    against the plain version; one launch a call."""
    import chip_smoke
    from eventql_tpu_torch.kernels import extract as ex

    before = ex.LAUNCHES["extract_ge"]
    cases = chip_smoke.extract_kernel_cases(1 << 20, cuda_device, np.random.default_rng(20))
    assert cases == 4 * len(list(chip_smoke.extract_cases(8, np.random.default_rng(0))))
    assert ex.LAUNCHES["extract_ge"] == before + cases


def test_extract_ge_after_a_failed_launch(cuda_device, monkeypatch):
    """A launch that reports an error after its kernel was enqueued (an
    error left pending by an earlier call reads so) leaves the tile
    counter ahead of what the wrapper knows: the wrapper drops the
    stream's state, and the calls after it, on a fresh one, are right."""
    from eventql_tpu_torch.kernels import extract as ex

    rng = np.random.default_rng(5)
    values = torch.from_numpy(
        rng.integers(0, 1000, 3 * ex.TILE_ROWS + 5).astype(np.int32)).to(cuda_device)
    want = ex.extract_ge_plain(values, 990, 500)
    assert torch.equal(ex.extract_ge(values, 990, 500), want)
    lib = ex._lib()

    class EnqueuedThenFailed:
        def __getattr__(self, name):
            return getattr(lib, name)

        def evql_extract_ge(self, *args):
            assert lib.evql_extract_ge(*args) == 4  # the kernel's 4 tiles claimed
            return -1

    monkeypatch.setattr(ex, "_lib", EnqueuedThenFailed)
    key = (cuda_device.index, torch._C._cuda_getCurrentRawStream(cuda_device.index))
    assert key in ex._STATES
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        ex.extract_ge(values, 990, 500)
    assert key not in ex._STATES
    monkeypatch.undo()
    for _ in range(3):
        assert torch.equal(ex.extract_ge(values, 990, 500), want)


def test_probes_run_on_the_card(cuda_device):
    """The three probes at 2^20 elements: every step checked and timed."""
    from eventql_tpu_torch.scripts import probe_groupby_i8, probe_int8_ops, probe_radix

    radix = probe_radix.main(["--n", str(1 << 20)])
    assert all(r["ms"] > 0 for part in ("sorts", "placement", "histogram", "gather")
               for r in radix[part])
    assert probe_groupby_i8.main(["--rows", str(1 << 20)])["ms"] > 0
    assert all(f["ms"] > 0 for f in probe_int8_ops.main(["--n", str(1 << 20)]).values())


def test_sql_route_on_the_card_equals_host_engine(cuda_device):
    """2^22 rows: the smallest table whose single-key top-k takes the
    two histograms and the extraction kernel."""
    import chip_smoke

    run = chip_smoke.phase_main_path(cuda_device, 1 << 22, 1 << 16, 2)
    assert all(v > 0 for v in run["launches"].values())
    per_query = run["per_query"]
    assert per_query["headline"] == {"groupby_agg": 1}
    assert per_query["multi_sum"] == {"groupby_multi_agg": 1}
    assert per_query["topk_ts_desc"] == {"groupby_agg": 2, "extract_ge": 1}
    assert per_query["topk_v_desc_ties"] == {"groupby_agg": 2}
    assert run["launches_by_path"]["order_by"]["extract_ge"] == 2 * 2
    assert run["e2e"]["topk_ts_desc"]["readbacks"] == 3
    assert per_query["join_small_dim"] == {"dim_join_gid": 1, "groupby_agg": 1}
    assert per_query["join_small_dim_two_sums"] == {
        "dim_join_gid": 1, "groupby_multi_agg": 1}
    assert per_query["join_big_dim"] == {"probe_join_gid": 1, "groupby_agg": 1}
    assert run["launches_by_path"]["join"]["dim_join_gid"] == 4 * 2  # J1 too
    assert run["e2e"]["join_big_dim"]["readbacks"] == 1
    general = {**chip_smoke.GENERAL_SQL, **chip_smoke.COMPACTION_SQL}
    for name in general:
        assert per_query[name] == {"hash_groupby": 1}
        # compacted on the card, one copy (the hash tier: the group count first)
        assert run["e2e"][name]["tier"] == chip_smoke.GENERAL_TIERS[name]
        hash_tier = "hash" in chip_smoke.GENERAL_TIERS[name]
        assert run["e2e"][name]["readbacks"] == (2 if hash_tier else 1)
    # the sparse span: O(groups) words read back, not O(slots)
    sparse = run["e2e"]["G6_sparse_span"]
    assert sparse["readback_bytes"] <= 8 * 6 * sparse["groups"] < 8 * (1 << 20)
    assert per_query[chip_smoke.J1[0]] == {"dim_join_gid": 1, "hash_groupby": 1}
    assert run["launches_by_path"]["general_group_by"]["hash_groupby"] == len(general) * 2
    # each recorded call, repeated: kernel and plain version agree
    times = chip_smoke.phase_times(cuda_device, run["calls"])
    assert set(times) == KERNELS
    assert all(t["max_abs_err"] == 0 for t in times.values())


@pytest.mark.parametrize("n_dims", [1, 1024, 8192, 8193, 1 << 18])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_join_probes_equal_plain_versions_at_4m_rows(cuda_device, n_dims, width):
    """Both probes against their plain versions at 2^22 fact rows, for
    each stored width of the fact key stream; keys with the top bit of
    their width set, two rows in three a hit."""
    from eventql_tpu_torch.kernels import join as tjoin

    n = 1 << 22
    rng = np.random.default_rng(n_dims + width)
    n_dims = min(n_dims, 1 << (width - 1))
    dims = rng.choice(1 << min(width, 40), n_dims, replace=False).astype(np.uint64)
    dims <<= np.uint64(width - min(width, 40))
    bucket = rng.integers(0, 1 << 20, n_dims).astype(np.int32)
    hit = dims[rng.integers(0, n_dims, n)]
    miss = rng.integers(0, 1 << (width - 1), n).astype(np.uint64)
    fact = np.where(rng.random(n) < 0.67, hit, miss)
    signed = {16: np.int16, 32: np.int32, 64: np.int64}[width]
    f = torch.from_numpy(fact.astype(f"uint{width}").view(signed)).to(cuda_device)
    dk = torch.from_numpy(dims.view(np.int64)).to(cuda_device)
    db = torch.from_numpy(bucket).to(cuda_device)
    before = dict(tjoin.LAUNCHES)
    got = tjoin.probe_join_gid(f, dk, db, n - 3)  # the dims as they come: unsorted
    assert torch.equal(got, tjoin.probe_join_gid_plain(f, dk, db, n - 3))
    assert 0 < int((got >= 0).sum()) < n
    assert tjoin.LAUNCHES["probe_join_gid"] == before["probe_join_gid"] + 1
    assert tjoin.LAUNCHES["build_join_table"] == before["build_join_table"] + 1
    # sorted dimension rows are as valid an input
    sk, perm = tjoin.build_side(dk)
    assert torch.equal(got, tjoin.probe_join_gid(f, sk, db[perm].contiguous(), n - 3))
    if n_dims <= tjoin.MAX_COMPARE_DIMS:
        got = tjoin.dim_join_gid(f, dk, db, n - 3)
        assert torch.equal(got, tjoin.dim_join_gid_plain(f, dk, db, n - 3))
        assert tjoin.LAUNCHES["dim_join_gid"] == before["dim_join_gid"] + 1
    else:
        with pytest.raises(ValueError):
            tjoin.dim_join_gid(f, dk, db)


@pytest.mark.parametrize("key_bytes", [2, 4, 8])
def test_dim_table_mirrors_the_launchers_slot_rule(cuda_device, key_bytes):
    """dim_join_gid's launcher shapes its own table; kernels/join.py's
    dim_table (what the CPU tests pin) must be the same rule."""
    from eventql_tpu_torch.kernels import join as tjoin

    slots_of = tjoin._lib().evql_dim_table_slots
    for n_dims in range(1, tjoin.MAX_COMPARE_DIMS + 1):
        assert slots_of(n_dims, key_bytes) == tjoin.dim_table(n_dims, key_bytes).slots
    assert slots_of(0, key_bytes) == slots_of(tjoin.MAX_COMPARE_DIMS + 1, key_bytes) == -1


@pytest.mark.parametrize("n_dims", [1, 127, 1024, 8192])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_dim_join_gid_vectors_and_tails_on_the_card(cuda_device, n_dims, width):
    """dim_join_gid against its plain version for each stored width of
    the fact stream, the stream starting 0-7 rows into its allocation
    (on and off a 16-byte boundary), n around one tile of the kernel
    (1024 threads x 8 rows), against dimension keys of the stream's
    width with its all-ones key, a key beyond the width whose low bits
    are a key's, and a duplicate key further down (the lowest row wins)."""
    from eventql_tpu_torch.kernels import join as tjoin

    rng = np.random.default_rng(n_dims * width)
    top = (1 << width) - 1
    if width == 64:
        keys = rng.integers(0, 1 << 63, n_dims, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    else:
        keys = rng.choice(top, n_dims, replace=False).astype(np.uint64)
    keys[0] = top
    if width < 64 and n_dims > 2:
        keys[1] = (np.uint64(rng.integers(1, 1 << 20)) << np.uint64(width)) | keys[2]
    if n_dims > 3:
        keys[-1] = keys[3]
    bucket = rng.integers(0, 1 << 30, n_dims).astype(np.int32)
    m = 3 * 8192 + 21
    fact = np.where(rng.random(m) < 0.6, keys[rng.integers(0, n_dims, m)] & np.uint64(top),
                    rng.integers(0, 1 << min(width, 63), m, dtype=np.uint64))
    fact[::41] = top
    signed = {16: np.int16, 32: np.int32, 64: np.int64}[width]
    f = torch.from_numpy(fact.astype(f"uint{width}").view(signed)).to(cuda_device)
    dk = torch.from_numpy(keys.view(np.int64)).to(cuda_device)
    db = torch.from_numpy(bucket).to(cuda_device)
    for offset in range(8):
        for n in (1, 7, 8, 9, 4095, 4096, 4097, 8191, 8192, 8193, 16389, m - offset):
            got = tjoin.dim_join_gid(f[offset:], dk, db, n)
            assert torch.equal(got, tjoin.dim_join_gid_plain(f[offset:], dk, db, n)), (
                offset, n)
    assert int((got >= 0).sum()) > 0 and int((got < 0).sum()) > 0


@pytest.mark.parametrize("n_dims", [10, 5000, 8193, 20_000])
@pytest.mark.parametrize("skip", [0, 1, 3])
def test_probe_join_gid_duplicate_keys_and_sliced_facts_on_the_card(
        cuda_device, n_dims, skip):
    """The CPU cases of tests/test_torch_join_kernels.py on the card:
    every third dimension key again further down (the lowest row wins),
    the fact stream sliced off its 16-byte boundary, lengths around one
    tile of the probe kernel."""
    from eventql_tpu_torch.kernels import join as tjoin

    rng = np.random.default_rng(n_dims)
    dk = rng.permutation(np.arange(n_dims, dtype=np.uint64) * 104729 + 11)
    dk[::2] |= np.uint64(1 << 63)
    dk = np.concatenate([dk, dk[::3]])
    db = rng.integers(0, 1 << 30, len(dk)).astype(np.int32)
    fact = np.concatenate([dk[rng.integers(0, len(dk), 5000)],
                           rng.integers(0, 1 << 40, 500).astype(np.uint64)])
    fact = rng.permutation(fact)
    lut = {}
    for k, b in zip(dk, db):
        lut.setdefault(int(k), int(b))
    want = np.array([lut.get(int(k), -1) for k in fact], dtype=np.int32)
    f = torch.from_numpy(fact.view(np.int64)).to(cuda_device)[skip:]
    t_dk = torch.from_numpy(dk.view(np.int64)).to(cuda_device)
    t_db = torch.from_numpy(db).to(cuda_device)
    for n in (1, 7, 2047, 2048, 2049, len(fact) - skip):
        got = tjoin.probe_join_gid(f, t_dk, t_db, n)
        np.testing.assert_array_equal(got.cpu().numpy(), want[skip:skip + n])
        np.testing.assert_array_equal(
            tjoin.join_gid(f, t_dk, t_db, n).cpu().numpy(), want[skip:skip + n])


@pytest.mark.parametrize("offset", [0, 1, 3, 7])
def test_groupby_kernels_on_sliced_streams_on_the_card(cuda_device, offset):
    """The CPU cases of tests/test_torch_groupby_kernels.py on the card:
    every stream sliced ``offset`` rows into its allocation, n = 1 .. 17
    and a long stream, against the plain version."""
    from eventql_tpu_torch.kernels import groupby_agg as ga

    rng = np.random.default_rng(offset)
    m = 100_003 + offset
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)[offset:]
    mask = dev(rng.random(m) < 0.8)
    pred = dev(rng.integers(0, 1000, m).astype(np.int32))
    a = dev(rng.integers(0, 1 << 16, m).astype(np.uint16).view(np.int16))
    b = dev(rng.integers(0, 1 << 32, m, dtype=np.uint32).view(np.int32))
    c = dev(rng.integers(0, 1 << 64, m, dtype=np.uint64).view(np.int64))
    for key_dt in (np.int16, np.int32, np.int64):
        gid = dev(rng.integers(-1, 6, m).astype(key_dt))
        for n in (*range(1, 18), m - offset):
            kw = dict(gid=gid, n=n, num_buckets=5, values=a, value_bits=16,
                      mask=mask, preds=[ga.Pred("stream", "lt", 700, pred)],
                      values_unsigned=True)
            assert torch.equal(ga.groupby_agg(**kw), ga.groupby_agg_plain(**kw))
            kw = dict(gid=gid, n=n, num_buckets=5, streams=[a, b, c],
                      stream_bits=[16, 32, 64], mask=mask,
                      streams_unsigned=[True, False, False])
            assert torch.equal(ga.groupby_multi_agg(**kw),
                               ga.groupby_multi_agg_plain(**kw))


@pytest.mark.parametrize("nsums", [0, 1, 8])
def test_table_form_edges_on_the_card(cuda_device, nsums):
    """K on both sides of the edge between the table in shared memory
    and the table in global memory on this device, with 64-bit values
    so that the 32-bit words carry."""
    import chip_smoke
    from eventql_tpu_torch.kernels import groupby_agg as ga

    optin = ga.smem_optin(cuda_device)
    assert optin >= 48 * 1024
    n = 300_007
    rng = np.random.default_rng(nsums)
    vals = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64).view(np.int64))
    vals = vals.to(cuda_device)
    forms = set()
    for K in chip_smoke.table_form_edges(nsums, cuda_device):
        forms.add(ga.table_in_shared_memory(K, nsums, optin))
        gid = torch.from_numpy(rng.integers(-2, K + 2, n).astype(np.int32)).to(cuda_device)
        if nsums == 0:
            kw = dict(gid=gid, n=n, num_buckets=K)
            assert torch.equal(ga.groupby_agg(**kw), ga.groupby_agg_plain(**kw))
        else:
            kw = dict(gid=gid, n=n, num_buckets=K, streams=[vals] * nsums,
                      stream_bits=[64] * nsums)
            assert torch.equal(ga.groupby_multi_agg(**kw),
                               ga.groupby_multi_agg_plain(**kw))
    assert forms == {True, False}


def test_join_query_on_the_card_equals_host_engine(cuda_device):
    """One join query through Runtime(device="cuda"): the rows and
    their order equal the host engine's, and the route was taken."""
    import chip_smoke
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.kernels import join as tjoin

    n = 1 << 20
    cols, dictionary = chip_smoke.make_table(n, seed=5)
    provider = chip_smoke.add_dims(
        chip_smoke.provider_of(cols, dictionary, n), chip_smoke.make_dims(seed=6))
    sql = ("select d2.region, sum(t.v), sum(t.v + 1), count(1) from t join d2 on"
           " t.dk2 = d2.k where t.w < 900000 group by d2.region;")
    before = device_exec.JOIN_GROUPBY_COUNT, tjoin.LAUNCHES["probe_join_gid"]
    got = chip_smoke.run_query(Runtime(device=cuda_device), provider, sql).rows
    assert (device_exec.JOIN_GROUPBY_COUNT, tjoin.LAUNCHES["probe_join_gid"]) == (
        before[0] + 1, before[1] + 1)
    want = chip_smoke.run_query(Runtime(device=None), provider, sql).rows
    assert got == want and len(got) == chip_smoke.N_REGIONS
    assert all(r[1] != r[2] for r in got)


def test_topk_ties_on_the_card(cuda_device):
    """The descending stable sort keeps equal keys in row order on CUDA
    as on the CPU (torch.topk would not)."""
    from eventql_tpu_torch.kernels import sort as tsort

    key = torch.tensor([5, 5, 5, 1], dtype=torch.int64, device=cuda_device)
    assert tsort.topk_permutation(key, 2).tolist() == [0, 1]
    rng = np.random.default_rng(9)
    ties = torch.from_numpy(rng.integers(0, 3, 1 << 22).astype(np.int32) << 29)
    for t in (ties, ties.to(torch.int64) << 31):
        want = tsort.topk_permutation(t, 300)  # CPU tensors: plain versions
        assert torch.equal(tsort.topk_permutation(t.to(cuda_device), 300).cpu(), want)


def test_cuda_tensor_without_library_raises(cuda_device, monkeypatch, tmp_path):
    """A CUDA tensor never takes the plain version: when the kernel
    cannot be built the wrapper raises."""
    from eventql_tpu_torch.kernels import _build
    from eventql_tpu_torch.kernels import groupby_agg as ga

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(ga, "_lib_ready", False)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        _build.KernelBuildError("nvcc not found")))
    gid = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(_build.KernelBuildError):
        ga.groupby_agg(gid, 16, 4)
    from eventql_tpu_torch.kernels import extract as ex

    monkeypatch.setattr(ex, "_lib_ready", False)
    with pytest.raises(_build.KernelBuildError):
        ex.extract_ge(gid, 0, 4)
    from eventql_tpu_torch.kernels import join as tjoin

    monkeypatch.setattr(tjoin, "_lib_ready", False)
    keys = torch.zeros(16, dtype=torch.int64, device=cuda_device)
    for probe in (tjoin.dim_join_gid, tjoin.probe_join_gid):
        with pytest.raises(_build.KernelBuildError):
            probe(keys, keys[:4].contiguous(), gid[:4].contiguous())
    from eventql_tpu_torch.kernels import hash_groupby as hg

    monkeypatch.setattr(hg, "_lib_ready", False)
    with pytest.raises(_build.KernelBuildError):
        hg.hash_groupby([keys], 16)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 33, 256, 257, 16383, 16385, 100_003])
def test_hash_groupby_cases_at_every_size_on_the_card(cuda_device, n):
    """The phase-3 cases of the hash aggregate, every tier among them, at
    sizes around one run (8 rows), one block of the hash tier (256) and
    of the direct tiers (16384) and below one warp: kernel equal to its
    plain version."""
    import chip_smoke
    from eventql_tpu_torch.kernels import hash_groupby as hg

    rng = np.random.default_rng(n)
    before = hg.LAUNCHES["hash_groupby"]
    cases = 0
    for label, kw in chip_smoke.hash_cases(max(n, 20), cuda_device, rng):
        kw = dict(kw, n=min(kw["n"], n))
        got, want = hg.hash_groupby(**kw), hg.hash_groupby_plain(**kw)
        torch.cuda.synchronize()
        ok, err = chip_smoke.same_grouped(got, want)
        assert ok, f"{label} n={n}: max |diff| {err}"
        cases += 1
    assert hg.LAUNCHES["hash_groupby"] - before == cases


def test_general_route_on_the_card_never_runs_the_plain_version(cuda_device, monkeypatch):
    """G1-G5 and J1 through Runtime(device="cuda") at 2^20 rows with the
    plain grouped aggregation made to raise: the route runs the kernel,
    in the tier its spans choose, and nothing else, and its rows equal
    the host engine's."""
    import chip_smoke
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.kernels import groupby as tgroupby
    from eventql_tpu_torch.kernels import hash_groupby as hg

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on the card")

    for mod in (tgroupby, hg):
        monkeypatch.setattr(mod, "masked_grouped_aggregate", refuse)
        monkeypatch.setattr(mod, "masked_grouped_count_distinct", refuse)
    monkeypatch.setattr(hg, "hash_groupby_plain", refuse)
    n = 1 << 20
    cols, dictionary = chip_smoke.make_table(n, seed=8)
    provider = chip_smoke.add_dims(
        chip_smoke.provider_of(cols, dictionary, n), chip_smoke.make_dims(seed=9))
    rt, host = Runtime(device=cuda_device), Runtime(device=None)
    for name, sql in [*chip_smoke.GENERAL_SQL.items(), chip_smoke.J1]:
        before = (device_exec.GENERAL_GROUPBY_COUNT + device_exec.JOIN_GROUPBY_COUNT,
                  hg.LAUNCHES["hash_groupby"])
        forms = dict(hg.FORMS)
        got = chip_smoke.run_query(rt, provider, sql).rows
        assert (device_exec.GENERAL_GROUPBY_COUNT + device_exec.JOIN_GROUPBY_COUNT,
                hg.LAUNCHES["hash_groupby"]) == (before[0] + 1, before[1] + 1), name
        # at 2^20 rows G2's 2^20 slots (24 MB) pass what a direct tier may
        # take (direct_limit: 12.6 MB): the hash tier
        want = {"hash": 1} if name == "G2_key_beyond_k_cap" else chip_smoke.GENERAL_TIERS[name]
        assert chip_smoke._forms_since(forms) == want, name
        assert got == chip_smoke.run_query(host, provider, sql).rows, name


def test_hash_tier_rule_mirrors_the_launchers(cuda_device):
    """evql_hash_tier and evql_hash_distinct_form on the card equal
    tier_of and distinct_form at every boundary case."""
    import chip_smoke
    from eventql_tpu_torch.kernels import groupby_agg as ga
    from eventql_tpu_torch.kernels import hash_groupby as hg

    smem = ga.smem_optin(cuda_device)
    for n in (100_003, 1_000_003):
        for spans, nv, rows, tier in chip_smoke.tier_edges(smem, n):
            assert hg.launcher_tier(spans, nv, rows, smem) == tier == hg.tier_of(
                None if None in spans else [(0, s, False) for s in spans], nv, rows, smem)
        for slots, span, rows, form in chip_smoke.distinct_edges(smem, n):
            assert hg.launcher_distinct_form(slots, span, rows, smem) == form == (
                hg.distinct_form(slots, None if span is None else (0, span, False), rows,
                                 smem))


@pytest.mark.parametrize("n", [0, 1, 9, 100_003, 1 << 22])
def test_keyless_hash_groupby_launches_on_the_card(cuda_device, n):
    """No key, no value, no mask: the first n rows as one group, launched
    on the device the call names (the shared tier's one slot), equal to
    the plain version there."""
    import chip_smoke
    from eventql_tpu_torch.kernels import hash_groupby as hg

    before, forms = hg.LAUNCHES["hash_groupby"], dict(hg.FORMS)
    got = hg.hash_groupby([], n, device=cuda_device)
    want = hg.hash_groupby_plain([], n, device=cuda_device)
    torch.cuda.synchronize()
    assert hg.LAUNCHES["hash_groupby"] - before == 1
    assert chip_smoke._forms_since(forms) == {"shared": 1}
    assert got.counts.is_cuda and want.counts.is_cuda
    ok, err = chip_smoke.same_grouped(got, want)
    assert ok, f"max |diff| {err}"
    assert hg.in_first_row_order(got).counts.tolist() == ([n] if n else [])


def test_keyless_count_launches_on_the_card(cuda_device):
    """SELECT count(1) FROM t through Runtime(device="cuda"): the general
    route, one launch of the hash aggregate, the host engine's answer."""
    import chip_smoke
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.kernels import hash_groupby as hg

    n = 1 << 20
    cols, dictionary = chip_smoke.make_table(n, seed=8)
    provider = chip_smoke.provider_of(cols, dictionary, n)
    rt, host = Runtime(device=cuda_device), Runtime(device=None)
    for sql in ("select count(1) from t;", "select count(1) from t where v < 800;"):
        before = (device_exec.GENERAL_GROUPBY_COUNT, hg.LAUNCHES["hash_groupby"])
        got = chip_smoke.run_query(rt, provider, sql).rows
        assert (device_exec.GENERAL_GROUPBY_COUNT, hg.LAUNCHES["hash_groupby"]) == (
            before[0] + 1, before[1] + 1), sql
        assert got == chip_smoke.run_query(host, provider, sql).rows, sql


@pytest.mark.parametrize("tier", ["shared", "global", "hash"])
def test_hot_key_in_every_tier_on_the_card(cuda_device, tier):
    """Every row on one key, in each tier (the span chooses it), at 2^20
    rows: equal to the plain version, one group."""
    import chip_smoke
    from eventql_tpu_torch.kernels import hash_groupby as hg

    n = 1 << 20
    rng = np.random.default_rng(11)
    label, kw = next((lab, kw) for lab, kw in chip_smoke.hash_cases(n, cuda_device, rng)
                     if lab.startswith("shared tier"))
    spans = {"shared": [(0, 1024, False)], "global": [(0, 40000, False)], "hash": None}[tier]
    kw = dict(kw, keys=[torch.zeros(n, dtype=torch.int16, device=cuda_device)],
              key_spans=spans, distinct_spans=None)
    forms = dict(hg.FORMS)
    got, want = hg.hash_groupby(**kw), hg.hash_groupby_plain(**kw)
    torch.cuda.synchronize()
    assert hg.FORMS[tier] - forms[tier] == 1
    ok, err = chip_smoke.same_grouped(got, want)
    assert ok, f"{tier}: max |diff| {err}"
    assert hg.in_first_row_order(got).counts.tolist() == [int(kw["mask"][:n].sum())]


def _mesh_tables(n):
    import chip_smoke

    cols, dictionary = chip_smoke.make_table(n, seed=42)
    dims = chip_smoke.make_dims(seed=43)
    full = chip_smoke.add_dims(chip_smoke.provider_of(cols, dictionary, n), dims)
    small, small_qs = chip_smoke.small_order_table(seed=47)
    full.add_table("o", small)
    return full, dict(full=full, gqs=chip_smoke.queries(cols, dictionary),
                      hqs=chip_smoke.general_queries(cols, dictionary, n),
                      oqs=chip_smoke.order_queries(cols, dictionary, n),
                      jqs=chip_smoke.join_queries(cols, dims, n),
                      mesh_oqs=chip_smoke.mesh_order_queries(cols, dictionary) + small_qs)


def test_mesh_routes_on_the_card_equal_the_cpu_mesh(cuda_device, monkeypatch):
    """chip_smoke.py phase 6's queries at 2^20 rows over 4 shards on the
    card and over 4 shards on the CPU (the plain versions): the same rows,
    equal to numpy; every mesh route ran, the card's through the kernels
    alone, a full scan ORDER BY through the sort phase 6 names for it."""
    import chip_smoke
    from eventql_tpu_torch.exec import mesh_exec
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.kernels import hash_groupby
    from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

    full, tables = _mesh_tables(1 << 20)
    meshes = {}
    for device in ("cuda", "cpu"):
        p = MeshTableProvider(n_shards=4, device=device)
        for name in ("t", "d1", "d2", "o"):
            p.add_table(name, full.get_table_data(name))
        meshes[device] = p
    rt = Runtime(device=None)
    plain = hash_groupby.hash_groupby_plain

    def no_plain_on_the_card(keys, *a, **kw):
        assert not any(k.is_cuda for k in keys), "the plain version ran on the card"
        return plain(keys, *a, **kw)

    monkeypatch.setattr(hash_groupby, "hash_groupby_plain", no_plain_on_the_card)
    before = chip_smoke.launch_counts()
    for name, sql, route, ok, _units in chip_smoke.mesh_queries(tables):
        rows = {}
        for device, p in meshes.items():
            counters = chip_smoke._mesh_counters()
            rows[device] = chip_smoke.run_query(rt, p, sql).rows
            delta = [b - a for a, b in zip(counters, chip_smoke._mesh_counters())]
            # routes 0-2 GROUP BY, JOIN, top-k; 3 the sample sort, 4 the compare-split
            want = [int(route == r) for r in range(3)] + [int(route >= 3), int(route == 3)]
            assert delta == want, (name, device)
        assert rows["cuda"] == rows["cpu"], name
        assert ok(rows["cuda"]), name
    after = chip_smoke.launch_counts()
    for kernel in ("groupby_agg", "groupby_multi_agg", "dim_join_gid", "probe_join_gid",
                   "hash_groupby"):
        assert after[kernel] > before[kernel], kernel
    assert mesh_exec.MESH_TOPK_RUNS > 0


def test_distributed_functions_on_the_card(cuda_device):
    """The kernel-tier functions at 2^20 rows over 4 shards on the card:
    equal to the same over 4 CPU shards and to numpy."""
    import chip_smoke
    from eventql_tpu_torch.parallel import distributed

    n = 1 << 20
    d = chip_smoke.multijoin_data(n, seed=5)
    want = chip_smoke._sum_count_answer(d["gid"], d["mask"], d["fv"])
    want_multi = chip_smoke._sum_count_answer(d["gid"], d["mask"] & d["active"], d["fv"])
    for device in ("cuda", "cpu"):
        mesh = distributed.make_mesh(4, device)
        dev = mesh.root
        fk1, fk2, fv, fm = distributed.shard_table(
            mesh, [d["f_k1"], d["f_k2"], d["fv"], d["mask"]])
        d1k, d1b = distributed.shard_table(mesh, [d["d1_keys"], d["d1_bucket"]])
        dk = torch.from_numpy(d["d1_keys"].view(np.int64)).to(dev)
        db = torch.from_numpy(d["d1_bucket"]).to(dev)
        got = distributed.distributed_sum_count(
            mesh, *distributed.shard_table(mesh, [d["mask"], d["gid"], d["fv"]]),
            chip_smoke.MJ_BUCKETS)
        assert [t.tolist() for t in got] == want, device
        for probe in (None, "compare", "search"):
            got = distributed.distributed_join_aggregate(
                mesh, fk1, fv, fm, dk, db, chip_smoke.MJ_BUCKETS, probe=probe)
            assert [t.tolist() for t in got] == want, (device, probe)
        got = distributed.distributed_multi_join_aggregate(
            mesh, fk1, fk2, fv, fm, d1k, d1b,
            torch.from_numpy(d["d2_keys"].view(np.int64)).to(dev),
            torch.from_numpy(d["d2_flag"]).to(dev), chip_smoke.MJ_BUCKETS)
        assert [t.tolist() for t in got] == want_multi, device


def _process_mesh_equals_the_cpu_mesh(out_dir, backend):
    """tests/test_torch_multihost.py's cases over two processes on CUDA
    shards (4 each): every output shard by shard, on both processes, and
    every exchange op's bytes, summed over the processes, equal the single
    controller's on 8 CPU shards, and numpy."""
    import test_torch_multihost as tm
    from eventql_tpu_torch.parallel import distributed

    ranks = tm.spawn_workers(out_dir, device="cuda", backend=backend)
    single = tm.run_cases(distributed.make_mesh(tm.P, "cpu"), tm.CASES)
    for case in tm.CASES:
        sharded, rep, tally = tm.assemble(ranks, case)
        s_sharded, s_rep, s_tally = single[case]
        for name, parts in s_sharded.items():
            for i in range(tm.P):
                assert np.array_equal(sharded[name][i], parts[i]), (case, name, i)
        for name, want in s_rep.items():
            for r in rep:
                assert np.array_equal(r[name], want), (case, name)
        got = {op: b for op, b in tally["bytes"].items() if op not in tm.PROCESS_OPS}
        assert got == s_tally["bytes"], case
        tm.check_numpy(case, sharded, rep[0])


def test_process_mesh_on_the_card_equals_the_cpu_mesh(cuda_device, tmp_path):
    """Both processes on this card, exchanging through gloo (NCCL refuses
    two ranks on one card)."""
    _process_mesh_equals_the_cpu_mesh(str(tmp_path), "gloo")


def test_process_mesh_over_nccl_equals_the_cpu_mesh(cuda_device, tmp_path):
    """One process a card, exchanging through NCCL (needs two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card for each of the two processes")
    _process_mesh_equals_the_cpu_mesh(str(tmp_path), "nccl")


def test_fuzz_corpora_on_the_card_equal_the_plain_versions(cuda_device):
    """chip_smoke.py phase 9: every seed of the CPU fuzz corpora under
    Runtime(device="cuda"), Runtime(device="cpu") and the host engine
    (and the group-by and order seeds over 4 shards on the card): equal
    ResultLists, the CPU tests' route floors, modulo by zero raising."""
    import chip_smoke

    out = chip_smoke.phase_fuzz(cuda_device)
    assert set(out["corpora"]) == set(chip_smoke.FUZZ_CORPORA)
    assert out["launches"]["hash_groupby"] > 0 and out["launches"]["groupby_agg"] > 0


def test_stored_table_on_the_card_equals_the_cpu_route(cuda_device, tmp_path):
    """A 2^20-row table written by the LSM table service in two commits and
    reopened: phase 4's queries under Runtime(device="cuda") give the rows
    of Runtime(device="cpu"), which equal numpy, on the same routes."""
    import chip_smoke
    from eventql_tpu_torch.db.lsm import DurableTableService
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.exec.runtime import Runtime

    n = 1 << 20
    cols, dictionary = chip_smoke.make_table(n, seed=21)
    dims = chip_smoke.make_dims(seed=22)
    chip_smoke.write_storage(str(tmp_path), chip_smoke.stored_columns(cols), dictionary, dims,
                             n, 2)
    svc = DurableTableService(str(tmp_path))
    c = dict(cols, cat=cols["cat"] - chip_smoke.CAT_LO)
    # (sql, expected rows, whether they are compared as a set)
    sqls = [(q[1], q[4], True) for q in chip_smoke.queries(c, dictionary, cat_lo=0)]
    sqls += [(sql, rows, False)
             for _name, sql, rows in chip_smoke.general_queries(c, dictionary, n, cat_lo=0)]
    sqls += [(q[1], q[4], False) for q in chip_smoke.order_queries(cols, dictionary, n)]
    sqls += [(q[1], q[3], False) for q in chip_smoke.join_queries(cols, dims, n)]
    counters = ("FUSED_GROUPBY_COUNT", "MULTI_SUM_GROUPBY_COUNT", "GENERAL_GROUPBY_COUNT",
                "SCAN_TOPK_COUNT", "SCAN_ORDER_COUNT", "JOIN_GROUPBY_COUNT")
    for sql, expected, as_set in sqls:
        rows, took = [], []
        for device in (cuda_device, "cpu"):
            before = [getattr(device_exec, k) for k in counters]
            rows.append(chip_smoke.run_query(Runtime(device=device), svc, sql).rows)
            took.append([getattr(device_exec, k) - b for k, b in zip(counters, before)])
        assert rows[0] == rows[1], sql
        assert took[0] == took[1] and sum(took[0]) == 1, (sql, took)
        assert (sorted(rows[0]) if as_set else rows[0]) == expected, sql


def test_query_cache_hit_launches_no_kernel_on_the_card(cuda_device, tmp_path):
    """A repeated GROUP BY over a CSTableScanProvider with a QueryCache:
    the miss launches the kernel once, the hit launches nothing and
    returns the same rows."""
    import chip_smoke
    from eventql_tpu_torch.columnar.cstable_v2 import write_cstable_v2
    from eventql_tpu_torch.columnar.providers import CSTableScanProvider
    from eventql_tpu_torch.exec.query_cache import QueryCache
    from eventql_tpu_torch.exec.runtime import Runtime

    n = 1 << 18
    cols, dictionary = chip_smoke.make_table(n, seed=23)
    path = str(tmp_path / "t.cst")
    write_cstable_v2(path, chip_smoke.provider_of(cols, dictionary, n).get_table_data("t"))
    provider = CSTableScanProvider("t", path)
    cache = QueryCache(str(tmp_path / "qcache"))
    rt = Runtime(device=cuda_device)
    sql = "select k, count(1), sum(v) from t where v < 800 group by k;"
    out = []
    for want in (1, 0):
        before = sum(chip_smoke.launch_counts().values())
        out.append(rt.build_query_plan(rt.new_transaction(provider, query_cache=cache),
                                       sql).execute(0).rows)
        assert sum(chip_smoke.launch_counts().values()) - before == want
    assert out[0] == out[1] and len(out[0]) == chip_smoke.N_KEYS


def test_nested_plans_take_no_route_on_the_card(cuda_device, tmp_path):
    """A scan that needs the Dremel row assembly stays on the host engine
    under Runtime(device="cuda") (the routes read the flat relation)."""
    import json

    import chip_smoke
    from eventql_tpu_torch.db.lsm import DurableTableService
    from eventql_tpu_torch.exec.runtime import Runtime

    svc = DurableTableService(str(tmp_path), arena_flush_rows=40)
    host = Runtime(device=None)
    host.build_query_plan(host.new_transaction(svc), (
        "CREATE TABLE n (id uint64, tags REPEATED string,"
        " ev REPEATED RECORD (v uint64), PRIMARY KEY (id));")).execute(0)
    for i in range(100):
        svc.insert_json("n", json.dumps({"id": i, "tags": ["a"] * (i % 3),
                                         "ev": [{"v": j} for j in range(i % 4)]}))
    for sql in ("select count(ev.v), sum(ev.v) from n;",
                "select id % 5, count(ev.v) from n group by id % 5 order by 1;",
                "select ev.v from n order by ev.v desc limit 7;"):
        before = sum(chip_smoke.launch_counts().values())
        got = chip_smoke.run_query(Runtime(device=cuda_device), svc, sql).rows
        assert sum(chip_smoke.launch_counts().values()) == before, sql
        assert got == chip_smoke.run_query(host, svc, sql).rows, sql


def _serving_setup(n, seed):
    import chip_smoke

    cols, dictionary = chip_smoke.make_table(n, seed=seed)
    dims = chip_smoke.make_dims(seed=seed + 1)
    tables = dict(cols=cols, dictionary=dictionary, dims=dims,
                  oqs=chip_smoke.order_queries(cols, dictionary, n),
                  jqs=chip_smoke.join_queries(cols, dims, n))
    qs = chip_smoke.serving_queries(tables, dict(cols, cat=cols["cat"] - chip_smoke.CAT_LO), n)
    return tables, chip_smoke.stored_columns(cols), qs


def test_native_server_on_the_card_equals_the_cpu_server(cuda_device):
    """A NativeTCPServer(device="cuda") over a 2^20-row table answers the
    headline GROUP BY, G1, a top-k and a join as the same server on
    device="cpu" does, both equal to numpy; the card's routes served it."""
    import chip_smoke
    from eventql_tpu_torch.server.native_tcp import NativeTCPServer

    n = 1 << 20
    tables, stored, qs = _serving_setup(n, seed=31)
    svc = chip_smoke.serving_service(stored, tables["dictionary"], tables["dims"], 0, n)
    answers = {}
    for device in ("cuda", "cpu"):
        server = NativeTCPServer(svc, port=0, device=device).start()
        try:
            client = chip_smoke.native_client(server.port)
            before = chip_smoke.launch_counts()
            for name in ("headline", "G1_min_max_mean", "topk_ts_desc", "join_small_dim"):
                _path, sql, expected, as_set, _counter = qs[name]
                rows, _nbytes = chip_smoke.native_sql(client, sql)
                assert chip_smoke._same(rows, expected, as_set), (device, name)
                answers.setdefault(name, []).append(rows)
            launched = {k: v - before[k] for k, v in chip_smoke.launch_counts().items()}
            client.close()
        finally:
            server.stop()
        if device == "cuda":
            assert all(launched[k] > 0 for k in ("groupby_agg", "hash_groupby",
                                                 "dim_join_gid")), launched
    assert all(a[0] == a[1] for a in answers.values())


@pytest.mark.parametrize("mesh_shards", [2, None])
def test_two_worker_cluster_on_the_card_equals_the_in_process_route(cuda_device, mesh_shards):
    """Two workers on the card (with mesh_shards=2, and without: a mesh of
    one shard), each half of a 2^20-row table, behind a coordinator: the
    headline GROUP BY, G1, G5 and a top-k equal Runtime(device="cuda")
    over the whole table, the workers' partial aggregates and top-k on
    their meshes, launching the card's kernels."""
    import chip_smoke
    from eventql_tpu_torch.exec import mesh_exec
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.parallel.cluster import ClusterTableProvider
    from eventql_tpu_torch.server.native_tcp import NativeTCPServer

    n = 1 << 20
    tables, stored, qs = _serving_setup(n, seed=33)
    whole = chip_smoke.serving_service(stored, tables["dictionary"], tables["dims"], 0, n)
    workers = [NativeTCPServer(
        chip_smoke.serving_service(stored, tables["dictionary"], tables["dims"],
                                   i * n // 2, (i + 1) * n // 2, (i, 2)),
        port=0, device="cuda", mesh_shards=mesh_shards).start() for i in range(2)]
    try:
        provider = ClusterTableProvider([("127.0.0.1", w.port) for w in workers])
        rt = Runtime(device="cuda")
        for name in ("headline", "G1_min_max_mean", "G5_float_sums", "topk_ts_desc"):
            path, sql, expected, _as_set, _counter = qs[name]
            before = mesh_exec.MESH_GROUPBY_RUNS + mesh_exec.MESH_TOPK_RUNS
            launches = chip_smoke.launch_counts()
            got = chip_smoke.run_query(rt, provider, sql).rows
            assert mesh_exec.MESH_GROUPBY_RUNS + mesh_exec.MESH_TOPK_RUNS == before + 2, name
            launched = {k: v - launches[k] for k, v in chip_smoke.launch_counts().items()}
            if path != "order_by":  # the workers' partials: H1 on each mesh
                assert launched["hash_groupby"] > 0, (name, launched)
            want = chip_smoke.run_query(rt, whole, sql).rows
            if path == "order_by":
                assert got == want == expected, name
            else:
                assert sorted(got) == sorted(want) == sorted(expected), name
    finally:
        for w in workers:
            w.stop()


_CONCURRENT_FIRST = r"""
import sys, threading
sys.path.insert(0, ".")
import chip_smoke
from eventql_tpu_torch.server.native_tcp import NativeTCPServer

n = 1 << 22  # a top-k takes the histograms and the extraction from here on
cols, dictionary = chip_smoke.make_table(n, seed=35)
dims = chip_smoke.make_dims(seed=36)
tables = dict(cols=cols, dictionary=dictionary, dims=dims,
              oqs=chip_smoke.order_queries(cols, dictionary, n),
              jqs=chip_smoke.join_queries(cols, dims, n))
qs = chip_smoke.serving_queries(tables, dict(cols, cat=cols["cat"] - chip_smoke.CAT_LO), n)
svc = chip_smoke.serving_service(chip_smoke.stored_columns(cols), dictionary, dims, 0, n)
server = NativeTCPServer(svc, port=0, device="cuda").start()
names = ["headline", "G1_min_max_mean", "topk_ts_desc", "join_small_dim", "join_big_dim",
         "multi_sum", "G4_count_distinct", "order_ts_where"]
errors = []
start = threading.Barrier(8)

def client(i):
    try:
        c = chip_smoke.native_client(server.port)
        start.wait(timeout=120)
        for j in range(len(names)):
            name = names[(i + j) % len(names)]
            _path, sql, expected, as_set, _counter = qs[name]
            if not chip_smoke._same(chip_smoke.native_sql(c, sql)[0], expected, as_set):
                errors.append((i, name))
        c.close()
    except Exception as e:
        errors.append((i, repr(e)))

threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=600)
server.stop()
assert not any(t.is_alive() for t in threads) and not errors, errors
launched = chip_smoke.launch_counts()
assert all(launched[k] > 0 for k in launched), launched
print("CONCURRENT-FIRST-OK")
"""


def test_concurrent_first_queries_on_the_card(cuda_device):
    """A fresh process: eight clients send their first queries at once to
    a server on the card, before any kernel library is loaded or any
    column uploaded (the build lock, the libraries' first setup, the
    column cache and the counters all raced): every answer equals numpy,
    and every kernel was launched."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _CONCURRENT_FIRST], cwd=repo,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "CONCURRENT-FIRST-OK" in out.stdout


def test_draw_over_the_general_route_on_the_card_equals_the_cpu_route(cuda_device):
    """phase 11's charts at 2^22 rows: each SVG under device "cuda" equals
    the one under device "cpu" (the plain versions), and the AREACHART's
    sub-query launches the hash aggregate."""
    import chip_smoke
    from eventql_tpu_torch.exec.runtime import Runtime

    n = 1 << 22
    cols, dictionary = chip_smoke.make_table(n, seed=9)
    provider = chip_smoke.provider_of(cols, dictionary, n)
    for name, (_kernels, _bare, _counter, sql) in chip_smoke.CHARTS.items():
        want = chip_smoke.render(Runtime(device="cpu"), provider, sql)
        chip_smoke.zero_launch_counts()
        assert chip_smoke.render(Runtime(device=cuda_device), provider, sql) == want, name
        if name == "area_ydomain_g1":
            assert chip_smoke.launch_counts()["hash_groupby"] == 1


def test_evqlbench_on_the_card_equals_the_cpu(cuda_device, capsys):
    """evqlbench's default query over its synthetic 2^20-row table: the same
    output but for the times under --device cuda and --device cpu; on the
    card the warm-up and both rounds take the GROUP BY route and launch
    groupby_agg."""
    import chip_smoke
    from eventql_tpu_torch.cli import evqlbench
    from eventql_tpu_torch.exec import device_exec

    lines = {}
    for device in ("cuda", "cpu"):
        chip_smoke.zero_launch_counts()
        before = device_exec.FUSED_GROUPBY_COUNT
        assert evqlbench.main(["--device", device, "--rows", str(1 << 20), "-n", "2"]) == 0
        out = capsys.readouterr().out
        lines[device] = [l for l in out.splitlines() if l.startswith(("query:", "result rows:"))]
        assert device_exec.FUSED_GROUPBY_COUNT - before == 3
        if device == "cuda":
            assert chip_smoke.launch_counts()["groupby_agg"] == 3
    assert lines["cuda"] == lines["cpu"] and lines["cuda"][1] == "result rows: 1024"


def test_embedded_server_on_the_card(cuda_device):
    """The port's C host boots the embedded server with server.device=cuda
    (its default) and runs DDL, DML and a query; the server library loaded
    into this process serves a GROUP BY through the C client on the card."""
    import ctypes
    import subprocess
    import threading

    from eventql_tpu_torch.client.cclient import CClient
    from eventql_tpu_torch.exec import device_exec
    from eventql_tpu_torch.exec.relation import Column, Relation
    from eventql_tpu_torch.exec.runtime import Runtime
    from eventql_tpu_torch.core.types import SType
    from eventql_tpu_torch.native import _build

    for conf in ([], ["server.device=cuda"]):
        out = subprocess.run([_build.path(_build.SMOKE_BIN), *conf], capture_output=True,
                             text=True, timeout=300, env=_build.host_env())
        assert out.returncode == 0 and "embedded server smoke OK" in out.stdout, out.stderr

    import chip_smoke

    lib, clib = chip_smoke._server_lib()
    conf = clib.evql_conf_init()
    for key, value in ((b"server.listen", b"127.0.0.1:0"), (b"server.device", b"cuda")):
        assert clib.evql_conf_set(conf, key, value) == 0
    server = lib.evql_server_init(conf)
    kill_r, kill_w = os.pipe()
    try:
        assert lib.evql_server_start(server) == 0, lib.evql_server_geterror(server)
        embedded = ctypes.cast(server, ctypes.POINTER(ctypes.py_object))[0]
        n = 1 << 20
        rng = np.random.default_rng(2)
        k, v = rng.integers(0, 1024, n).astype(np.uint64), rng.integers(0, 1000, n).astype(np.uint64)
        svc = embedded.table_service
        rt = Runtime(device="cpu")
        rt.build_query_plan(rt.new_transaction(svc), "CREATE TABLE t (k uint64, v uint64);").execute(0)
        svc.tables["t"].insert_batch(Relation(["k", "v"], [
            Column(SType.UINT64, k, np.ones(n, bool)), Column(SType.UINT64, v, np.ones(n, bool))], n))
        listener = threading.Thread(target=lib.evql_server_listen, args=(server, kill_r), daemon=True)
        listener.start()
        for _ in range(1000):
            if embedded.listener is not None:
                break
            threading.Event().wait(0.01)
        before = device_exec.FUSED_GROUPBY_COUNT
        c = CClient("127.0.0.1", embedded.listener.port)
        ((_cols, rows),) = c.query("select k, sum(v), count(1) from t where v < 800 group by k;")
        c.close()
        assert device_exec.FUSED_GROUPBY_COUNT == before + 1
        keep = v < 800
        assert sorted(rows) == sorted(
            [str(g), str(int(v[keep & (k == g)].sum())), str(int((keep & (k == g)).sum()))]
            for g in np.unique(k[keep]))
        os.write(kill_w, b"x")
        listener.join(timeout=60)
    finally:
        lib.evql_server_shutdown(server)
        lib.evql_server_free(server)
        clib.evql_conf_free(conf)
        os.close(kill_r)
        os.close(kill_w)


# -- the expression program (kernels/csrc/expr_program.cu) ------------------------


def _words(t):
    """A result plane as comparable words: floats by their bits, every NaN
    as one word; integers and bools as they are."""
    if t.dtype != torch.float64:
        return t
    w = t.view(torch.int64).clone()
    w[torch.isnan(t)] = 0x7FF8000000000000
    return w


def _same_on_card(got, want, n, what):
    assert got.stype == want.stype and got.data.dtype == want.data.dtype, what
    g, w = got.full(n), want.full(n)
    assert g.data.shape == w.data.shape == (n,), what
    assert torch.equal(_words(g.data), _words(w.data)), what
    assert torch.equal(g.valid, w.valid), what


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, (1 << 26) + 3])
def test_expr_program_equals_the_torch_path_on_the_card(cuda_device, n):
    """Every snippet of the corpus (tests/test_torch_expr_program.py: every
    stored width, u64 values and literals above 2^63, NULL-bearing columns
    under isnull / if, NaN and -0.0) as one kernel launch against the
    PyTorch path, bit for bit, at one row, at a block's edge and past it,
    and at 2^26 + 3 rows; the fallbacks launch nothing."""
    from test_torch_expr_program import EXTRA, FALLBACK, SNIPPETS, corpus_relation, planned, \
        provider_of
    from eventql_tpu_torch.exec import torch_expr

    provider = provider_of(t=corpus_relation(n, seed=n % 997))
    for snippet in SNIPPETS + EXTRA:
        _scan, expr, cols = planned(snippet, provider, cuda_device)
        before = torch_expr.PROGRAM_LAUNCHES
        got = torch_expr.compile_expr(expr, cols, n, cuda_device)
        launched = torch_expr.PROGRAM_LAUNCHES - before
        want = torch_expr.compile_torch(expr, cols, n, cuda_device)
        _same_on_card(got, want, n, snippet)
        # the data decides what is a stored column as it is (n = 1 narrows u)
        prog = torch_expr.program_for(expr, cols)
        assert (prog is None) == (snippet in FALLBACK), snippet
        assert launched == int(prog is not None and prog.identity is None), snippet
        del got, want
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_expr_program_on_sliced_streams_on_the_card(cuda_device, offset):
    """The corpus over streams that start ``offset`` elements into their
    allocation (data) and ``offset + 1`` (validity): off every 16-byte
    boundary, so the kernel reads them with scalar loads."""
    from test_torch_expr_program import EXTRA, SNIPPETS, corpus_relation, planned, provider_of
    from eventql_tpu_torch.exec import torch_expr

    def off(t, k):
        big = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        big[k:] = t
        return big[k:]

    n = 100_003
    provider = provider_of(t=corpus_relation(n, seed=offset))
    for snippet in SNIPPETS + EXTRA:
        _scan, expr, cols = planned(snippet, provider, cuda_device)
        prog = torch_expr.program_for(expr, cols)
        if prog is None or prog.identity is not None:
            continue
        sliced = [torch_expr.DeviceCol(c.stype, off(c.data, offset), off(c.valid, offset + 1))
                  for c in cols]
        before = torch_expr.PROGRAM_LAUNCHES
        got = torch_expr.compile_expr(expr, sliced, n, cuda_device)
        assert torch_expr.PROGRAM_LAUNCHES == before + 1, snippet
        _same_on_card(got, torch_expr.compile_torch(expr, cols, n, cuda_device), n, snippet)


def test_q1_on_the_card_runs_one_program_an_expression(cuda_device, monkeypatch, tmp_path):
    """TPC-H Q1 (gpubench/traffic/tpch_q1.json) through Runtime(device=
    "cuda") at 2^20 rows, profiled after a first run: its six expressions
    (the WHERE, two products, three means) run as six launches of the
    program kernel, the only kernels launched inside the routes' expr
    calls (no PyTorch elementwise kernel), no fallback; rows equal to the
    host engine's."""
    import json

    from test_torch_expr_program import BENCH_QUERIES, lineitem_relation, provider_of
    from eventql_tpu_torch.exec import device_exec, torch_expr
    from eventql_tpu_torch.exec.runtime import Runtime

    name, sql, _table, launches = BENCH_QUERIES[0]
    assert name == "tpch_q1" and launches == 6
    provider = provider_of(lineitem=lineitem_relation(1 << 20))

    def run(rt):
        return rt.build_query_plan(rt.new_transaction(provider), sql).execute(0).rows

    rt = Runtime(device=cuda_device)
    want = run(Runtime(device=None))
    assert run(rt) == want  # uploads the columns and builds the programs
    expr = device_exec._expr

    def annotated(role, e, columns, n, device):
        with torch.profiler.record_function("expr-call"):
            return expr(role, e, columns, n, device)

    monkeypatch.setattr(device_exec, "_expr", annotated)
    before = (torch_expr.PROGRAM_LAUNCHES, torch_expr.PROGRAM_FALLBACKS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = run(rt)
        torch.cuda.synchronize()
    assert got == want
    assert (torch_expr.PROGRAM_LAUNCHES - before[0],
            torch_expr.PROGRAM_FALLBACKS - before[1]) == (6, 0)
    path = tmp_path / "q1.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "expr-call"]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat", "").startswith("cuda_")
                   and "correlation" in e.get("args", {})}
    inside = [e["name"] for e in events if e.get("cat") == "kernel"
              and any(a <= launched_at.get(e["args"].get("correlation"), -1) <= b
                      for a, b in calls)]
    assert len(calls) == 6
    assert len(inside) == 6 and all("expr_program_kernel" in k for k in inside), inside


def test_routes_take_the_program_on_the_card(cuda_device):
    """The top-k, ORDER BY, join, general GROUP BY and mesh routes
    (tests/test_torch_expr_program.py's ROUTE_QUERIES, the mesh over 4
    shards on the card) launch the program for their expressions, with
    no fallback, and answer as the host engine does."""
    from test_torch_expr_program import ROUTE_QUERIES, route_provider, run_route_query
    from eventql_tpu_torch.exec import device_exec, mesh_exec, torch_expr

    for name, sql, counter, module, launches in ROUTE_QUERIES:
        mod = {"device_exec": device_exec, "mesh_exec": mesh_exec}[module]
        mesh = module == "mesh_exec"
        provider = route_provider(n=200_003, mesh_shards=4 if mesh else None,
                                  mesh_device="cuda")
        before, routed = (torch_expr.PROGRAM_LAUNCHES, torch_expr.PROGRAM_FALLBACKS), \
            getattr(mod, counter)
        got = run_route_query(provider, sql, None if mesh else cuda_device)
        assert getattr(mod, counter) == routed + 1, name
        assert (torch_expr.PROGRAM_LAUNCHES - before[0],
                torch_expr.PROGRAM_FALLBACKS - before[1]) == (launches, 0), name
        assert got == run_route_query(route_provider(n=200_003), sql, None), name


def test_expr_program_probe_on_the_card(cuda_device):
    """The probe of the kernel alone at 2^20 rows: each case equal to the
    PyTorch path and timed."""
    from eventql_tpu_torch.scripts import probe_expr_program

    res = probe_expr_program.main(["--n", str(1 << 20)])
    assert all(c["ms"] > 0 and c["ops"] > 0 for c in res["cases"].values())
