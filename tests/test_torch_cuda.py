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
    for name in chip_smoke.GENERAL_SQL:
        assert per_query[name] == {"hash_groupby": 1}
        # a direct tier: the slots come back in one copy
        assert run["e2e"][name]["tier"] == chip_smoke.GENERAL_TIERS[name]
        assert run["e2e"][name]["readbacks"] == 1
    assert per_query[chip_smoke.J1[0]] == {"dim_join_gid": 1, "hash_groupby": 1}
    assert run["launches_by_path"]["general_group_by"]["hash_groupby"] == 5 * 2
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
