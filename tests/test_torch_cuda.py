"""The port's CUDA kernels on a real card.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q

Everywhere else these tests skip (the decision is made inside the
fixture, at run time). They drive the same cases as chip_smoke.py's
phases 3, 4 and 5 at a small size: every kernel wrapper against its plain
PyTorch version on CUDA tensors, and the SQL routes on the card (GROUP BY
sum/count, ORDER BY, ORDER BY ... LIMIT) against numpy and the port's
host engine. Tolerance: exact equality.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.cuda


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
    assert set(after) == {"groupby_agg", "groupby_multi_agg", "extract_ge"}
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
    # each recorded call, repeated: kernel and plain version agree
    times = chip_smoke.phase_times(cuda_device, run["calls"])
    assert set(times) == {"groupby_agg", "groupby_multi_agg", "extract_ge"}
    assert all(t["max_abs_err"] == 0 for t in times.values())


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
