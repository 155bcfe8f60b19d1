"""Probes of the card: the counterparts of the repository's
``scripts/probe_radix.py``, ``probe_groupby_i8.py`` and
``probe_int8_ops.py``, run as ``python3 -m eventql_tpu_torch.scripts.<name>``.

Each runs on the card (``--device cuda``, the default; it raises without
one) and prints every time beside its bound and the card's name and power
limit. ``--device cpu`` runs the same steps and checks through the plain
versions and prints no time ("not measured"). The helpers below are
theirs.
"""

from __future__ import annotations

import subprocess

import torch

# the published peak of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12


def device_of(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to rehearse)")
    return device


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu (no card: times not measured)"
    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2, device: torch.device | None = None):
    """Milliseconds a call of ``fn`` takes on the card (CUDA events around
    ``iters`` calls after ``warmup``); on a CPU ``device`` ``fn`` runs once
    and the time is None (not measured)."""
    if device is not None and device.type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float) -> float:
    """The least time for ``nbytes`` of device memory traffic, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"
