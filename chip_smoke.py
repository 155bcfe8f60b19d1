#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (eventql_tpu_torch) on one GPU.

    python3 chip_smoke.py     # needs one CUDA device and nvcc; no arguments

Phases (any mismatch or exception ends the run with a non-zero code):
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from eventql_tpu_torch/kernels/csrc;
  3. kernels: every kernel wrapper against its plain PyTorch version on
     the card, exact equality (integer sums and row indices: tolerance 0;
     the hash aggregate's groups in first-row order, its floats multiples
     of 1/64, so that every sum is exact in any order), the hash
     aggregate in each of its tiers (shared, direct global, hash) and
     count_distinct forms (shared bitmap, global bitmap, set) at their
     edges (u32 keys of 2^31 and more, a NULL key outside the stats, a
     negative base, one hot key, streams off a 16-byte boundary), and its
     tier rule against the launcher's at the boundaries; the probe
     kernels place_runs (runs of 256 and 4096 elements covering 2^24 u32
     words, fewer runs than slots into a given ``out``, R not a multiple
     of the run, runs leaving the array, a source off a 16-byte boundary)
     and int8_form (each form at (8, 128) and 2^24 elements around +-128,
     2^24 + 3 off a 16-byte boundary, and 1, 3, 4, 5 and one block's
     elements and one either side, on and off the boundary) against their
     plain versions, tolerance 0; extract_ge's cases (the look-back's
     too: matches only in the last tile, the cap reached in the first,
     one match a tile, n either side of a tile) also on values 1-3
     elements off a 16-byte boundary; then the probes' own path, the
     entry points of the port's probes (eventql_tpu_torch/scripts:
     probe_radix's run placement at 2^25 words, probe_int8_ops at 2^24
     elements), launch counts set to 0 just before and read just after,
     each result checked and timed there, each int8 form then timed in
     turns with its library call;
  4. main paths: SQL text -> Runtime(device="cuda") -> ResultList on a
     partition-sized table (2^26 rows, ~2.8 GB on the device): first the
     GROUP BY sum/count queries, then the general GROUP BY queries G1-G7
     (min / max / mean, a key beyond K_CAP, two keys, count_distinct,
     float sums, a WHERE that leaves under 1 % of a 2^20-slot key's slots
     occupied in the direct global tier and the same groups in the hash
     tier: the hash aggregate, each in the tier its key spans choose, with
     its peak device memory, its groups compacted on the card, and the
     copies and bytes a run reads back), then
     the ORDER BY [LIMIT] queries, then the fact-dim JOIN + GROUP BY
     queries (dimension tables of 1024 and 2^18 rows; J1 with min / max
     through the join route's general branch), each path with the launch
     counts set to 0 just before it and read just after. Every query's
     rows equal an independent numpy answer and, on a 2^20-row prefix,
     the port's own host engine (G6 and G7 also their route's plain
     version, Runtime(device="cpu")); route and launch counters rose as
     they must; the expression program's counters
     (torch_expr.PROGRAM_LAUNCHES / PROGRAM_FALLBACKS) likewise set to 0
     before each path and read after it;
  4b. the expression program (kernels/csrc/expr_program.cu): every query
     of phase 4 once more with each expression the routes evaluate held
     bit for bit against the PyTorch path (torch_expr.compile_torch) on
     the same tensors, the launch or fallback the rule predicts against
     the counters, and phase 4's counts against its runs times these;
     then TPC-H Q1 and Q6 as the benchmark sends them over a 2^26-row
     LINEITEM (its columns stored as u16 / u32): six and two launches a
     query, no fallback, each expression equal to the PyTorch path and
     the rows equal to the plain version's; then the kernel alone at 2^26
     rows (python3 -m eventql_tpu_torch.scripts.probe_expr_program) for
     its row of the {"kernels": [...]} line;
  5. the main paths' shapes: every kernel call the queries of phase 4
     made is repeated on the same tensors through the wrapper and the
     plain version, which must be equal (tolerance 0); then CUDA-event
     times of both beside the bound and a library call (for the hash
     aggregate the chain torch.unique + scatter_reduce_, the same call in
     the hash tier with the spans withheld, its slots + count + first row
     alone, the bytes it allocates; and its G1 call with every row on one
     key, in both tiers), and the warm
     end-to-end time per query; the big-table join probe also against
     dimension tables of 16384 and 2^22 rows, and its table build alone;
     the small-table probe also at D = 8192 and D = 1024 with u64 keys
     (beside the big-table probe and its global table's build at D =
     8192), its kernel's device time at one row (its table build), and
     the library calls beside B1's other shapes;
  6. mesh paths: phase 4's table over MeshTableProvider(n_shards=4,
     device="cuda"), four shards of 2^24 rows on the one card (several
     shards on one device are the port's counterpart of the JAX package's
     virtual CPU mesh; they run one after another, so the times measure
     the tier's cost, not its scaling): phase 4's GROUP BY, general GROUP
     BY, JOIN + GROUP BY, top-k and full ORDER BY queries, and three more
     full ORDER BYs (three keys packed into one u64: the sample sort; an
     unbounded second key: the compare-split; on a table of 2^18 rows of
     its own, a bucket that overflows and a passing key equal to the
     sentinel: the compare-split after the sample sort gave up), each
     equal to a numpy answer (tolerance 0), its mesh route counter rising
     once a run (a full ORDER BY's also naming its sort), its exchange at
     most 64 bytes a group (or distinct pair, or top-k candidate) and
     shard, or 128 bytes a row for a full ORDER BY; at bench.py
     multijoin's shape (2^26 fact rows, 1024 and 256 dimension rows, 1024
     buckets) distributed_sum_count, distributed_join_aggregate,
     distributed_multi_join_aggregate, distributed_sort,
     distributed_order_permutation, distributed_bucket_sort,
     distributed_topk, distributed_grouped_aggregate,
     distributed_count_distinct and distributed_grouped_aggregate_sharded
     equal to numpy, with their exchange bytes by op; each kernel's first
     call on the mesh path held against its plain version; e2e ms of each
     query (CUDA events, median of 3) beside the single-card route's, and
     the exchange bytes;
  7. process mesh: phase 6's kernel-tier functions on the same 4 shards,
     driven by two fresh interpreters of this script (parallel/multihost.py,
     two shards a process) sharing the card over gloo (NCCL refuses two
     ranks on one card; with two cards or more NCCL runs too, a card a
     process): every result equal to numpy on every process (tolerance
     0), every call's exchange bytes by op, summed over the processes,
     equal to phase 6's, each kernel's first call on the process mesh
     held against its plain version; times (host clock between barriers,
     median of 3) beside phase 6's, bytes across processes and host
     staging time. A worker that fails or outlives its timeout is killed
     and the script fails;
  8. storage: phase 4's table plus an ``id`` UINT64 primary key, written
     through the LSM table service (db/lsm.py) as STORAGE_COMMITS commits
     of cstable v0.2 segments with its two dimension tables, read back by a
     new service on the same directory (a restart), then: the streaming
     cursor (rows equal to execute and numpy, one segment alive at a time),
     phase 4's GROUP BY, general GROUP BY, ORDER BY [LIMIT] and JOIN + GROUP
     BY queries under Runtime(device="cuda") equal to numpy (tolerance 0),
     every route counter rising once a run, each path's launch counts set
     to 0 just before it and read just after (each kernel's first call on
     the path held against its plain version); compact(), after which the
     headline GROUP BY gives the same rows and uploads its columns once; a
     QueryCache over a CSTableScanProvider on a segment: the second GROUP
     BY a hit that launches nothing; times of the writes, the reopen, each
     query's first run (its upload) and warm runs (CUDA events, median of
     STORAGE_WARM);
  9. fuzz corpora: the seeds of the port's CPU fuzz tests (GROUP BY 60 +
     50, ORDER BY 30 + 25, JOIN 20 + 20; tables of 0-20 000 rows with NULL
     masks, u64 values of 2^63 and more, 1-4099 keys) under
     Runtime(device="cuda"), Runtime(device="cpu") and the host engine,
     the group-by and order seeds also over MeshTableProvider(n_shards=4,
     device="cuda"): every ResultList equal (tolerance 0), the CPU tests'
     floors on the route counters met; integer modulo by zero raises on
     each.
 10. serving: phase 4's table (``cat`` stored shifted, as in phase 8) in an
     in-memory TableService behind EventQLServer + NativeTCPServer on one
     sniffed port (server/listener.py), every route on the card: phase 4's
     queries over the native protocol, the headline, G1, a top-k and J1
     also over HTTP, each answer equal to numpy (tolerance 0), its route
     counter rising once a run, each path's launch counts set to 0 just
     before it and read just after; warm ms per query and protocol (host
     clock, median of 3) beside phase 4's in-process time, and the answer's
     bytes on the wire; 8 clients at once (native and HTTP), 3 rounds, every
     answer exact; then a coordinator EventQLServer over ClusterTableProvider
     of two NativeTCPServers (mesh_shards=2, half of the table each: phase
     6's four shards) through HTTP: GROUP BYs whose partials the workers
     aggregate on their meshes (at most 64 bytes a group and worker beyond
     the query's fixed envelope) and a top-k pushed to them, each equal to
     numpy, the workers' mesh counters rising; and a JOIN the fan-out
     refuses over two workers of 2^20 rows of its own, made without
     mesh_shards, which the coordinator's join route serves from the pulled
     rows; then the headline and G1 over those two workers, whose partials
     run on a mesh of one shard of the card. Each kernel's
     first call on the serving and on the cluster paths is held against
     its plain version.
 11. charts and the cluster tier: (a) four DRAW statements over phase 4's
     table under Runtime(device="cuda") (a BARCHART over the headline GROUP
     BY, a LINECHART with LEGEND over an ORDER BY ... LIMIT, an AREACHART
     with YDOMAIN over G1's grouping, a POINTCHART with GRID), each SVG byte
     for byte the one the port's host engine renders for the same statement,
     its route counter rising once a run, each chart's launch counts zeroed
     just before it and read just after, each kernel's first call held
     against its plain version; warm ms (host clock, median of 3) beside
     phase 4's time for the bare query. (b) a cluster as its users deploy
     it: the port's ZooKeeper server as its CLI (``python -m
     eventql_tpu_torch.cli.zkserver``) in a process, replication
     factor 2, three ``python -m eventql_tpu_torch.cli.evqld --zookeeper_addr
     ... --server_name nodeN --device cuda --datadir ...
     --partition_split_threshold_rows T`` processes; a table of phase 4's
     columns plus a UINT64 primary key ``id`` created over HTTP; rows
     inserted through node1's HTTP insert API (routed by partition, written
     to every replica, majority acknowledgement), CLUSTER_TIER_ROWS of them
     unless the routed rate would take more than CLUSTER_TIER_INSERT_S
     (the cut is on the printed line); the leader's autosplit splits the
     partition (DESCRIBE PARTITIONS shows more partitions than at
     creation); within a deadline every replica the metadata names holds,
     in its partition's keyrange, exactly numpy's rows; the headline GROUP
     BY, G1, a top-k, count(*) and a DRAW through node1 and node2 equal to
     numpy (tolerance 0); ``evqlctl cluster-list`` and ``cluster-status``
     show the three up, and a JavaScript MapReduce job (the headline's sum
     and count per key) through DistributedMapReduceScheduler, its map
     shards on the partitions' replicas, equals numpy; then the node a
     query of the last partition
     reads first is SIGKILLed (node3 when the splits placed a partition on
     it first, else node1 or node2: killing a node that serves no
     partition first would test no failover): the registry and CLUSTER
     SHOW SERVERS report it down, and the same queries stay exact through
     a live node (failover to the other replica), with no failed shard on
     an in-process coordinator; evqlctl shows it down, and the MapReduce
     job, its shards failing over to the other replica, equals numpy again.
     The partition plans are keyrange-scoped, which every device route
     declines, so the nodes answer them on their host engines. Every node
     process and the ZooKeeper process are killed on every exit path.
 12. the tools on the card: (a) ``evqlbench.main(["--device", "cuda",
     "--rows", 2^26, "-n", "5"])`` in this process (its synthetic table,
     its default query the headline GROUP BY: the route counter up 6 and
     B1 launched 6 times), its answer over the table rebuilt from the
     tool's seed equal to numpy, then ``-t t=<file>.cst`` over a 2^22-row
     cstable file the port's writer made, with the route that served it
     (the keyless ``count(1)``: the general route, H1 launched twice with
     no stream but the device);
     then phase 4's 2^26 rows in an in-memory TableService behind one port
     on the card (as phase 10's) for (b) evqlslap (4 threads, unthrottled,
     TOOLS_SLAP_S s each) on the headline (B1), topk_ts_desc (B1 + B3) and
     G1 (H1): no error, the route counter up once a request, each answer
     once more equal to numpy; then insert mode, count(*) equal to the
     inserts made; (c) the C client (client/cclient.py): the headline, and
     k_100000 in pages of TOOLS_ROWBUFLEN rows, equal to numpy; (d) the
     port's libevql_server.so in this process (server.device=cuda, its
     table service handed the table): the headline through the C client
     equal to numpy, B1 launched; its C host program with
     server.device=cuda as a process: "embedded server smoke OK"; (e) a
     mysqldump of TOOLS_IMPORT_ROWS rows (an ``id`` key, k, v, w, ts)
     imported by mysql2evql: the headline and G1 over it equal to numpy;
     (g) a JavaScript MapReduce job over TOOLS_MR_ROWS rows through POST
     /api/v1/mapreduce/execute: its pairs equal to numpy. Each step's
     route counters and launch counts are read just before and just after
     it; each kernel's first call in the phase is held against its plain
     version. (e) also checks the top-k over the imported ``ts`` (u64
     values above 2^53, ROADMAP C15). Phase 8 logs the storage codec's
     library (built from native/*.cc) and fails if it is not loaded.

With EVQL_PARENT_TREE naming an earlier tree of the repository (``git
archive HEAD~1`` unpacked into an ignored directory), phase 2 imports
that tree's kernel modules extract, join and probes apart from these and
builds its kernels; each is then called through its own wrapper on the
same inputs as this tree's and must agree with it: B4's small-table
probe in phase 5 is timed beside this one, and every timed extract_ge
call (phases 5, 6, 8, 10-12) and each int8 form of phase 3 in turns
with it (earlier, this, this, earlier).

Prints a JSON line {"mesh": ...}, one {"multihost": ...}, one {"storage": ...}, one
{"fuzz": ...}, one {"serving": ...}, one {"cluster": ...} (the card's name and power
limit, phase 11's charts and their launches, and the cluster tier: nodes, rows
inserted and any cut, routed inserts a second, partitions at creation and after
the splits and their placements, the replica pairs read back, the node killed,
ms per query before and after the kill, seconds to the nodes' start, the first
split, the read-back, "down" and the first exact answer after the kill), one
{"tools": ...} (the card's name and power limit, each step's numbers, its launches
and route counters, and phase 11's evqlctl and MapReduce), one {"kernels": [...]}
and, as the last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import ctypes
import importlib
import inspect
import io
import json
import os
import random
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
import weakref

import numpy as np
import torch

from eventql_tpu_torch.cli import evqlbench, evqlctl, evqlslap, mysql2evql
from eventql_tpu_torch.client import cclient
from eventql_tpu_torch.columnar import cstable_writer, native
from eventql_tpu_torch.columnar.providers import CSTableScanProvider
from eventql_tpu_torch.config.config_directory import SERVER_DOWN, SERVER_UP, ConfigDirectory
from eventql_tpu_torch.config.config_directory_zookeeper import reset_sessions
from eventql_tpu_torch.core.errors import RuntimeError_, SQLError
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.db.lsm import DurableTableService
from eventql_tpu_torch.db.metadata import TableMetadata
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import device_exec, mesh_exec, torch_expr
from eventql_tpu_torch.exec.query_cache import QueryCache
from eventql_tpu_torch.exec.relation import Column, Relation, dtype_for, relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    PlanCache,
    RelationTableProvider,
    Runtime,
)
from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.kernels import extract as ex
from eventql_tpu_torch.kernels import groupby_agg as ga
from eventql_tpu_torch.kernels import hash_groupby as hg
from eventql_tpu_torch.kernels import join as kj
from eventql_tpu_torch.kernels import probes as kp
from eventql_tpu_torch.kernels import sort as ksort
from eventql_tpu_torch.mapreduce.distributed import DistributedMapReduceScheduler
from eventql_tpu_torch.native import _build as native_build
from eventql_tpu_torch.parallel import cluster, distributed, multihost
from eventql_tpu_torch.parallel.cluster import (
    ClusterTableProvider,
    cluster_provider_from_config,
    relation_from_bytes,
)
from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.coder import encode_plan
from eventql_tpu_torch.plan.exprs import ColumnReferenceNode
from eventql_tpu_torch.scripts import (HBM_BYTES_PER_S, cuda_ms, probe_expr_program,
                                       probe_int8_ops, probe_radix)
from eventql_tpu_torch.server.http_api import EventQLServer
from eventql_tpu_torch.server.listener import Listener
from eventql_tpu_torch.server.native_tcp import NativeTCPClient, NativeTCPServer

# the published float32 rate of one H100 SXM outside the tensor cores (NVIDIA
# data sheet), taken as the rate of the 32-bit integer compares and adds
# these kernels do; its HBM3 bandwidth is the probes' HBM_BYTES_PER_S
ALU_OPS_PER_S = 67e12

N_ROWS = 1 << 26  # the partition
N_PREFIX_ROWS = 1 << 20  # compared with the host engine
N_KERNEL_CASE_ROWS = 1_000_003  # phase 3: a multiple of nothing
REPS = 5  # runs of each query; the first warms the column cache
N_KEYS = 1024
BIG_BASE = 20_000_000
BIG_SPAN = 100_000
CAT_LO, CAT_HI = -40, 60
N_DIMS = 1024  # the small dimension table: shared-memory probe
DIM_MULT = 7919
N_BIG_DIMS = 1 << 18  # the large one: hash table in global memory
BIG_DIM_MULT = 2654435761
N_REGIONS = 1024
FAST_TOPK_ROWS = 1 << 22  # from here on a single-key top-k takes the histograms
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


_T0 = time.perf_counter()


def log(msg):
    if msg.startswith("phase "):  # with the seconds since the script began
        msg += f" [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- phase 3: kernels against their plain versions ----------------------------

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def dev_tensor(arr, device):
    arr = np.ascontiguousarray(arr)
    view = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr.view(view) if view else arr).to(device)


def kernel_cases(n, device, rng):
    """Yield (kernel name, label, kwargs for wrapper and plain version)."""

    def keys(K, dt, lo=0):
        return dev_tensor(rng.integers(lo - 2, lo + K + 2, n).astype(dt), device)

    v16 = dev_tensor(rng.integers(0, 60000, n).astype(np.uint16), device)
    v32 = dev_tensor(rng.integers(0, 1 << 32, n, dtype=np.uint32), device)
    v64 = dev_tensor(rng.integers(0, 1 << 64, n, dtype=np.uint64), device)
    p16 = dev_tensor(rng.integers(-20000, 20000, n).astype(np.int16), device)
    p32 = dev_tensor(rng.integers(0, 1 << 20, n).astype(np.int32), device)
    pu16 = dev_tensor(rng.integers(0, 65535, n).astype(np.uint16), device)
    mask = dev_tensor(rng.random(n) < 0.7, device)

    value_lt = [ga.Pred("value", "lt", 30000)]
    for K in (1, 128, 1024, 8192, 100_000, 131_073):
        widths = [(np.int32, False)]
        if K + 2 < (1 << 15):
            widths.append((np.int16, False))
        if K + 2 < (1 << 16):
            widths.append((np.uint16, True))
        for dt, uns in widths:
            lo = 2 if uns else 0  # keep unsigned keys non-negative
            base = lo
            yield "groupby_agg", f"K={K} key={np.dtype(dt).name}", dict(
                gid=keys(K, dt, lo), n=n, num_buckets=K, values=v16,
                value_bits=16, preds=value_lt, gid_base=base,
                gid_unsigned=uns, values_unsigned=True)
    g1024 = keys(1024, np.int16)
    for op in ("lt", "le", "gt", "ge", "eq", "ne"):
        yield "groupby_agg", f"op={op}", dict(
            gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
            preds=[ga.Pred("value", op, 31000)], values_unsigned=True)
    two = {
        "value+value": [ga.Pred("value", "ge", 1000), ga.Pred("value", "lt", 50000)],
        "value+stream": [ga.Pred("value", "lt", 30000), ga.Pred("stream", "ge", 1 << 19, p32)],
        "stream+stream": [ga.Pred("stream", "gt", 0, p16), ga.Pred("stream", "le", 40000, pu16, True)],
        "gid+stream": [ga.Pred("gid", "ge", 100), ga.Pred("stream", "ne", 7, p16)],
        "gid+gid": [ga.Pred("gid", "ge", 100), ga.Pred("gid", "lt", 900)],
    }
    for label, preds in two.items():
        for comb in ("and", "or"):
            count_only = label.startswith("gid")
            yield "groupby_agg", f"two preds {label} {comb}", dict(
                gid=g1024, n=n, num_buckets=1024,
                values=None if count_only else v16, value_bits=16,
                preds=preds, combine=comb, values_unsigned=True)
    for base in (-1000, 20_000_000, (1 << 32) - 5000):
        k = rng.integers(0, 500, n) + base
        arr = (k & 0xFFFFFFFF).astype(np.uint32) if base > 0 else k.astype(np.int32)
        yield "groupby_agg", f"gid_base={base}", dict(
            gid=dev_tensor(arr, device), n=n, num_buckets=500, values=v32,
            value_bits=32, preds=[ga.Pred("gid", "ge", -(1 << 31))],
            gid_base=base)
    for bits, vals in ((16, v16), (32, v32), (64, v64), (48, v64)):
        yield "groupby_agg", f"value_bits={bits} masked", dict(
            gid=g1024, n=n, num_buckets=1024, values=vals, value_bits=bits,
            mask=mask, values_unsigned=bits == 16)
    yield "groupby_agg", "all rows filtered", dict(
        gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
        preds=[ga.Pred("value", "gt", 70000)], values_unsigned=True)
    yield "groupby_agg", "byte-mask predicate stream", dict(
        gid=g1024, n=n, num_buckets=1024, values=v16, value_bits=16,
        preds=[ga.Pred("stream", "ge", 1, mask)], values_unsigned=True)
    yield "groupby_agg", "count only, masked, ragged n", dict(
        gid=g1024, n=n - 12345, num_buckets=1024, mask=mask)
    g32 = keys(1024, np.int32)
    gbig = keys(100_000, np.int32)
    for S in (2, 3):
        streams = [v16, v32, p32][:S]
        bits = [16, 32, 24][:S]
        uns = [True, False, False][:S]
        for label, g, K in (("K=1024", g32, 1024), ("K=100000", gbig, 100_000)):
            yield "groupby_multi_agg", f"S={S} {label}", dict(
                gid=g, n=n, num_buckets=K, streams=streams, stream_bits=bits,
                mask=mask, streams_unsigned=uns)
    yield "groupby_multi_agg", "S=2 no mask", dict(
        gid=g32, n=n, num_buckets=1024, streams=[v16, v32],
        stream_bits=[16, 32], streams_unsigned=[True, False])

    # streams that start 1, 3 and 7 rows into their allocations (no 16-byte
    # boundary: the scalar loads), the shortest streams and a long one,
    # every stream type: i16 / u16 / i32 / i64 keys, u16 / u32 / u64
    # values, an i16 predicate stream, the byte mask
    typed = ((np.int16, False, v16, 16, True), (np.uint16, True, v32, 32, False),
             (np.int32, False, v64, 64, False), (np.int64, False, v16, 16, True))
    for off in (1, 3, 7):
        for rows in (*range(1, 18), n - off):
            dt, uns, vals, bits, vuns = typed[(rows + off) % len(typed)]
            yield "groupby_agg", f"offset {off} n={rows} key={np.dtype(dt).name}", dict(
                gid=keys(5, dt, 2)[off:], n=rows, num_buckets=5, values=vals[off:],
                value_bits=bits, mask=mask[off:], gid_base=2, gid_unsigned=uns,
                preds=[ga.Pred("stream", "ge", -15000, p16[off:])],
                values_unsigned=vuns)
        for rows in (1, 4, 5, 9, 17, n - off):
            yield "groupby_multi_agg", f"offset {off} n={rows}", dict(
                gid=g32[off:], n=rows, num_buckets=1024,
                streams=[v16[off:], v64[off:], v32[off:]], stream_bits=[16, 64, 32],
                mask=mask[off:], streams_unsigned=[True, False, False])
    # one stream off its boundary is enough to take the scalar loads
    yield "groupby_agg", "only the value stream sliced", dict(
        gid=g1024[:n - 1], n=n - 1, num_buckets=1024, values=v16[1:], value_bits=16,
        values_unsigned=True)
    # K on both sides of the edge between the table in shared memory and
    # the table in global memory, for no sum, one sum and eight
    eight = [v16, v32, v64, p32, v16, v64, v32, v64]
    eight_bits = [16, 32, 64, 24, 8, 48, 32, 64]
    eight_uns = [True, False, False, False, True, False, False, False]
    for S in (0, 1, 8):
        for K in table_form_edges(S, device) + ([131_073] if S == 8 else []):
            form = ("shared" if ga.table_in_shared_memory(K, S, ga.smem_optin(device))
                    else "global")
            g = keys(K, np.int32)
            if S == 8:
                yield "groupby_multi_agg", f"S=8 K={K} form={form}", dict(
                    gid=g, n=n, num_buckets=K, streams=eight, stream_bits=eight_bits,
                    mask=mask, streams_unsigned=eight_uns)
            else:
                yield "groupby_agg", f"S={S} K={K} form={form}", dict(
                    gid=g, n=n, num_buckets=K, values=v64 if S else None,
                    value_bits=64, mask=mask)
    # every row in one bucket, 64-bit values: the low word wraps on every
    # other add and each wrap must carry
    hot = torch.zeros(n, dtype=torch.int32, device=device)
    for bits, vals in ((64, v64), (32, v32)):
        yield "groupby_agg", f"one hot key, {bits}-bit values", dict(
            gid=hot, n=n, num_buckets=3, values=vals, value_bits=bits)
    yield "groupby_multi_agg", "one hot key, three sums", dict(
        gid=hot, n=n, num_buckets=1, streams=[v64, v32, v16], stream_bits=[64, 32, 16],
        streams_unsigned=[False, False, True])


def table_form_edges(nsums, device):
    """The largest bucket count whose table of ``nsums`` sums a block of
    this device keeps in its shared memory, and the next, whose table
    lies in global memory (kernels/groupby_agg.table_in_shared_memory)."""
    optin = ga.smem_optin(device)
    whole = optin // (8 * (1 + nsums))
    check(ga.table_in_shared_memory(whole, nsums, optin)
          and not ga.table_in_shared_memory(whole + 1, nsums, optin),
          f"no edge between the table forms at K = {whole} for {nsums} sums")
    return [whole, whole + 1]


def extract_cases(n, rng):
    """Yield (label, values int32[n], threshold, cap, rows or None) for
    extract_ge: the corners of the compaction (no match, the ragged
    tail, the cap, the int32 ends) and of its look-back over tiles of
    ex.TILE_ROWS rows (matches only in the last tile, the cap reached in
    the first, one match a tile, n one row either side of a tile and at
    two tiles)."""
    base = rng.integers(0, 1000, n).astype(np.int32)
    tile = ex.TILE_ROWS

    def planted(rows, value=9000):
        v = base.copy()
        v[rows] = value
        return v

    tail = np.arange(n - (n % 4096 or 1), n)
    yield "no match", base, 5000, 64, None
    yield "one match in the last row", planted([n - 1]), 5000, 64, None
    yield "matches only in the ragged tail", planted(tail), 5000, len(tail) + 7, None
    some = rng.choice(n, size=min(300, n), replace=False)
    yield "exactly cap matches", planted(some), 5000, len(some), None
    many = rng.choice(n, size=min(1000, n), replace=False)
    yield "more than cap matches", planted(many), 5000, max(1, len(many) // 3), None
    yield "every row a match", base, 0, min(n, 4096), None
    yield "cap = 1", planted(many), 5000, 1, None
    yield "half the rows, cap = n", base, 500, n, None
    signed = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    yield "threshold INT32_MIN", signed, I32_MIN, min(n, 100), None
    yield "threshold INT32_MAX", planted(some, I32_MAX), I32_MAX, len(some) + 5, None
    yield "n below the stream's length", planted(many), 5000, 2000, n - n // 3
    last = rng.choice(np.arange((n - 1) // tile * tile, n), size=min(50, n - (n - 1) // tile * tile),
                      replace=False)
    yield "matches only in the last tile", planted(last), 5000, len(last) + 5, None
    yield "the cap reached in the first tile", base, 500, min(n, 100), None
    each = np.arange(0, n, tile) + rng.integers(0, tile, (n + tile - 1) // tile)
    each = np.minimum(each, n - 1)
    yield "one match a tile", planted(each), 5000, len(each) + 3, None
    edges = planted([r for r in (tile - 2, tile - 1, tile, 2 * tile - 1, 2 * tile) if r < n])
    for label, rows in (("n one row below a tile", tile - 1), ("n one row above a tile", tile + 1),
                        ("n at two tiles", 2 * tile)):
        yield label, edges, 900, min(n, rows), min(n, rows)


def _fingerprint_twin(lo, hi):
    """A key with the high word ``hi`` and the 32-bit fingerprint of the
    key (0, lo) under the mix the TPU kernel compared by: the pair its
    precondition ruled out."""
    f = (((hi << 13) & 0xFFFFFFFF) | ((hi >> 19) & 0x1FFF)) ^ ((hi >> 7) & 0x01FFFFFF)
    return (hi << 32) | (lo ^ f)


def join_cases(n, device, rng):
    """Yield (kernel name, label, kwargs) for the two join probes: the
    dimension counts around the tier boundary, a ragged n, misses, keys
    with the top bit set, the all-ones key (the hash table's empty
    mark), colliding fingerprints, narrowed fact key streams."""
    ALL_ONES = 0xFFFFFFFFFFFFFFFF

    def dims(D, top_bit=False, all_ones=False, narrow_to=None):
        if narrow_to is not None:
            keys = rng.choice(1 << narrow_to, D, replace=False).astype(np.uint64)
            keys[0] = (1 << narrow_to) - 1  # the narrow type's top bit
        else:
            keys = rng.permutation(np.arange(D, dtype=np.uint64) * 104729 + 11)
        if top_bit:
            keys[::2] |= np.uint64(1 << 63)
        if all_ones:
            keys[D // 2] = ALL_ONES
        return keys, rng.integers(0, 100_000, D).astype(np.int32)

    def facts(keys, dtype=np.uint64):
        # two rows in three hit a dimension key, the rest are near misses
        hit = keys[rng.integers(0, len(keys), n)]
        return np.where(rng.random(n) < 0.67, hit, hit + np.uint64(1)).astype(dtype)

    def mixed_dims(D):
        """D dimension keys for streams of every width: u16 keys (with
        0xFFFF), u32 keys (with the u32 all-ones key 0xFFFFFFFF), keys of
        2^32 and more (with the 64-bit all-ones key), half of them with
        the low word of a narrower key of the set, and one key in 16
        again further down under another bucket (the lowest row wins)."""
        unique = D - D // 16
        k16 = rng.choice(0xFFFF, unique // 4, replace=False).astype(np.uint64)
        k32 = rng.choice(0xFFFFFFFF - 0x10000, unique // 4, replace=False) + 0x10000
        k32 = k32.astype(np.uint64)
        k16[0], k32[0] = 0xFFFF, 0xFFFFFFFF
        lows = np.concatenate([k16, k32])
        m = unique - len(lows)
        low = np.where(np.arange(m) % 2 == 0, lows[rng.integers(0, len(lows), m)],
                       rng.integers(0, 1 << 32, m).astype(np.uint64))
        high = (rng.integers(1, 1 << 32, m).astype(np.uint64) << np.uint64(32)) | low
        high[0] = ALL_ONES
        keys = rng.permutation(np.concatenate([lows, high]))
        check(len(np.unique(keys)) == unique, "mixed_dims: duplicate keys drawn")
        bucket = rng.integers(0, 100_000, unique).astype(np.int32)
        again = rng.choice(unique, D - unique, replace=False)
        return (np.concatenate([keys, keys[again]]),
                np.concatenate([bucket, bucket[again] + 1]))

    def mixed_facts(keys, dtype):
        """n fact keys stored as ``dtype``: each dimension key cut to the
        stream's width (for a key of 2^32 or more on a u32 stream that is
        a hit only where its low word is a key too), random keys of the
        width (misses), and the width's all-ones key; with one hit and
        one miss of the width."""
        bits = 8 * np.dtype(dtype).itemsize
        mask = np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(ALL_ONES)
        f = np.where(rng.random(n) < 0.6, keys[rng.integers(0, len(keys), n)] & mask,
                     rng.integers(0, 1 << min(bits, 63), n, dtype=np.uint64))
        f[::97] = mask
        fits = keys[keys <= mask]
        absent = np.setdiff1d(np.arange(64, dtype=np.uint64), keys)
        return f.astype(dtype), fits[0], absent[0]

    def both(label, keys, bucket, fact, rows=None, probe_only=False, skip=0):
        dk, db, f = (dev_tensor(a, device) for a in (keys, bucket, fact))
        f = f[skip:]  # skip > 0: the stream starts off a 16-byte boundary
        if not probe_only:
            yield "dim_join_gid", label, dict(
                fact_keys=f, dim_keys=dk, dim_bucket=db, n=rows)
        yield "probe_join_gid", label, dict(
            fact_keys=f, dim_keys=dk, dim_bucket=db, n=rows)

    for D in (1, 127, 1024, kj.MAX_COMPARE_DIMS):
        keys, bucket = dims(D)
        yield from both(f"D={D}", keys, bucket, facts(keys))
    for D in (kj.MAX_COMPARE_DIMS + 1, N_BIG_DIMS, 1 << 22):
        keys, bucket = dims(D)
        yield from both(f"D={D}", keys, bucket, facts(keys), probe_only=True)
    # the dimension rows sorted (as valid an order as any), and with every
    # third key again further down under another bucket: the lowest row wins
    for D in (3001, 20_011):
        keys, bucket = dims(D, top_bit=True)
        order = np.argsort(keys, kind="stable")
        yield from both(f"D={D} sorted dims", keys[order], bucket[order], facts(keys),
                        probe_only=D > kj.MAX_COMPARE_DIMS)
        dup = np.concatenate([keys, keys[::3]])
        dup_bucket = np.concatenate([bucket, bucket[::3] + 1])
        yield from both(f"D={len(dup)} duplicate keys", dup, dup_bucket, facts(keys),
                        probe_only=len(dup) > kj.MAX_COMPARE_DIMS)
    # the shortest streams, the sizes around one tile of the probe (256
    # threads x 8 rows), streams off their boundary, all three widths
    keys, bucket = dims(20_011, all_ones=True)
    for rows in (1, 2, 7, 8, 9, 2047, 2048, 2049):
        for skip in (0, 3):
            f = facts(keys)[:rows + skip]
            f[skip] = keys[5]  # the first row probed is a hit, the last a miss
            f[-1] = keys[5 * (rows == 1)] + np.uint64(rows > 1)
            yield from both(f"n={rows} skip={skip}", keys, bucket, f, rows=rows,
                            probe_only=True, skip=skip)
    for bits, dt in ((16, np.uint16), (32, np.uint32), (64, np.uint64)):
        keys, bucket = dims(9001, narrow_to=min(bits, 40))
        f = np.where(rng.random(n) < 0.67, keys[rng.integers(0, 9001, n)],
                     rng.integers(0, 1 << min(bits, 40), n).astype(np.uint64)).astype(dt)
        for skip in (0, 1):
            yield from both(f"D=9001 fact keys u{bits} skip={skip}", keys, bucket, f,
                            rows=n - 7, probe_only=True, skip=skip)
    # the same for both probes against D <= 8192 (dim_join_gid's tier, up to
    # its edge): the sizes around one tile of dim_join_gid (1024 threads x 8
    # rows; 512 x 8 and the probe's tile too), streams off their boundary, all
    # three widths, each against dimension keys of every width
    for D in (1000, kj.MAX_COMPARE_DIMS):
        keys, bucket = mixed_dims(D)
        for bits, dt in ((16, np.uint16), (32, np.uint32), (64, np.uint64)):
            f, hit, miss = mixed_facts(keys, dt)
            for skip in (0, 1):
                yield from both(f"D={D} mixed dims, u{bits} skip={skip}", keys, bucket, f,
                                rows=n - 7, skip=skip)
            if D != kj.MAX_COMPARE_DIMS:
                continue
            for rows in (1, 2, 7, 8, 9, 2049, 4095, 4096, 4097, 8191, 8192, 8193, 16385):
                for skip in (0, 3):
                    g = f[:rows + skip].copy()
                    g[skip] = hit  # the first row probed is a hit, the last a miss
                    if rows > 1:
                        g[-1] = miss
                    yield from both(f"D={D} mixed dims, u{bits} n={rows} skip={skip}",
                                    keys, bucket, g, rows=rows, skip=skip)
    keys, bucket = dims(5003)
    yield from both("ragged n", keys, bucket, facts(keys), rows=n - 12345)
    keys, bucket = dims(3001, top_bit=True)
    f = facts(keys)
    f[::7] ^= np.uint64(1 << 63)  # the same low 63 bits: misses
    yield from both("top-bit keys", keys, bucket, f)
    keys, bucket = dims(2000, top_bit=True, all_ones=True)
    f = facts(keys)
    f[::5] = ALL_ONES
    yield from both("all-ones key among the dims", keys, bucket, f)
    keys, bucket = dims(2000)
    f = facts(keys)
    f[::5] = ALL_ONES
    yield from both("all-ones key only among the facts", keys, bucket, f)
    lows = rng.choice(1 << 31, 500, replace=False)
    keys = np.array([int(lo) for lo in lows]
                    + [_fingerprint_twin(int(lo), 1 + i) for i, lo in enumerate(lows)],
                    dtype=np.uint64)
    yield from both("colliding fingerprints", keys,
                    rng.integers(0, 512, len(keys)).astype(np.int32), facts(keys))
    for bits, dt in ((16, np.uint16), (32, np.uint32)):
        keys, bucket = dims(700, narrow_to=bits)
        f = np.where(rng.random(n) < 0.67, keys[rng.integers(0, 700, n)],
                     rng.integers(0, 1 << bits, n).astype(np.uint64)).astype(dt)
        yield from both(f"fact keys narrowed to u{bits}", keys, bucket, f)


def hash_cases(n, device, rng):
    """Yield (label, kwargs of hash_groupby and its plain version): 1, 2
    and 3 keys of every width the kernel reads, NULL keys beside a real
    key 0, every row a group of its own, one hot key, u64 maxima of 2^63
    and more, negative i64 minima, NaN and -0.0 under min / max / mean,
    count_distinct. Floats are multiples of 1/64: every sum is exact in
    any order."""
    def t(a):
        return dev_tensor(a, device)

    mask = t(rng.random(n) < 0.7)
    u64 = rng.integers(0, 1 << 40, n).astype(np.uint64)
    u64[rng.integers(0, n, n // 100)] |= np.uint64(1 << 63)
    i64 = rng.integers(-(1 << 50), 1 << 50, n).astype(np.int64)
    f = rng.integers(-(1 << 20), 1 << 20, n) / 64.0
    f[rng.integers(0, n, 40)] = np.nan
    f[rng.integers(0, n, 1000)] = -0.0
    u16 = t(rng.integers(0, 65536, n).astype(np.uint16))
    small = t(rng.integers(0, 50, n).astype(np.int32))
    every = dict(
        values=[t(u64)] * 3 + [t(i64)] * 3 + [t(f)] * 4 + [u16] * 3,
        kinds=["sum", "min", "max"] * 2 + ["sum", "min", "max", "mean"] + ["sum", "min", "max"],
        values_unsigned=[True] * 3 + [False] * 3 + [False] * 4 + [True] * 3,
        distinct=[small, t(u64 % np.uint64(997))])
    k5000 = rng.integers(0, 5000, n)
    yield "1 key (i64), every kind, masked", dict(
        keys=[t(k5000.astype(np.int64))], n=n, mask=mask, **every)
    yield "2 keys (i16, i32)", dict(
        keys=[t((k5000 % 300).astype(np.int16)), t((k5000 // 300).astype(np.int32))],
        n=n, mask=mask, **every)
    fk = (k5000 % 5).astype(np.float64)
    fk[(k5000 % 5 == 0) & (k5000 % 3 == 0)] = -0.0  # -0.0 and +0.0: two groups
    yield "3 keys (i16, u8, f64)", dict(
        keys=[t((k5000 % 40).astype(np.int16)), t(k5000 % 2 == 0), t(fk)],
        n=n - 17, mask=mask, **every)
    valid = rng.random(n) < 0.9
    real0 = np.where(valid, k5000 % 64, 0)  # NULL keys fold to 0 beside real 0s
    yield "NULL keys beside a real key 0", dict(
        keys=[t(real0.astype(np.int32)), t((~valid).astype(np.int64))], n=n, mask=None,
        **every)
    yield "every row its own group (about 2^20 groups)", dict(
        keys=[t(rng.permutation(n).astype(np.int64))], n=n, mask=None, **every)
    yield "one hot key", dict(
        keys=[t(np.zeros(n, np.int64))], n=n, mask=mask, **every)
    more = hg.MAX_VALUES + 4  # more value streams than one aggregate launch takes
    yield f"{more} value streams", dict(
        keys=[t((k5000 % 500).astype(np.int32))], n=n, mask=mask,
        values=[t(i64 + j) for j in range(more)], kinds=["sum", "min", "max", "sum"] * (more // 4))
    # the direct tiers: keys with spans (TIER_CASES names the tier and the
    # count_distinct forms each must take at phase 3's size)
    yield "shared tier: 2 keys, 1000 slots, every kind", dict(
        keys=[t((k5000 % 50).astype(np.int16)), t((k5000 // 50 % 20).astype(np.int32))],
        n=n, mask=mask, key_spans=[(0, 50, False), (0, 20, False)], **every,
        distinct_spans=[(0, 50, False), (0, 997, True)])
    yield "global tier: 1 key, 5000 slots, every kind", dict(
        keys=[t(k5000.astype(np.int64))], n=n, mask=mask, key_spans=[(0, 5000, False)],
        **every, distinct_spans=[(0, 50, False), (0, 997, True)])
    u32 = (np.uint64(1 << 31) + (k5000 % 3000).astype(np.uint64)).astype(np.uint32)
    three = dict(values=every["values"][:3], kinds=every["kinds"][:3],
                 values_unsigned=every["values_unsigned"][:3])
    yield "u32 keys >= 2^31 (read zero-extended)", dict(
        keys=[t(u32)], n=n, mask=mask, key_spans=[(1 << 31, 3000, True)], **three)
    valid_k = rng.random(n) < 0.8
    yield "NULL key outside the stats ([100, 200), NULL read as 0)", dict(
        keys=[t(np.where(valid_k, 100 + k5000 % 100, 0).astype(np.int64)),
              t((~valid_k).astype(np.int64))],
        n=n, mask=mask, key_spans=[(0, 200, False), (0, 2, False)], **three)
    yield "negative base", dict(
        keys=[t((k5000 % 500 - 1000).astype(np.int64))], n=n, mask=None,
        key_spans=[(-1000, 500, False)], **three)
    yield "bitmap count_distinct, global bitmap, and a set", dict(
        keys=[t(k5000.astype(np.int32))], n=n, mask=mask, key_spans=[(0, 5000, False)],
        distinct=[small, t(u64 % np.uint64(997)), t(u64)],
        distinct_spans=[(0, 50, False), (0, 997, True), None])
    zeros = t(np.zeros(n, np.int16))
    yield "one hot key, shared tier", dict(
        keys=[zeros], n=n, mask=mask, key_spans=[(0, 1024, False)], **every)
    yield "one hot key, global tier", dict(
        keys=[zeros], n=n, mask=mask, key_spans=[(0, 40000, False)], **every)
    yield "no key, shared tier", dict(keys=[], n=n, mask=mask, key_spans=[], **every)
    yield "unaligned streams, shared tier", dict(
        keys=[t((k5000 % 1000).astype(np.int16))[1:]], n=n - 1, mask=mask[1:],
        values=[v[1:] for v in every["values"]], kinds=every["kinds"],
        values_unsigned=every["values_unsigned"], key_spans=[(0, 1000, False)])
    yield f"{more} value streams, shared tier", dict(
        keys=[t((k5000 % 500).astype(np.int32))], n=n, mask=mask,
        key_spans=[(0, 500, False)],
        values=[t(i64 + j) for j in range(more)], kinds=["sum", "min", "max", "sum"] * (more // 4))


# the tier and count_distinct forms each spanned case of hash_cases takes at
# phase 3's size
TIER_CASES = {
    "shared tier: 2 keys, 1000 slots, every kind": ("shared", {"bitmap_shared": 2}),
    "global tier: 1 key, 5000 slots, every kind": ("global", {"bitmap_shared": 1,
                                                              "bitmap_global": 1}),
    "u32 keys >= 2^31 (read zero-extended)": ("shared", {}),
    "NULL key outside the stats ([100, 200), NULL read as 0)": ("shared", {}),
    "negative base": ("shared", {}),
    "bitmap count_distinct, global bitmap, and a set": (
        "shared", {"bitmap_shared": 1, "bitmap_global": 1, "set": 1}),
    "one hot key, shared tier": ("shared", {"set": 2}),
    "one hot key, global tier": ("global", {"set": 2}),
    "no key, shared tier": ("shared", {"set": 2}),
    "unaligned streams, shared tier": ("shared", {}),
    f"{hg.MAX_VALUES + 4} value streams, shared tier": ("shared", {}),
}


def expected_forms(kw, smem):
    """The tier and count_distinct forms of a hash_groupby call, by the
    wrapper's mirror of the launchers' rules."""
    spans, n = kw.get("key_spans"), kw["n"]
    tier = hg.tier_of(spans, min(len(kw.get("values", ())), hg.MAX_VALUES), n, smem)
    out = {tier: 1}
    dspans = kw.get("distinct_spans") or [None] * len(kw.get("distinct", ()))
    for sp in dspans:
        form = "set" if tier == "hash" else hg.distinct_form(
            hg._slots(spans), sp, n, smem)
        out[form] = out.get(form, 0) + 1
    return out


def tier_edges(smem, n):
    """(span sizes, nv, n, tier) at the tier rule's boundaries: one slot
    either side of the shared cap and of the direct-global memory limit,
    a span product that overflows int64, a key with no span, no key. For
    n of 100 000 rows or more (below, the limit lies under the cap)."""
    lim = hg.direct_limit(n)
    out = []
    for nv in (0, 3, hg.MAX_VALUES):
        cap = smem // (8 + 8 * nv)
        top = lim // (8 * (2 + nv))
        out += [([cap], nv, n, "shared"), ([cap + 1], nv, n, "global"),
                ([2, cap // 2], nv, n, "shared"), ([2, cap // 2 + 1], nv, n, "global"),
                ([top], nv, n, "global"), ([top + 1], nv, n, "hash")]
    out += [([1 << 31, 1 << 31, 4], 0, n, "hash"), ([10, None], 0, n, "hash"),
            ([None], 0, n, "hash"), ([], 0, n, "shared"), ([1], 16, 0, "shared")]
    return out


def distinct_edges(smem, n):
    """(slots, payload span, n, form) at the count_distinct form's
    boundaries."""
    lim = hg.direct_limit(n)
    words = smem // 4
    return [(words, 32, n, "bitmap_shared"), (words, 33, n, "bitmap_global"),
            (words + 1, 32, n, "bitmap_global"), (lim // 4, 32, n, "bitmap_global"),
            (lim // 4 + 1, 32, n, "set"), (1, None, n, "set"), (3, 1, n, "bitmap_shared"),
            (1 << 30, 1 << 30, n, "set")]


def same_grouped(got, want):
    """(equal?, max |difference|) of two Grouped, compared in the order
    of their first rows: integers exactly, floats by their bits (the sign
    of zero too) except that a NaN equals a NaN."""
    g, w = hg.in_first_row_order(got), hg.in_first_row_order(want)
    if g.first_index.shape != w.first_index.shape:
        return False, float("inf")
    ok = torch.equal(g.first_index, w.first_index) and torch.equal(g.counts, w.counts)
    err = 0.0
    for a, b in zip((*g.aggregates, *g.distinct), (*w.aggregates, *w.distinct)):
        if a.dtype != b.dtype:
            return False, float("inf")
        if a.dtype == torch.float64:
            na, nb = torch.isnan(a), torch.isnan(b)
            ok = ok and torch.equal(na, nb) and torch.equal(
                a[~na].view(torch.int64), b[~na].view(torch.int64))
            if int((~na).sum()) and torch.equal(na, nb):
                err = max(err, float((a[~na] - b[~na]).abs().max()))
        else:
            ok = ok and torch.equal(a, b)
            if a.numel():
                err = max(err, float((a - b).abs().max()))
    return ok, err


def check_hash_case(label, got, want):
    ok, err = same_grouped(got, want)
    check(ok, f"hash_groupby [{label}]: kernel and plain version disagree"
          f" (max |diff| {err})")
    check(int((got.counts > 0).sum()) > 0, f"hash_groupby [{label}]: no group")
    return err


class _Kernel:
    """One wrapper of the port: where it lives, its plain version, and
    the module that counts its launches."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.wrapper = getattr(module, name)
        self.plain = getattr(module, name + "_plain")

    @property
    def launches(self):
        return self.module.LAUNCHES[self.name]


_KERNELS = {
    "groupby_agg": _Kernel(ga, "groupby_agg"),
    "groupby_multi_agg": _Kernel(ga, "groupby_multi_agg"),
    "extract_ge": _Kernel(ex, "extract_ge"),
    "dim_join_gid": _Kernel(kj, "dim_join_gid"),
    "probe_join_gid": _Kernel(kj, "probe_join_gid"),
    "hash_groupby": _Kernel(hg, "hash_groupby"),
}


# the kernels of the repository's TPU probes (scripts/probe_*.py): their own
# path is the port's probes (eventql_tpu_torch/scripts), not a query
_PROBE_KERNELS = {
    "place_runs": _Kernel(kp, "place_runs"),
    "int8_form": _Kernel(kp, "int8_form"),
}


def launch_counts():
    return {name: k.launches for name, k in _KERNELS.items()}


def _forms_since(forms):
    """hash_groupby's launches by tier and count_distinct form since
    ``forms`` (a copy of hg.FORMS)."""
    return {k: hg.FORMS[k] - forms[k] for k in hg.FORMS if hg.FORMS[k] != forms[k]}


def zero_launch_counts():
    for k in _KERNELS.values():
        for name in k.module.LAUNCHES:  # the table-build kernel's count too
            k.module.LAUNCHES[name] = 0


# the expression program (kernels/csrc/expr_program.cu) is no wrapper with a
# plain twin of the same signature: torch_expr counts its launches, and the
# expressions that went to the PyTorch path, in two module counters
def program_counts():
    return {"launches": torch_expr.PROGRAM_LAUNCHES, "fallbacks": torch_expr.PROGRAM_FALLBACKS}


def zero_program_counts():
    torch_expr.PROGRAM_LAUNCHES = 0
    torch_expr.PROGRAM_FALLBACKS = 0


def check_extract(label, got, want, values, threshold, cap, rows):
    """extract_ge against its plain version, and the contract itself:
    ascending row indices of matches, then -1."""
    check(got.dtype == torch.int32 and got.shape == (cap,),
          f"extract_ge [{label}]: shape/dtype")
    check(torch.equal(got, want),
          f"extract_ge [{label}]: kernel and plain version disagree")
    rows = values.shape[0] if rows is None else rows
    total = int((values[:rows] >= threshold).sum())
    kept = min(total, cap)
    check(bool((got[kept:] == -1).all()) and bool((got[:kept] >= 0).all()),
          f"extract_ge [{label}]: {kept} matches expected before the -1 padding")
    return kept


N_PROBE_CASE_WORDS = 1 << 24  # phase 3's place_runs and int8_form cases


def place_runs_cases(n, device, rng):
    """(label, keyword arguments of place_runs) over n u32 words (rows of
    128): runs of 256 and 4096 elements that cover the array, each to a
    random slot; fewer runs than slots into a given ``out`` (the rows no
    run writes keep its -7); R not a multiple of the run; runs whose source
    or destination leaves the array (not copied); a source, an ``out`` or
    both off a 16-byte boundary (the scalar kernel), runs of 3 rows."""
    R = n // kp.ROW_WORDS
    words = rng.integers(0, 2**32, (R, kp.ROW_WORDS), dtype=np.uint32)
    src = dev_tensor(words, device)

    def offsets(*arrays):
        return [torch.from_numpy(np.asarray(a, np.int32)).to(device) for a in arrays]

    for elements in (256, 4096):
        rows = elements // kp.ROW_WORDS
        nruns = R // rows
        so, do = offsets(np.arange(nruns) * rows, rng.permutation(nruns) * rows)
        yield f"runs of {elements}, covering", dict(src=src, src_off=so, dst_off=do, rows=rows)
    rows, slots = 8, R // 8
    nruns = slots // 3
    so, do = offsets(rng.choice(slots, nruns, replace=False) * rows,
                     rng.choice(slots, nruns, replace=False) * rows)
    yield "fewer runs than slots, out given", dict(
        src=src, src_off=so, dst_off=do, rows=rows, out=torch.full_like(src, -7))
    odd = src[: R - 3]
    rows = 4
    nruns = odd.shape[0] // rows
    so, do = offsets(np.arange(nruns) * rows, rng.permutation(nruns) * rows)
    yield "R not a multiple of the run", dict(src=odd, src_off=so, dst_off=do, rows=rows)
    rows = 2
    nruns = R // rows
    s_off, d_off = np.arange(nruns) * rows, rng.permutation(nruns) * rows
    s_off[:3] = [-2, R - 1, R]
    d_off[3:6] = [-1, R - 1, R + 4]
    so, do = offsets(s_off, d_off)
    yield "runs leaving the array", dict(src=src, src_off=so, dst_off=do, rows=rows)
    rows = 3
    nruns = R // rows
    so, do = offsets(np.arange(nruns) * rows, rng.permutation(nruns) * rows)
    for label, s, o in (("src and out off", off_boundary(src), off_boundary(torch.zeros_like(src))),
                        ("src on, out off", src, off_boundary(torch.zeros_like(src))),
                        ("src off, out on", off_boundary(src), torch.zeros_like(src))):
        yield f"{label} a 16-byte boundary", dict(src=s, src_off=so, dst_off=do, rows=rows, out=o)


def int8_form_cases(n, device):
    """(label, keyword arguments of int8_form): each form on the TPU
    probe's (8, 128) tile, on (8, 128) and n values around +-128 (int8
    wraps), on n + 3 elements off a 16-byte boundary (the scalar
    kernel and a ragged end), and at the short lengths and the lengths
    around one block of the kernel (kp.FORM_BLOCK_ELEMENTS), on and off a
    16-byte boundary (the tail past the last whole 16-byte word)."""
    tile = np.arange(8 * 128).reshape(8, 128)
    inputs = [("the probe's tile", tile % 7, tile % 5),
              ("(8, 128) around +-128", *probe_int8_ops.probe_inputs((8, 128), 21)),
              (f"{n} around +-128", *probe_int8_ops.probe_inputs(n, 22))]
    inputs = [(label, dev_tensor(a.astype(np.int32), device), dev_tensor(b.astype(np.int32), device))
              for label, a, b in inputs]
    a, b = probe_int8_ops.probe_inputs(n + 4, 23)
    inputs.append((f"{n + 3} off a 16-byte boundary", dev_tensor(a, device)[1:],
                   dev_tensor(b, device)[1:]))
    block = kp.FORM_BLOCK_ELEMENTS
    for length in (1, 3, 4, 5, block - 1, block, block + 1):
        a, b = (dev_tensor(x, device) for x in probe_int8_ops.probe_inputs(length, 24 + length))
        inputs.append((f"{length}", a, b))
        inputs.append((f"{length} off a 16-byte boundary", off_boundary(a), off_boundary(b)))
    for case in kp.INT8_CASES:
        for label, a, b in inputs:
            yield f"{case}, {label}", dict(a=a, b=b, case=case)


def _fresh(kw):
    """``kw`` with its ``out`` (written in place) copied to a buffer as far
    off a 16-byte boundary as ``out`` is."""
    out = kw.get("out")
    if out is None:
        return kw
    skew = out.data_ptr() % 16 // out.element_size()
    flat = torch.empty(out.numel() + skew, dtype=out.dtype, device=out.device)
    return dict(kw, out=flat[skew:].view(out.shape).copy_(out))


def probe_kernel_cases(device, n):
    """place_runs and int8_form against their plain versions; returns the
    number of cases and each kernel's largest |difference|."""
    rng = np.random.default_rng(17)
    cases, errs = 0, {name: 0 for name in _PROBE_KERNELS}
    all_cases = [("place_runs", label, kw) for label, kw in place_runs_cases(n, device, rng)]
    all_cases += [("int8_form", label, kw) for label, kw in int8_form_cases(n, device)]
    for name, label, kw in all_cases:
        k = _PROBE_KERNELS[name]
        if "out off" in label:
            check(_fresh(kw)["out"].data_ptr() % 16 != 0, f"{name} [{label}]: out is aligned")
        got = k.wrapper(**_fresh(kw))
        want = k.plain(**_fresh(kw))
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype == torch.int32,
              f"{name} [{label}]: shape/dtype differ from the plain version")
        err = int((got.to(torch.int64) - want).abs().max()) if got.numel() else 0
        check(torch.equal(got, want),
              f"{name} [{label}]: kernel and plain version disagree (max |diff| {err})")
        errs[name] = max(errs[name], err)
        if label == "fewer runs than slots, out given":
            kept = int((got == -7).all(dim=1).sum())
            check(kept == got.shape[0] - kw["src_off"].shape[0] * kw["rows"],
                  f"place_runs [{label}]: {kept} rows kept out's values")
        cases += 1
    for name, k in _PROBE_KERNELS.items():
        check(k.launches > 0, f"{name}: no kernel launch in phase 3")
    return cases, errs


def off_boundary(t, skew=1):
    """A contiguous copy of ``t`` that starts ``skew`` elements past a
    16-byte boundary (``skew * t.element_size()`` bytes)."""
    flat = torch.empty(t.numel() + skew, dtype=t.dtype, device=t.device)
    return flat[skew:].view(t.shape).copy_(t)


def extract_kernel_cases(n, device, rng):
    """extract_ge against its plain version on every case of
    ``extract_cases`` at n rows, each also on values 1, 2 and 3 elements
    off a 16-byte boundary (the kernel's scalar head); returns the number
    of calls checked."""
    cases = 0
    for label, values, threshold, cap, rows in extract_cases(n, rng):
        aligned = dev_tensor(values, device)
        for skew in range(4):
            v = off_boundary(aligned, skew) if skew else aligned
            check(v.data_ptr() % 16 == 4 * skew, f"extract_ge [{label}]: skew {skew}")
            where = f"{label}, {skew} off a 16-byte boundary" if skew else label
            got = ex.extract_ge(v, threshold, cap, rows)
            want = ex.extract_ge_plain(v, threshold, cap, rows)
            torch.cuda.synchronize()
            kept = check_extract(where, got, want, v, threshold, cap, rows)
            check((kept > 0) == (label != "no match"), f"extract_ge [{where}]: vacuous")
            cases += 1
    return cases


def phase_kernels(device, n):
    """The case grid: options and widths the main path may not reach.
    Returns place_runs' and int8_form's largest |difference| from their
    plain versions."""
    rng = np.random.default_rng(7)
    cases = extract_kernel_cases(n, device, rng)
    for name, label, kw in kernel_cases(n, device, rng):
        wrapper, plain = _KERNELS[name].wrapper, _KERNELS[name].plain
        got = wrapper(**kw)
        want = plain(**kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} [{label}]: shape/dtype differ from the plain version")
        err = int((got - want).abs().max()) if got.numel() else 0
        check(torch.equal(got, want),
              f"{name} [{label}]: kernel and plain version disagree (max |diff| {err})")
        if label == "all rows filtered":
            check(int(got.sum()) == 0, "filtered rows were counted")
        elif kw["n"] >= 1000:  # a handful of rows may all be filtered
            check(int(got[0].sum()) > 0, f"{name} [{label}]: nothing counted")
        cases += 1
    for name, label, kw in join_cases(n, device, rng):
        got = _KERNELS[name].wrapper(**kw)
        want = _KERNELS[name].plain(**kw)
        torch.cuda.synchronize()
        rows = kw["fact_keys"].shape[0] if kw["n"] is None else kw["n"]
        check(got.dtype == torch.int32 and got.shape == (rows,),
              f"{name} [{label}]: shape/dtype")
        check(torch.equal(got, want),
              f"{name} [{label}]: kernel and plain version disagree on"
              f" {int((got != want).sum())} rows")
        hits = int((got >= 0).sum())
        check(0 < hits and (hits < rows or rows == 1),
              f"{name} [{label}]: {hits} hits in {rows} rows")
        cases += 1
    smem = ga.smem_optin(device)
    for label, kw in hash_cases(n, device, rng):
        forms = dict(hg.FORMS)
        got = hg.hash_groupby(**kw)
        want = hg.hash_groupby_plain(**kw)
        torch.cuda.synchronize()
        check_hash_case(label, got, want)
        took = _forms_since(forms)
        want_forms = expected_forms(kw, smem)
        if n == N_KERNEL_CASE_ROWS and label in TIER_CASES:
            tier, distinct_forms = TIER_CASES[label]
            check(want_forms == {tier: 1, **distinct_forms},
                  f"hash_groupby [{label}]: the rule gives {want_forms}")
        check(took == want_forms, f"hash_groupby [{label}]: took {took}, expected {want_forms}")
        if label.startswith("1 key"):
            a = got.aggregates  # u64 sum/min/max, i64 sum/min/max, f64 sum/min/max/mean
            check(bool((a[2] < 0).any()), "no group's u64 max is 2^63 or more")
            check(bool((a[4] < 0).any()), "no group's i64 min is negative")
            check(all(bool(torch.isnan(a[j]).any()) for j in (7, 8, 9)),
                  "no NaN group under min, max and mean")
            check(bool((got.distinct[0] > 1).all()), "count_distinct: nothing repeated")
        if label.startswith("one hot key"):
            check(hg.in_first_row_order(got).counts.tolist() == [int(kw["mask"][:n].sum())],
                  f"{label}: one group")
        cases += 1
    # the tier rule and the count_distinct form: kernels/hash_groupby.py
    # mirrors the launcher's
    for spans, nv, rows, tier in tier_edges(smem, n):
        check(hg.launcher_tier(spans, nv, rows, smem) == tier
              == hg.tier_of(None if None in spans else [(0, s, False) for s in spans],
                            nv, rows, smem),
              f"tier of spans {spans}, {nv} values, {rows} rows: expected {tier}")
    for slots, span, rows, form in distinct_edges(smem, n):
        check(hg.launcher_distinct_form(slots, span, rows, smem) == form
              == hg.distinct_form(slots, None if span is None else (0, span, False), rows,
                                  smem),
              f"count_distinct form of {slots} slots, payload span {span}: expected {form}")
    # dim_join_gid's launcher shapes its table; kernels/join.py mirrors the rule
    slots_of = kj._lib().evql_dim_table_slots
    for key_bytes in (2, 4, 8):
        for D in range(1, kj.MAX_COMPARE_DIMS + 1):
            check(slots_of(D, key_bytes) == kj.dim_table(D, key_bytes).slots,
                  f"dim_table({D}, {key_bytes}) is not the launcher's slot rule")
    for name, count in launch_counts().items():
        check(count > 0, f"{name}: no kernel launch in phase 3")
    probe_cases, probe_errs = probe_kernel_cases(device, N_PROBE_CASE_WORDS)
    log(f"phase 3: {cases} kernel cases equal to their plain versions"
        f" (n = {n}, tolerance 0); {probe_cases} place_runs and int8_form cases"
        f" (n = {N_PROBE_CASE_WORDS})")
    return probe_errs


# -- phase 3 (b): the probes' path -------------------------------------------------

PROBE_WORDS = 1 << 25  # probe_radix's default size
PROBE_FORM_ELEMENTS = 1 << 24  # probe_int8_ops' default size


def phase_probes(device):
    """The path of place_runs and int8_form: the entry points of the
    port's probes (python3 -m eventql_tpu_torch.scripts.probe_radix, its
    run placement B; probe_int8_ops), with their launch counts set to 0
    just before and read just after. Each probe checks every result
    against its plain version and times kernel, plain version and library
    call (CUDA events). Returns their numbers and the launches."""
    t0 = time.perf_counter()
    for k in _PROBE_KERNELS.values():
        k.module.LAUNCHES[k.name] = 0
    placement = probe_radix.probe_placement(PROBE_WORDS, device)
    forms = probe_int8_ops.probe_forms(device, PROBE_FORM_ELEMENTS)
    launches = {name: k.launches for name, k in _PROBE_KERNELS.items()}
    for name, count in launches.items():
        check(count > 0, f"{name}: not launched on the probes' path")
    seconds = time.perf_counter() - t0
    form_turns(device, forms)
    log(f"phase 3: the probes' placement ({PROBE_WORDS} words) and int8 forms"
        f" ({PROBE_FORM_ELEMENTS} elements) in {seconds:.1f} s, launches {launches}")
    return dict(placement=placement, forms=forms, launches=launches, seconds=seconds)


def form_turns(device, forms, iters=50):
    """Each int8 form at the probe's size timed in turns with its library
    call where there is one (CUDA events around ``iters`` calls, and the
    device time of calls queued behind a sleep, kernel_device_ms), and
    with the earlier tree's kernel where $EVQL_PARENT_TREE names one,
    after a check that they agree and a warm-up; added to ``forms`` with
    the seconds it took. Its launches come after the probes' path and
    count on no path."""
    a, b = (torch.from_numpy(x).to(device)
            for x in probe_int8_ops.probe_inputs(PROBE_FORM_ELEMENTS, 12))
    buf = torch.empty_like(a)
    parent = PARENT.get("probes")
    t0 = time.perf_counter()
    for case, res in forms.items():
        mine = kp.int8_form(a, b, case)
        others = {}
        if case in probe_int8_ops.LIBRARY:
            call = probe_int8_ops.LIBRARY[case][1]
            check(torch.equal(call(a, b, buf), mine), f"int8_form [{case}]: library call differs")
            others["library"] = lambda: call(a, b, buf)
        if parent is not None:
            check(torch.equal(parent.int8_form(a, b, case), mine),
                  f"int8_form [{case}]: the earlier kernel and this one disagree")
            others["parent"] = lambda: parent.int8_form(a, b, case)
            res["parent"] = os.environ[PARENT_TREE]
        for name, other in others.items():
            for _ in range(20):
                other()
                kp.int8_form(a, b, case)
            res[f"{name}_turns_ms"], res[f"{name}_turns_new_ms"], res[f"{name}_turns"] = in_turns(
                other, lambda: kp.int8_form(a, b, case), iters)
            res[f"{name}_device_turns"] = [kernel_device_ms(fn) for fn in (
                other, lambda: kp.int8_form(a, b, case), lambda: kp.int8_form(a, b, case), other)]
    log(f"phase 3: the int8 forms timed in turns in {time.perf_counter() - t0:.1f} s")


def probe_kernel_rows(probe, errs):
    """The {"kernels": [...]} rows of place_runs and int8_form from the
    probes' run: place_runs at runs of 256 elements (the others under
    ``other_shapes``), int8_form's first form, timed in turns with its
    library call (the others likewise)."""
    place = probe["placement"][0]
    form_name = kp.INT8_CASES[0]
    form = probe["forms"][form_name]
    common = dict(route="cuda", source="eventql_tpu_torch/kernels/csrc/probes.cu",
                  bound_by="bytes")
    return [
        dict(common, name="place_runs", entry="evql_place_runs",
             replaces="scripts/probe_radix.py:181 (placement; body _placement_kernel :162)",
             launches=probe["launches"]["place_runs"],
             launches_by_path={"probes": probe["launches"]["place_runs"]},
             max_abs_err=errs["place_runs"], ms=place["ms"], plain_ms=place["plain_ms"],
             bound_ms=place["bound_ms"], library_ms=place["library_ms"],
             library="torch.Tensor.index_copy_ of whole runs (int64 run index)",
             shape=f"{PROBE_WORDS} u32 words, runs of {place['run']} elements to a random slot",
             bytes=place["bytes"], ns_per_run=place["ns_per_run"],
             other_shapes={f"runs of {r['run']}": r for r in probe["placement"][1:]}),
        dict(common, name="int8_form", entry="evql_int8_form",
             replaces="scripts/probe_int8_ops.py:20 (run_case :17; bodies k_select_i8 :41,"
                      " k_muli_i8 :49, k_convert_i8 :55, k_select_i8_var :60,"
                      " k_mul_i32_to_i8 :67)",
             launches=probe["launches"]["int8_form"],
             launches_by_path={"probes": probe["launches"]["int8_form"]},
             # ms and library_ms: the turns of form_turns (interleaved, warm);
             # the probe's own first timings beside them
             max_abs_err=errs["int8_form"], ms=form["library_turns_new_ms"],
             plain_ms=form["plain_ms"], bound_ms=form["bound_ms"],
             library_ms=form["library_turns_ms"], library=form["library"],
             probe_ms=form["ms"], probe_library_ms=form["library_ms"],
             **{key: value for key, value in form.items() if "turns" in key},
             shape=f"{PROBE_FORM_ELEMENTS} int32 pairs, {form_name}", bytes=form["bytes"],
             other_shapes={c: f for c, f in probe["forms"].items() if c != form_name}),
    ]


# -- phase 4: the main paths --------------------------------------------------

COLUMNS = [("k", SType.STRING), ("v", SType.UINT64), ("w", SType.UINT64),
           ("cat", SType.INT64), ("big", SType.UINT64), ("ts", SType.UINT64),
           ("dk", SType.UINT64), ("dk2", SType.UINT64)]


def make_table(n, seed):
    """The sql_groupby deployment of the JAX package's bench at
    partition size: a dictionary-encoded string key plus numeric
    columns that narrow to 16 and 32 bits; the sort column of its
    sql_topk deployment, a full-range 64-bit timestamp; and the fact
    keys of its join and join_bigdim deployments: ``dk`` (narrows to 32
    bits; half its rows have no dimension row) and ``dk2`` (64 bits)."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, N_KEYS, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.uint64),
        "w": rng.integers(0, 1 << 20, n).astype(np.uint64),
        "cat": rng.integers(CAT_LO, CAT_HI, n).astype(np.int64),
        "big": (rng.integers(0, BIG_SPAN, n) + BIG_BASE).astype(np.uint64),
        "ts": rng.integers(0, 1 << 63, n, dtype=np.uint64),
        "dk": rng.integers(0, 2 * N_DIMS, n).astype(np.uint64) * DIM_MULT + 3,
        "dk2": rng.integers(0, N_BIG_DIMS, n).astype(np.uint64) * BIG_DIM_MULT + 3,
    }
    dictionary = np.array([b"k%05d" % i for i in range(N_KEYS)], dtype=object)
    return cols, dictionary


def provider_of(cols, dictionary, n):
    ones = np.ones(n, bool)
    rel = relation_from_numpy(
        [name for name, _st in COLUMNS],
        [(st, cols[name][:n], ones, dictionary if st == SType.STRING else None)
         for name, st in COLUMNS],
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


def make_dims(seed):
    """The two dimension tables: name -> (ordinal of each row's key,
    region of each row); row i has the key ordinal * multiplier + 3, the
    rows are in a random order, and ``region`` has N_REGIONS values."""
    rng = np.random.default_rng(seed)
    return {
        name: (rng.permutation(d), rng.integers(0, N_REGIONS, d))
        for name, d in (("d1", N_DIMS), ("d2", N_BIG_DIMS))
    }


def add_dims(provider, dims):
    regions = np.array([b"r%04d" % i for i in range(N_REGIONS)], dtype=object)
    for (name, (ordinal, region)), mult in zip(dims.items(), (DIM_MULT, BIG_DIM_MULT)):
        ones = np.ones(len(ordinal), bool)
        provider.add_table(name, relation_from_numpy(
            ["k", "region"],
            [(SType.UINT64, ordinal.astype(np.uint64) * mult + 3, ones, None),
             (SType.STRING, region.astype(np.int32), ones, regions)],
        ))
    return provider


def _bincounts(key, K, keep, *weights):
    """Independent answer: occupied buckets with count and sums, via
    np.bincount (float64 weights are exact: every sum is below 2^53)."""
    key = key[keep]
    counts = np.bincount(key, minlength=K)
    sums = []
    for w in weights:
        s = np.bincount(key, weights=w[keep].astype(np.float64), minlength=K)
        check(s.max(initial=0) < 2.0**53, "expected sum not exact in float64")
        sums.append(s.astype(np.uint64))
    occ = np.nonzero(counts)[0]
    return occ, counts[occ], [s[occ] for s in sums]


def queries(c, dictionary, cat_lo=CAT_LO):
    """(name, sql, kernel it must launch, fused?, expected rows).
    ``cat_lo`` is the least value ``cat`` may hold (phase 8 stores it
    shifted to start at 0)."""
    names = [d.decode() for d in dictionary]
    k, v, w = c["k"], c["v"], c["w"]
    cat = (c["cat"] - cat_lo).astype(np.int64)
    big = (c["big"] - BIG_BASE).astype(np.int64)
    everything = np.ones(len(k), bool)

    def rows(occ, key_fn, *cols):
        return sorted(
            [key_fn(int(o))] + [str(int(x[i])) for x in cols]
            for i, o in enumerate(occ)
        )

    out = []
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, v < 800, v)
    out.append(("headline",
                "select k, count(1), sum(v) from t where v < 800 group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt, sv)))
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, (v < 100) | (w >= 524288), v)
    out.append(("or_two_columns",
                "select k, count(1), sum(v) from t where v < 100 or w >= 524288"
                " group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt, sv)))
    occ, cnt, _ = _bincounts(k, N_KEYS, everything)
    out.append(("count_only", "select k, count(1) from t group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], cnt)))
    occ, cnt, (sv,) = _bincounts(cat, CAT_HI - CAT_LO, v < 800, v)
    out.append(("numeric_key_base",
                "select cat, count(1), sum(v) from t where v < 800 group by cat;",
                "groupby_agg", True,
                rows(occ, lambda o: str(o + cat_lo), cnt, sv)))
    occ, cnt, (sw,) = _bincounts(big, BIG_SPAN, v < 800, w)
    out.append(("k_100000",
                "select big, count(1), sum(w) from t where v < 800 group by big;",
                "groupby_agg", True,
                rows(occ, lambda o: str(o + BIG_BASE), cnt, sw)))
    occ, cnt, (sv,) = _bincounts(k, N_KEYS, v + w < 500000, v)
    out.append(("mask_form",
                "select k, sum(v) from t where v + w < 500000 group by k;",
                "groupby_agg", True, rows(occ, lambda o: names[o], sv)))
    occ, cnt, (sv, sw) = _bincounts(k, N_KEYS, v < 800, v, w)
    out.append(("multi_sum",
                "select k, sum(v), sum(w), count(1) from t where v < 800"
                " group by k;",
                "groupby_multi_agg", False,
                rows(occ, lambda o: names[o], sv, sw, cnt)))
    return out


def _first_rows(keys, keep, w):
    """Independent answer of ORDER BY ... LIMIT: the first ``w`` rows in
    the ascending lexicographic order of ``keys`` (most significant
    first; ties to the lower row index) among the rows ``keep`` selects.
    A partition finds the w-th smallest leading key, and only the rows
    up to it (all its ties included) are sorted."""
    rows = np.arange(len(keys[0])) if keep is None else np.nonzero(keep)[0]
    lead = keys[0][rows]
    if 0 < w < len(rows):
        rows = rows[lead <= np.partition(lead, w - 1)[w - 1]]
    order = np.lexsort([key[rows] for key in reversed(keys)])  # stable
    return rows[order][:w]


def order_queries(c, dictionary, n):
    """(name, sql, route, fast-path?, launches per run, expected rows in
    order). ``fast-path`` marks a single-key top-k, which takes the two
    histograms once the table has FAST_TOPK_ROWS rows; the heavy-tie
    query overflows the candidate cap there and never extracts."""
    names = [d.decode() for d in dictionary]
    k, v, w, ts = c["k"][:n], c["v"][:n], c["w"][:n], c["ts"][:n]
    fast = n >= FAST_TOPK_ROWS
    hist = {"groupby_agg": 2 if fast else 0}
    none = {}

    def rows(idx, *cols):
        return [[names[int(x[i])] if x is k else str(int(x[i])) for x in cols]
                for i in idx]

    ts_desc = ~ts  # the unsigned complement reverses the order
    out = []
    out.append(("topk_ts_desc",
                "select ts, v from t order by ts desc limit 100;",
                "topk", dict(hist, extract_ge=1 if fast else 0),
                rows(_first_rows([ts_desc], None, 100), ts, v)))
    out.append(("topk_ts_asc_where_offset",
                "select ts, v from t where v < 800 order by ts limit 10 offset 5;",
                "topk", dict(hist, extract_ge=1 if fast else 0),
                rows(_first_rows([ts], v < 800, 15)[5:], ts, v)))
    out.append(("topk_v_desc_ties",
                "select ts, v from t order by v desc limit 100;",
                "topk", hist,
                rows(_first_rows([np.uint64(999) - v], None, 100), ts, v)))
    out.append(("topk_string_then_ts_desc",
                "select k, ts from t order by k, ts desc limit 50;",
                "topk", none,
                rows(_first_rows([k, ts_desc], None, 50), k, ts)))
    keep = (v < 10) & (w < 65536)  # 1 row in 1600: the host emits every kept row
    out.append(("order_ts_where",
                "select ts, v from t where v < 10 and w < 65536 order by ts;",
                "order", none,
                rows(_first_rows([ts], keep, int(keep.sum())), ts, v)))
    return out


def join_queries(c, dims, n):
    """(name, sql, launches per run, expected rows in order, or None for
    the query the host engine must serve). The independent answer undoes
    the key arithmetic: a fact key is ordinal * multiplier + 3, and the
    region of an ordinal is looked up in a table indexed by ordinal.
    The rows come in the order of each region's first surviving row."""
    v, w = c["v"][:n], c["w"][:n]
    region_of = {}
    for (name, (ordinal, region)), slots in zip(dims.items(), (2 * N_DIMS, N_BIG_DIMS)):
        lut = np.full(slots, -1, np.int64)  # ordinals without a row: no match
        lut[ordinal] = region
        region_of[name] = lut
    r1 = region_of["d1"][(c["dk"][:n] - 3) // DIM_MULT]
    r2 = region_of["d2"][(c["dk2"][:n] - 3) // BIG_DIM_MULT]
    check(0.4 < (r1 < 0).mean() < 0.6 and (r2 >= 0).all(),
          "half of dk and all of dk2 should find a dimension row")

    def rows(region, keep, *cols, count_last=False):
        keep = keep & (region >= 0)
        occ, cnt, sums = _bincounts(region, N_REGIONS, keep, *cols)
        # first surviving row per region: every region shows up early
        head = np.nonzero(keep[: 1 << 20])[0]
        seen, first = np.unique(region[head], return_index=True)
        check(len(seen) == len(occ) or n <= (1 << 20),
              "a region has no row in the first 2^20")
        if len(seen) != len(occ):
            seen, first = np.unique(region[keep], return_index=True)
        order = np.argsort(first, kind="stable")
        at = {int(o): i for i, o in enumerate(occ)}
        out = []
        for o in seen[order]:
            i = at[int(o)]
            aggs = [str(int(x[i])) for x in sums]
            count = [str(int(cnt[i]))]
            out.append(["r%04d" % o] + (aggs + count if count_last else count + aggs))
        return out

    everything = np.ones(n, bool)
    agg, multi = "groupby_agg", "groupby_multi_agg"
    return [
        ("join_small_dim",
         "select d1.region, count(1), sum(t.v) from t join d1 on t.dk = d1.k"
         " group by d1.region;",
         {"dim_join_gid": 1, agg: 1}, rows(r1, everything, v)),
        ("join_small_dim_where",
         "select d1.region, count(1), sum(t.w) from t join d1 on t.dk = d1.k"
         " where t.v < 800 group by d1.region;",
         {"dim_join_gid": 1, agg: 1}, rows(r1, v < 800, w)),
        ("join_small_dim_two_sums",
         "select d1.region, sum(t.v), sum(t.w), count(1) from t join d1 on"
         " t.dk = d1.k group by d1.region;",
         {"dim_join_gid": 1, multi: 1}, rows(r1, everything, v, w, count_last=True)),
        ("join_big_dim",
         "select d2.region, count(1), sum(t.v) from t join d2 on t.dk2 = d2.k"
         " group by d2.region;",
         {"probe_join_gid": 1, agg: 1}, rows(r2, everything, v)),
        (J1[0], J1[1], {"dim_join_gid": 1, "hash_groupby": 1},
         join_min_max_rows(r1, v, w)),
    ]


# the general GROUP BY path: every plan the bounded route declines
GENERAL_SQL = {
    "G1_min_max_mean": "select k, min(v), max(w), mean(v) from t where v < 800 group by k;",
    "G2_key_beyond_k_cap": "select w, count(1), sum(v) from t group by w;",
    "G3_two_keys": "select k, cat, count(1), max(ts) from t group by k, cat;",
    "G4_count_distinct": "select k, count_distinct(v) from t group by k;",
    "G5_float_sums": "select cat, sum(v / 64), mean(w) from t group by cat;",
}
# the general GROUP BY where few of a key's slots hold a group: the WHERE
# keeps about 1 row in 10^4, so that w's 2^20 slots hold under 1 % of
# groups; G6 in the direct global tier (w's stored span), G7 in the hash
# tier (a computed key has no span)
SPARSE_WHERE = f"big < {BIG_BASE + 10}"
COMPACTION_SQL = {
    "G6_sparse_span": f"select w, count(1), sum(v) from t where {SPARSE_WHERE} group by w;",
    "G7_hash_tier": f"select w + 1, count(1), sum(v) from t where {SPARSE_WHERE}"
                    " group by w + 1;",
}
# the join route's general branch (min / max after the small-table probe)
J1 = ("join_min_max",
      "select d1.region, min(t.v), max(t.w) from t join d1 on t.dk = d1.k"
      " group by d1.region;")


def _first_rows_of(group, G):
    """Per group id in [0, G): its first row (n where it has none)."""
    n = len(group)
    first = np.full(G, n, np.int64)
    np.minimum.at(first, group, np.arange(n, dtype=np.int64))
    return first


def general_queries(c, dictionary, n, cat_lo=CAT_LO):
    """(name, sql, expected rows in order): independent numpy answers,
    groups in the order of their first rows, floats as the port prints
    them ("%f"; every sum here is exact in float64). ``cat_lo`` as in
    ``queries``."""
    names = np.array([d.decode() for d in dictionary], dtype=object)
    k, v, w, ts = c["k"][:n], c["v"][:n], c["w"][:n], c["ts"][:n]
    cat = (c["cat"][:n] - cat_lo).astype(np.int64)

    def ordered(first, *cols):
        occ = np.nonzero(first < n)[0]
        occ = occ[np.argsort(first[occ], kind="stable")]
        return [list(r) for r in zip(*(col(occ) for col in cols))]

    def num(a):
        return lambda occ: a[occ].astype(str).tolist()

    def flt(a):
        return lambda occ: ["%f" % x for x in a[occ]]

    out = []
    keep = v < 800
    kk = np.where(keep, k, N_KEYS)  # dropped rows in a spare group
    mn = np.full(N_KEYS + 1, 1 << 20, np.uint64)
    mx = np.zeros(N_KEYS + 1, np.uint64)
    np.minimum.at(mn, kk, v)
    np.maximum.at(mx, kk, w)
    cnt = np.bincount(kk, minlength=N_KEYS + 1)
    sv = np.bincount(kk, weights=v.astype(np.float64), minlength=N_KEYS + 1)
    first = _first_rows_of(kk, N_KEYS + 1)
    first[N_KEYS] = n
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = sv / cnt
    out.append(("G1_min_max_mean", ordered(
        first, lambda o: names[o].tolist(), num(mn), num(mx), flt(mean))))
    W = 1 << 20
    wi = w.astype(np.int64)
    out.append(("G2_key_beyond_k_cap", ordered(
        _first_rows_of(wi, W), lambda o: o.astype(str).tolist(),
        num(np.bincount(wi, minlength=W)),
        num(np.bincount(wi, weights=v.astype(np.float64), minlength=W).astype(np.uint64)))))
    pair = k.astype(np.int64) * (CAT_HI - CAT_LO) + cat
    P = N_KEYS * (CAT_HI - CAT_LO)
    tmax = np.zeros(P, np.uint64)
    np.maximum.at(tmax, pair, ts)
    out.append(("G3_two_keys", ordered(
        _first_rows_of(pair, P), lambda o: names[o // (CAT_HI - CAT_LO)].tolist(),
        lambda o: (o % (CAT_HI - CAT_LO) + cat_lo).astype(str).tolist(),
        num(np.bincount(pair, minlength=P)), num(tmax))))
    seen = np.zeros((N_KEYS, 1000), bool)
    seen[k, v] = True
    out.append(("G4_count_distinct", ordered(
        _first_rows_of(k, N_KEYS), lambda o: names[o].tolist(), num(seen.sum(1)))))
    C = CAT_HI - CAT_LO
    ccount = np.bincount(cat, minlength=C)
    sv = np.bincount(cat, weights=v.astype(np.float64), minlength=C)
    sw = np.bincount(cat, weights=w.astype(np.float64), minlength=C)
    with np.errstate(invalid="ignore", divide="ignore"):
        out.append(("G5_float_sums", ordered(
            _first_rows_of(cat, C), lambda o: (o + cat_lo).astype(str).tolist(),
            flt(sv / 64), flt(sw / ccount))))
    return [(name, GENERAL_SQL[name], rows) for name, rows in out]


def compaction_queries(c, n):
    """(name, sql, expected rows in order) of COMPACTION_SQL: independent
    numpy answers, groups in the order of their first rows."""
    rows = np.nonzero(c["big"][:n] < BIG_BASE + 10)[0]
    w, v = c["w"][:n][rows].astype(np.int64), c["v"][:n][rows]
    uniq, first, inv = np.unique(w, return_index=True, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq))
    sums = np.bincount(inv, weights=v.astype(np.float64), minlength=len(uniq))
    order = np.argsort(first, kind="stable")
    out = []
    for name, shift in (("G6_sparse_span", 0), ("G7_hash_tier", 1)):
        out.append((name, COMPACTION_SQL[name],
                    [[str(int(uniq[o]) + shift), str(int(counts[o])), str(int(sums[o]))]
                     for o in order]))
    return out


def join_min_max_rows(region, v, w):
    """J1's independent answer: per region of a row's dimension row
    (-1: none), min(v) and max(w), regions in the order of their first
    rows."""
    n = len(region)
    keep = region >= 0
    r = np.where(keep, region, N_REGIONS)
    mn = np.full(N_REGIONS + 1, 1 << 20, np.uint64)
    mx = np.zeros(N_REGIONS + 1, np.uint64)
    np.minimum.at(mn, r, v)
    np.maximum.at(mx, r, w)
    first = _first_rows_of(r, N_REGIONS + 1)
    first[N_REGIONS] = n
    occ = np.nonzero(first < n)[0]
    occ = occ[np.argsort(first[occ], kind="stable")]
    return [["r%04d" % o, str(int(mn[o])), str(int(mx[o]))] for o in occ]


# the tier (and count_distinct form) each general query's hash_groupby
# call takes: the spans of a dictionary, of cached min / max, of a join's
# buckets
GENERAL_TIERS = {
    "G1_min_max_mean": {"shared": 1},
    "G2_key_beyond_k_cap": {"global": 1},
    "G3_two_keys": {"global": 1},
    "G4_count_distinct": {"shared": 1, "bitmap_shared": 1},
    "G5_float_sums": {"shared": 1},
    "G6_sparse_span": {"global": 1},
    "G7_hash_tier": {"hash": 1},
    J1[0]: {"shared": 1},
}


def general_path(rt, full, qs, reps):
    """The general GROUP BY path at full size: rows and their order must
    equal the numpy answer, the route counter rise once a run, and each
    run launch the hash aggregate once, in the tier GENERAL_TIERS names.
    Returns (e2e, launches per query, the last run's kernel calls per
    query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, expected in qs:
        forms = dict(hg.FORMS)
        before = launch_counts()
        route0 = device_exec.GENERAL_GROUPBY_COUNT
        reads0, bytes0 = ksort.READBACKS, ksort.READBACK_BYTES
        torch.cuda.reset_peak_memory_stats()
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        peak = torch.cuda.max_memory_allocated()
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the numpy answer")
        check(device_exec.GENERAL_GROUPBY_COUNT - route0 == reps,
              f"{name}: general route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * (k == "hash_groupby") for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps and [c[0] for c in recorded] == ["hash_groupby"],
              f"{name}: recorded calls")
        took = {k: c // reps for k, c in _forms_since(forms).items()}
        check(took == GENERAL_TIERS[name], f"{name}: tiers {took}, expected"
              f" {GENERAL_TIERS[name]}")
        calls[name] = recorded
        launches_by_query[name] = {"hash_groupby": 1}
        e2e[name] = _e2e(times, groups=len(got), tier=took, peak_bytes=peak,
                         readbacks=(ksort.READBACKS - reads0) // reps,
                         readback_bytes=(ksort.READBACK_BYTES - bytes0) // reps)
    return e2e, launches_by_query, calls


def run_query(rt, provider, sql):
    txn = rt.new_transaction(provider)
    return rt.build_query_plan(txn, sql).execute(0)


class _RecordedCalls:
    """While active, the kernel wrappers of the port keep a record of
    the keyword form of each call and then run as they are, so that
    phase 5 can repeat exactly what the routes asked of each kernel."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        for name, k in _KERNELS.items():
            setattr(k.module, name, self._recording(name, k.wrapper))
        return self

    def __exit__(self, *exc):
        for name, k in _KERNELS.items():
            setattr(k.module, name, k.wrapper)

    def _recording(self, name, wrapper):
        sig = inspect.signature(wrapper)

        def call(*args, **kwargs):
            self.calls.append((name, dict(sig.bind(*args, **kwargs).arguments)))
            return wrapper(*args, **kwargs)

        return call


def _timed_runs(rt, provider, sql, reps):
    """Run the query ``reps`` times; returns the last ResultList, the
    wall times (each ends in a synchronise), the number of kernel calls
    in all runs and the recorded calls of the last run (earlier records
    are dropped at once: they would keep every run's tensors alive)."""
    times, n_calls = [], 0
    with _RecordedCalls() as rec:
        for _ in range(reps):
            rec.calls.clear()
            t = time.perf_counter()
            res = run_query(rt, provider, sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            n_calls += len(rec.calls)
    return res, times, n_calls, rec.calls


def _e2e(times, **more):
    # warm = every run after the first (columns on the card, plan cached)
    return dict(first_ms=times[0], warm_ms_median=statistics.median(times[1:]),
                warm_ms_min=min(times[1:]), **more)


def groupby_path(rt, full, qs, reps):
    """The GROUP BY sum/count path at full size. Returns (e2e, launches
    per query, the last run's kernel call per query)."""
    fused0 = device_exec.FUSED_GROUPBY_COUNT
    multi0 = device_exec.MULTI_SUM_GROUPBY_COUNT
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, kernel, fused, expected in qs:
        before = launch_counts()
        f_before = device_exec.FUSED_GROUPBY_COUNT
        m_before = device_exec.MULTI_SUM_GROUPBY_COUNT
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        check(n_calls == reps and [c[0] for c in recorded] == [kernel],
              f"{name}: expected {reps} calls of {kernel}")
        calls[name] = recorded[0]
        got = sorted(res.rows)
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows differ from the numpy answer")
        check(device_exec.FUSED_GROUPBY_COUNT - f_before == (reps if fused else 0),
              f"{name}: fused route counter")
        check(device_exec.MULTI_SUM_GROUPBY_COUNT - m_before
              == (0 if fused else reps), f"{name}: multi-sum route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        check(delta[kernel] == reps and sum(delta.values()) == reps,
              f"{name}: expected {reps} launches of {kernel}, got {delta}")
        launches_by_query[name] = {kernel: delta[kernel] // reps}
        e2e[name] = _e2e(times, groups=len(got))
    check(device_exec.FUSED_GROUPBY_COUNT > fused0, "fused route never taken")
    check(device_exec.MULTI_SUM_GROUPBY_COUNT > multi0, "multi-sum route never taken")
    return e2e, launches_by_query, calls


def order_path(rt, full, qs, reps):
    """The ORDER BY [LIMIT] path at full size: rows AND their order must
    equal the numpy answer. Returns (e2e, launches per query, the last
    run's kernel calls per query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, route, per_run, expected in qs:
        before = launch_counts()
        topk0, order0 = device_exec.SCAN_TOPK_COUNT, device_exec.SCAN_ORDER_COUNT
        reads0 = ksort.READBACKS
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} rows, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the"
              " numpy answer")
        check(device_exec.SCAN_TOPK_COUNT - topk0 == (reps if route == "topk" else 0)
              and device_exec.SCAN_ORDER_COUNT - order0
              == (reps if route == "order" else 0), f"{name}: route counters")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * per_run.get(k, 0) for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps * sum(per_run.values())
              and len(recorded) == sum(per_run.values()), f"{name}: recorded calls")
        calls[name] = recorded
        launches_by_query[name] = {k: c for k, c in per_run.items() if c}
        e2e[name] = _e2e(times, rows=len(got),
                         readbacks=(ksort.READBACKS - reads0) // reps)
    return e2e, launches_by_query, calls


def join_path(rt, full, qs, reps):
    """The fact-dim JOIN + GROUP BY path at full size: rows and their
    order must equal the numpy answer. Returns (e2e, launches per query,
    the last run's kernel calls per query)."""
    e2e, launches_by_query, calls = {}, {}, {}
    for name, sql, per_run, expected in qs:
        if expected is None:
            continue  # the host engine's: run on the prefix only
        forms = dict(hg.FORMS)
        before = launch_counts()
        route0 = device_exec.JOIN_GROUPBY_COUNT
        reads0 = ksort.READBACKS
        res, times, n_calls, recorded = _timed_runs(rt, full, sql, reps)
        got = res.rows
        check(len(got) == len(expected),
              f"{name}: {len(got)} groups, expected {len(expected)}")
        check(got == expected, f"{name}: rows or their order differ from the"
              " numpy answer")
        check(device_exec.JOIN_GROUPBY_COUNT - route0 == reps,
              f"{name}: join route counter")
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = {k: reps * per_run.get(k, 0) for k in after}
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        check(n_calls == reps * len(per_run)
              and [c[0] for c in recorded] == list(per_run), f"{name}: recorded calls")
        took = {k: c // reps for k, c in _forms_since(forms).items()}
        check(took == GENERAL_TIERS.get(name, {}), f"{name}: tiers {took}")
        calls[name] = recorded
        launches_by_query[name] = dict(per_run)
        e2e[name] = _e2e(times, groups=len(got),
                         readbacks=(ksort.READBACKS - reads0) // reps,
                         **({"tier": took} if took else {}))
    return e2e, launches_by_query, calls


def phase_main_path(device, n, n_prefix, reps):
    """Both paths of the port at ``n`` rows, then both on the prefix
    against the host engine. Returns a dict: launches (per kernel, the
    paths' counts added), launches_by_path, per_query, e2e, calls
    (query -> list of (kernel, kwargs)), resident bytes, program_by_path
    (the expression program's launches and fallbacks on each path)."""
    t0 = time.perf_counter()
    cols, dictionary = make_table(n, seed=42)
    dims = make_dims(seed=43)
    full = add_dims(provider_of(cols, dictionary, n), dims)
    prefix = add_dims(provider_of(cols, dictionary, n_prefix), dims)
    gqs = queries(cols, dictionary)
    oqs = order_queries(cols, dictionary, n)
    jqs = join_queries(cols, dims, n)
    hqs = general_queries(cols, dictionary, n)
    cqs = compaction_queries(cols, n)
    log(f"phase 4: table of {n} rows and expected answers made in"
        f" {time.perf_counter() - t0:.1f} s")

    rt = Runtime(plan_cache=PlanCache(), device=device)
    host_rt = Runtime(device=None)
    plain_rt = Runtime(device="cpu")

    zero_launch_counts()
    zero_program_counts()
    g_e2e, g_per_query, g_calls = groupby_path(rt, full, gqs, reps)
    g_launches = launch_counts()
    g_program = program_counts()
    for name in ("groupby_agg", "groupby_multi_agg"):
        check(g_launches[name] > 0, f"{name}: not launched on the GROUP BY path")
    log(f"phase 4: {len(gqs)} GROUP BY queries x {reps} equal to numpy at {n}"
        f" rows; launches {g_launches}")

    zero_launch_counts()
    zero_program_counts()
    h_e2e, h_per_query, h_calls = general_path(rt, full, hqs + cqs, reps)
    h_launches = launch_counts()
    h_program = program_counts()
    for name, e in h_e2e.items():
        log(f"phase 4: {name}: {e['groups']} groups ({e['tier']}), a run reads back"
            f" {e['readback_bytes']} bytes in {e['readbacks']} copies; warm"
            f" {e['warm_ms_median']:.3f} ms, first {e['first_ms']:.3f} ms")
    peak = max(e["peak_bytes"] for e in h_e2e.values())
    check(h_launches["hash_groupby"] > 0, "hash_groupby: not launched on the general path")
    total = torch.cuda.get_device_properties(device).total_memory
    check(peak < total // 2, f"general path: peak {peak} bytes of {total}")
    log(f"phase 4: {len(hqs + cqs)} general GROUP BY queries x {reps} equal to numpy at {n}"
        f" rows, in order; launches {h_launches}")

    zero_launch_counts()
    zero_program_counts()
    o_e2e, o_per_query, o_calls = order_path(rt, full, oqs, reps)
    o_launches = launch_counts()
    o_program = program_counts()
    if n >= FAST_TOPK_ROWS:
        for name in ("groupby_agg", "extract_ge"):
            check(o_launches[name] > 0, f"{name}: not launched on the ORDER BY path")
    log(f"phase 4: {len(oqs)} ORDER BY queries x {reps} equal to numpy at {n}"
        f" rows, in order; launches {o_launches}")

    zero_launch_counts()
    zero_program_counts()
    j_e2e, j_per_query, j_calls = join_path(rt, full, jqs, reps)
    j_launches = launch_counts()
    j_program = program_counts()
    for name in ("dim_join_gid", "probe_join_gid", "groupby_agg", "groupby_multi_agg"):
        check(j_launches[name] > 0, f"{name}: not launched on the JOIN path")
    # probe_join_gid is two device functions: every probe had its table built
    table_builds = kj.LAUNCHES["build_join_table"]
    check(table_builds == j_launches["probe_join_gid"],
          f"{table_builds} table builds for {j_launches['probe_join_gid']} probes")
    log(f"phase 4: {len(j_e2e)} JOIN + GROUP BY queries x {reps} equal to numpy at"
        f" {n} rows, in order; launches {j_launches}")

    # bytes of the table's columns as the column cache holds them
    resident = sum(
        t.numel() * t.element_size()
        for c in full.get_table_data("t").columns
        for t in c._device_cache[str(device)]
    )
    check(resident > n * 34, "the table is not resident on the device")
    log(f"phase 4: device memory held {resident} bytes; peak allocated on the general"
        f" GROUP BY path {peak} bytes of {total}")

    # the same queries on a prefix: device routes against the host engine
    for name, sql, *_rest in gqs:
        a = sorted(run_query(rt, prefix, sql).rows)
        b = sorted(run_query(host_rt, prefix, sql).rows)
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
    for name, sql, *_rest in oqs:
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
    for name, sql, _rows in hqs + cqs:
        route0 = device_exec.GENERAL_GROUPBY_COUNT
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
        plain = name in COMPACTION_SQL
        if plain:  # the same route on the CPU device: its plain version
            check(run_query(plain_rt, prefix, sql).rows == a,
                  f"{name}: device route and its plain version differ on the prefix")
        check(device_exec.GENERAL_GROUPBY_COUNT - route0 == 1 + plain,
              f"{name}: general route counter on the prefix")
    for name, sql, per_run, expected in jqs:
        route0 = device_exec.JOIN_GROUPBY_COUNT
        a = run_query(rt, prefix, sql).rows
        b = run_query(host_rt, prefix, sql).rows
        check(a == b and len(a) > 0,
              f"{name}: device route and host engine differ on the prefix")
        check(device_exec.JOIN_GROUPBY_COUNT - route0 == (expected is not None),
              f"{name}: join route counter on the prefix")
    log(f"phase 4: {len(gqs) + len(hqs + cqs) + len(oqs) + len(jqs)} queries equal to the"
        f" host engine at {n_prefix} rows; {len(cqs)} also to their route's plain version")
    # the counts as read after each path's full-size queries: the prefix
    # runs above and phase 5 launch too, and are not the main path
    return dict(
        launches={k: g_launches[k] + h_launches[k] + o_launches[k] + j_launches[k]
                  for k in g_launches},
        launches_by_path={"group_by": g_launches, "general_group_by": h_launches,
                          "order_by": o_launches, "join": j_launches},
        per_query={**g_per_query, **h_per_query, **o_per_query, **j_per_query},
        e2e={**g_e2e, **h_e2e, **o_e2e, **j_e2e},
        calls={**{q: [c] for q, c in g_calls.items()}, **h_calls, **o_calls, **j_calls},
        resident=resident,
        peak_general=peak,
        # the expression program's launches and fallbacks, read as the
        # kernels' are
        program_by_path={"group_by": g_program, "general_group_by": h_program,
                         "order_by": o_program, "join": j_program},
        # what phases 6 and 10 run again (over the mesh, over the wire)
        tables=dict(full=full, rt=rt, gqs=gqs, hqs=hqs, cqs=cqs, oqs=oqs, jqs=jqs, cols=cols,
                    dictionary=dictionary, dims=dims),
    )


# -- phase 4b: the expression program ---------------------------------------------

# TPC-H Q1 and Q6 as gpubench/traffic sends them, with one parameter set each
# (DELTA 90 days; 1994, DISCOUNT 0.06, QUANTITY 24)
BENCH_EXPR_QUERIES = {
    "tpch_q1": ("select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,"
                " sum(l_extendedprice) as sum_base_price, sum(l_extendedprice * (100 -"
                " l_discount)) as sum_disc_price, sum(l_extendedprice * (100 - l_discount) *"
                " (100 + l_tax)) as sum_charge, mean(l_quantity) as avg_qty,"
                " mean(l_extendedprice) as avg_price, mean(l_discount) as avg_disc, count(1)"
                " as count_order from lineitem where l_shipdate <= 10471 group by"
                " l_returnflag, l_linestatus order by l_returnflag, l_linestatus;", 6),
    "tpch_q6": ("select sum(l_extendedprice * l_discount) as revenue from lineitem where"
                " l_shipdate >= 8766 and l_shipdate < 9131 and l_discount >= 5 and"
                " l_discount <= 7 and l_quantity < 24;", 2),
}


def _words(t):
    """A result plane as comparable words: floats by their bits, every NaN
    as one word; integers and bools as they are."""
    if t.dtype != torch.float64:
        return t
    w = t.view(torch.int64).clone()
    w[torch.isnan(t)] = 0x7FF8000000000000
    return w


class _CheckedPrograms:
    """While active, each expression a route evaluates
    (torch_expr.compile_expr) runs as it does, then on the PyTorch path
    (torch_expr.compile_torch) over the same columns; the two must be
    equal bit for bit, validity included. What the rule predicts
    (torch_expr.program_for: a launch, the stored column itself, or the
    PyTorch path) is held against the counters' movement in that call.
    ``tally``: query name -> launches, fallbacks, stored, instructions."""

    def __init__(self):
        self.tally, self.query = {}, None

    def __enter__(self):
        self.real = torch_expr.compile_expr
        torch_expr.compile_expr = self._checked
        return self

    def __exit__(self, *exc):
        torch_expr.compile_expr = self.real

    def _checked(self, expr, columns, n, device=None):
        prog = torch_expr.program_for(expr, columns)
        before = program_counts()
        got = self.real(expr, columns, n, device)
        after = program_counts()
        moved = (after["launches"] - before["launches"], after["fallbacks"] - before["fallbacks"])
        if prog is None:
            kind, want_moved = "fallbacks", (0, 1)
        elif prog.identity is not None:
            kind, want_moved = "stored", (0, 0)
        else:
            kind, want_moved = "launches", (int(n > 0), 0)
        what = f"phase 4b: {self.query}: {expr}"
        check(moved == want_moved, f"{what}: counters moved {moved}, the rule predicts {kind}")
        want = torch_expr.compile_torch(expr, columns, n, device)
        g, w = got.full(n), want.full(n)
        check(got.stype == want.stype and g.data.dtype == w.data.dtype
              and g.data.shape == w.data.shape == (n,),
              f"{what}: type or shape differs from the PyTorch path")
        diff = int((_words(g.data) != _words(w.data)).sum()) + int((g.valid != w.valid).sum())
        check(diff == 0, f"{what}: {diff} words differ from the PyTorch path")
        t = self.tally.setdefault(self.query,
                                  dict(launches=0, fallbacks=0, stored=0, instructions=0))
        t[kind] += want_moved[0] if kind == "launches" else 1
        t["instructions"] += prog.ops if kind == "launches" else 0
        del want, g, w
        return got


def lineitem_provider(n, seed):
    """TPC-H LINEITEM's seven columns of Q1 and Q6 at n rows, drawn
    uniformly over the spans of gpubench/configs/tpch_sf10_lineitem.json
    (probe_expr_program.SPANS), so that the column cache stores them as the
    benchmark's: u16 quantity, discount, tax and ship date, u32 price."""
    rng = np.random.default_rng(seed)
    ones = np.ones(n, bool)
    names = list(probe_expr_program.SPANS)
    spec = [(SType.UINT64, rng.integers(lo, hi + 1, n).astype(np.uint64), ones, None)
            for lo, hi in probe_expr_program.SPANS.values()]
    for name, values in (("l_returnflag", (b"A", b"N", b"R")), ("l_linestatus", (b"F", b"O"))):
        names.append(name)
        spec.append((SType.STRING, rng.integers(0, len(values), n).astype(np.int32), ones,
                     np.array(values, dtype=object)))
    p = RelationTableProvider()
    p.add_table("lineitem", relation_from_numpy(names, spec))
    return p


def phase_expr_program(device, run, reps):
    """The expression program on the main paths and the benchmark's TPC-H
    queries, checked against its plain version (the PyTorch path), and
    the kernel alone for its {"kernels": [...]} row. Returns its numbers."""
    t0 = time.perf_counter()
    tables = run["tables"]
    paths = {"group_by": tables["gqs"], "general_group_by": tables["hqs"] + tables["cqs"],
             "order_by": tables["oqs"],
             # phase 4 runs the join queries the route serves (the others on the prefix)
             "join": [q for q in tables["jqs"] if q[3] is not None]}
    with _CheckedPrograms() as chk:
        for path, qs in paths.items():
            for name, sql, *_rest in qs:
                chk.query = name
                run_query(tables["rt"], tables["full"], sql)
    by_path = {}
    for path, qs in paths.items():
        tally = {k: sum(chk.tally.get(q[0], {}).get(k, 0) for q in qs)
                 for k in ("launches", "fallbacks", "stored")}
        main = run["program_by_path"][path]
        want = {k: reps * tally[k] for k in ("launches", "fallbacks")}
        check(main == want, f"phase 4b: {path}: phase 4 counted {main}; {reps} runs of its"
                            f" queries make {want}")
        by_path[path] = dict(main, checked=tally)
    check(sum(p["launches"] for p in by_path.values()) > 0,
          "expr_program: not launched on a main path")
    log(f"phase 4b: every expression of phase 4's queries equal to the PyTorch path; the"
        f" program's launches / fallbacks on each path {by_path}")

    n = N_ROWS
    provider = lineitem_provider(n, seed=44)
    rt = Runtime(plan_cache=PlanCache(), device=device)
    bench = {}
    for name, (sql, launches) in BENCH_EXPR_QUERIES.items():
        run_query(rt, provider, sql)  # uploads the columns and builds the programs
        zero_program_counts()
        for _ in range(reps):
            run_query(rt, provider, sql)
        steady = program_counts()
        check(steady == {"launches": reps * launches, "fallbacks": 0},
              f"phase 4b: {name}: {steady} over {reps} runs; expected {launches} launches a"
              f" query and no fallback")
        with _CheckedPrograms() as chk:
            chk.query = name
            got = run_query(rt, provider, sql).rows
        tally = chk.tally[name]
        check((tally["launches"], tally["fallbacks"]) == (launches, 0),
              f"phase 4b: {name}: checked {tally}")
        real = torch_expr.compile_expr
        torch_expr.compile_expr = torch_expr.compile_torch
        try:
            plain = run_query(rt, provider, sql).rows
        finally:
            torch_expr.compile_expr = real
        check(got == plain and len(got) > 0,
              f"phase 4b: {name}: rows differ from the plain version's")
        bench[name] = dict(steady, checked=tally, rows=len(got))
    del provider, rt
    log(f"phase 4b: TPC-H Q1 and Q6 over {n} LINEITEM rows: {bench}")

    zero_program_counts()
    probe = probe_expr_program.probe(device, n)
    probe["launches"] = program_counts()["launches"]
    seconds = time.perf_counter() - t0
    log(f"phase 4b: the kernel alone at {n} rows: "
        + "; ".join(f"{k} {c['ms']:.5f} ms (bound {c['bound_ms']:.5f}, PyTorch path"
                    f" {c['plain_ms']:.5f})" for k, c in probe["cases"].items())
        + f"; {seconds:.1f} s in all")
    return dict(by_path=by_path, bench=bench, probe=probe, seconds=seconds)


def expr_program_row(expr_run):
    """The {"kernels": [...]} row of the expression program: launches from
    phase 4's runs (by path), the TPC-H queries' runs and the probe's; its
    time, plain version's and bound at Q1's charge product (2^26 rows),
    the probe's other expressions under ``other_shapes``."""
    probe = expr_run["probe"]
    head_name = "q1_charge"
    head = probe["cases"][head_name]
    launches_by_path = {p: c["launches"] for p, c in expr_run["by_path"].items()}
    launches_by_path["tpch_q1_q6"] = sum(b["launches"] + b["checked"]["launches"]
                                         for b in expr_run["bench"].values())
    launches_by_path["probe"] = probe["launches"]
    return dict(
        name="expr_program", route="cuda",
        source="eventql_tpu_torch/kernels/csrc/expr_program.cu", entry="evql_expr_program",
        replaces="no TPU kernel: exec/torch_expr.py's PyTorch passes, one a node (the JAX"
                 " package left each expression to XLA, which fused it)",
        launches=sum(launches_by_path.values()), launches_by_path=launches_by_path,
        fallbacks_by_path={p: c["fallbacks"] for p, c in expr_run["by_path"].items()},
        # every result of phase 4b was checked equal (tolerance 0) before this row
        max_abs_err=0, ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None,
        library="none: no single library call evaluates an expression tree",
        shape=f"{probe['n']} rows, {head['expr']} over {head['streams']}, int64 out",
        bytes=head["bytes"], instructions=head["ops"],
        other_shapes={k: c for k, c in probe["cases"].items() if k != head_name},
        bench_queries=expr_run["bench"])


# -- phase 5: the main paths' shapes, checked and timed -------------------------


def _streams_of(kw):
    """(role, tensor) of every stream a recorded call reads, each
    tensor once (a "value" predicate rereads the value stream)."""
    named = [("key", kw["gid"]), ("value", kw.get("values")),
             ("mask", kw.get("mask"))]
    named += [("value", t) for t in kw.get("streams", ())]
    named += [("pred", p.stream) for p in kw.get("preds", ())]
    seen, out = set(), []
    for role, t in named:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append((role, t))
    return out


def _bound(nbytes, nops, shape):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=shape)


def bound_of(kw):
    """Least time for the call: every stream read once at its stored
    width and the tables written once, over the memory rate; against
    the compares, base subtract, bound check and adds over the ALU rate."""
    n, K = kw["n"], kw["num_buckets"]
    streams = _streams_of(kw)
    tables = 1 + len(kw.get("streams", ())) + (kw.get("values") is not None)
    nbytes = n * sum(t.element_size() for _r, t in streams) + tables * K * 8
    nops = n * (2 + len(kw.get("preds", ())) + ("mask" in dict(streams)) + tables)
    shape = f"n={n} K={K} " + " ".join(
        f"{r}={str(t.dtype).split('.')[-1]}" for r, t in streams)
    return _bound(nbytes, nops, shape)


def check_and_time(kernel, label, kw, iters):
    """Hold the wrapper against the plain version on exactly these
    arguments (tolerance 0), then time both."""
    wrapper, plain = _KERNELS[kernel].wrapper, _KERNELS[kernel].plain
    got, want = wrapper(**kw), plain(**kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel} [{label}]: shape/dtype differ from the plain version")
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          f"{kernel} [{label}]: kernel and plain version disagree at the"
          f" main path's shape (max |diff| {err})")
    check(int(got[0].sum()) > 0, f"{kernel} [{label}]: nothing counted")
    del got, want
    out = dict(max_abs_err=float(err),
               ms=cuda_ms(lambda: wrapper(**kw), iters),
               plain_ms=cuda_ms(lambda: plain(**kw), 2, warmup=1))
    out.update(bound_of(kw))
    return out


def check_and_time_extract(label, kw, iters):
    """extract_ge on a recorded call: equal to the plain version
    (tolerance 0), then timed beside torch.nonzero, the one library call
    that compacts (it returns every match as int64 and is not capped)."""
    values, threshold, cap = kw["values"], kw["threshold"], kw["cap"]
    rows = kw.get("n")
    got = ex.extract_ge(values, threshold, cap, rows)
    want = ex.extract_ge_plain(values, threshold, cap, rows)
    torch.cuda.synchronize()
    kept = check_extract(label, got, want, values, threshold, cap, rows)
    check(kept > 0, f"extract_ge [{label}]: no candidate on the main path")
    err = int((got - want).abs().max())
    del got, want
    n = values.shape[0] if rows is None else rows
    out = dict(
        max_abs_err=float(err), candidates=kept,
        ms=cuda_ms(lambda: ex.extract_ge(values, threshold, cap, rows), iters),
        plain_ms=cuda_ms(
            lambda: ex.extract_ge_plain(values, threshold, cap, rows), 5, warmup=1),
        library_ms=cuda_ms(
            lambda: torch.nonzero(values[:n] >= threshold), 5, warmup=1),
        library="torch.nonzero(values >= threshold) (int64 indices, no cap)",
    )
    # the values read once, the cap indices written once; one compare a row
    out.update(_bound(4 * n + 4 * cap, n, f"n={n} cap={cap} values=int32"))
    if "extract" in PARENT:  # the earlier kernel on the same arguments, in turns
        earlier = PARENT["extract"].extract_ge
        check(torch.equal(earlier(values, threshold, cap, rows),
                          ex.extract_ge(values, threshold, cap, rows)),
              f"extract_ge [{label}]: the earlier kernel and this one disagree")
        out["parent_ms"], out["turns_new_ms"], out["turns_ms"] = in_turns(
            lambda: earlier(values, threshold, cap, rows),
            lambda: ex.extract_ge(values, threshold, cap, rows), iters)
        out["parent"] = os.environ[PARENT_TREE]
    return out


def check_and_time_join(kernel, label, kw, iters):
    """A join probe on a recorded call (the dimension side unsorted, as
    the route hands it over): equal to the plain version (tolerance 0),
    then timed beside the chain of library calls that does the same on
    keys made ready beforehand (widened to int64 with the top bit
    flipped, the dimension side sorted): no single PyTorch call computes
    the probe. For probe_join_gid the time covers both of its device
    functions, the table build and the probe; the build is also timed
    alone."""
    wrapper, plain = _KERNELS[kernel].wrapper, _KERNELS[kernel].plain
    got, want = wrapper(**kw), plain(**kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.int32,
          f"{kernel} [{label}]: shape/dtype differ from the plain version")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(torch.equal(got, want),
          f"{kernel} [{label}]: kernel and plain version disagree at the main"
          f" path's shape ({int((got != want).sum())} rows)")
    hits = int((got >= 0).sum())
    check(hits > 0, f"{kernel} [{label}]: no fact row found its dimension row")
    del got, want

    facts, n = kw["fact_keys"], kw["n"]
    n = facts.shape[0] if n is None else n
    sk, perm = kj.build_side(kw["dim_keys"])
    bucket = kw["dim_bucket"][perm].contiguous()
    D = sk.shape[0]
    flip = -(1 << 63)
    sk_f, pk = sk ^ flip, kj._u64_bits(facts[:n])
    pk_f = pk ^ flip

    def chain():
        pos = torch.searchsorted(sk_f, pk_f).clamp_(max=D - 1)
        return torch.where(sk[pos] == pk, bucket[pos], -1)

    check(torch.equal(chain().to(torch.int32), wrapper(**kw)),
          f"{kernel} [{label}]: the library chain disagrees")
    out = dict(
        max_abs_err=float(err), hits=hits,
        ms=cuda_ms(lambda: wrapper(**kw), iters),
        plain_ms=cuda_ms(lambda: plain(**kw), 2, warmup=1),
        library_ms=cuda_ms(chain, 3, warmup=1),
        library="chain of 5 calls, no single one does the probe: torch.searchsorted,"
                " clamp_, two gathers, ==, where (on int64 keys flipped and a"
                " dimension side sorted beforehand)",
    )
    if kernel == "probe_join_gid":
        out["build_ms"] = cuda_ms(
            lambda: kj.build_join_table(kw["dim_keys"], kw["dim_bucket"]), iters)
    # the fact keys read once at their stored width, one int32 written a
    # row, the dimension table read once; a hash (two 64-bit multiplies,
    # three shifts), a slot index and two compares a row
    width = facts.element_size()
    out.update(_bound(n * (width + 4) + D * 12, n * 12,
                      f"n={n} D={D} fact_keys={str(facts.dtype).split('.')[-1]}"))
    return out


def probe_shapes_off_the_main_path(device, n, iters):
    """probe_join_gid at two dimension sizes no query of phase 4 has: a
    table that fits well inside the L2 (16384 rows: 512 KB of slots) and
    one beyond it (2^22 rows: 128 MB of slots), u64 keys, every fact row
    a hit, as the 2^18-row query has it."""
    gen = torch.Generator(device=device).manual_seed(11)  # made on the card
    out = {}
    for D in (16_384, 1 << 22):
        kw = dict(
            fact_keys=torch.randint(D, (n,), generator=gen, device=device)
            * BIG_DIM_MULT + 3,
            dim_keys=torch.randperm(D, generator=gen, device=device) * BIG_DIM_MULT + 3,
            dim_bucket=torch.randint(N_REGIONS, (D,), generator=gen, device=device,
                                     dtype=torch.int32),
            n=n)
        out[f"D={D} (not a query)"] = check_and_time_join(
            "probe_join_gid", f"D={D}", kw, iters)
    return out


def kernel_device_ms(fn, iters=20):
    """Device time of one call of ``fn`` whose kernels are shorter than
    the host's time to launch them: CUDA events around ``iters`` calls
    that the host queues behind a sleep kernel (about 9 ms), so that the
    card runs them back to back, with no host gap between them; each
    launch's own start on the card still counts."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 24)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PARENT_TREE = "EVQL_PARENT_TREE"  # an earlier tree of the repo, its kernels timed beside these
PARENT = {}  # "extract" / "join" / "probes" -> that tree's kernel module, loaded in phase 2


def parent_kernels(names=("extract", "join", "probes")):
    """The kernel modules ``eventql_tpu_torch.kernels.<name>`` of the
    earlier tree that $EVQL_PARENT_TREE names, imported apart from this
    tree's: each calls its own kernel through its own wrapper and C
    interface, builds into that tree and counts its launches there. {}
    when it is unset."""
    tree = os.environ.get(PARENT_TREE)
    if not tree:
        return {}
    tree = os.path.abspath(tree)

    def package_modules():
        return [k for k in sys.modules if k.split(".")[0] == "eventql_tpu_torch"]

    ours = {k: sys.modules.pop(k) for k in package_modules()}
    sys.path.insert(0, tree)
    try:
        mods = {name: importlib.import_module(f"eventql_tpu_torch.kernels.{name}")
                for name in names}
    finally:
        sys.path.remove(tree)
        for k in package_modules():
            del sys.modules[k]
        sys.modules.update(ours)
    for mod in mods.values():
        check(mod.__file__.startswith(tree + os.sep),
              f"${PARENT_TREE}: {mod.__name__} came from {mod.__file__}")
    return mods


def in_turns(first, second, iters):
    """CUDA-event ms of ``first`` and ``second`` timed in turns (first,
    second, second, first), each the mean of its two turns, and the four
    turns."""
    turns = [cuda_ms(fn, iters) for fn in (first, second, second, first)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def dim_join_extras(kw, iters, parent):
    """Beside a timed dim_join_gid call: its kernel's device time at one
    row (one block: the table build and the launch, against a one-row
    table for the launch alone), and the earlier B4 on the same
    arguments, equal to this one (tolerance 0) and timed."""
    one = dict(kw, n=1)
    out = dict(
        one_row_device_ms=kernel_device_ms(lambda: kj.dim_join_gid(**one)),
        one_row_one_dim_device_ms=kernel_device_ms(lambda: kj.dim_join_gid(
            kw["fact_keys"], kw["dim_keys"][:1], kw["dim_bucket"][:1], 1)))
    if parent is None:
        out["parent_ms"] = None
        out["parent"] = f"not measured: ${PARENT_TREE} is unset"
        return out
    check(torch.equal(parent(**kw), kj.dim_join_gid(**kw)),
          "the earlier dim_join_gid and this one disagree")
    out["parent_ms"] = cuda_ms(lambda: parent(**kw), iters)
    out["parent"] = os.environ[PARENT_TREE]
    return out


def dim_shapes_off_the_main_path(device, n, iters, parent):
    """dim_join_gid at two shapes no query of phase 4 has, with u64 fact
    keys: D = 8192 (the tier's edge, a 192 KB table), every fact row a
    hit; D = 1024 with half the rows missing, as the query's u32 stream
    has it. Beside each: the earlier B4, and at D = 8192 probe_join_gid
    (the big-table tier) on the same inputs, and the device time of its
    table build in global memory (what building B4's table once, for all
    blocks, would cost at the least)."""
    gen = torch.Generator(device=device).manual_seed(13)  # made on the card
    out = {}
    for D, span in ((kj.MAX_COMPARE_DIMS, kj.MAX_COMPARE_DIMS), (N_DIMS, 2 * N_DIMS)):
        kw = dict(
            fact_keys=torch.randint(span, (n,), generator=gen, device=device)
            * BIG_DIM_MULT + 3,
            dim_keys=torch.randperm(D, generator=gen, device=device) * BIG_DIM_MULT + 3,
            dim_bucket=torch.randint(N_REGIONS, (D,), generator=gen, device=device,
                                     dtype=torch.int32),
            n=n)
        label = f"D={D} u64 keys, {'every row a hit' if span == D else 'half the rows miss'}"
        res = check_and_time_join("dim_join_gid", label, kw, iters)
        res.update(dim_join_extras(kw, iters, parent))
        if D == kj.MAX_COMPARE_DIMS:
            check(torch.equal(kj.probe_join_gid(**kw), kj.dim_join_gid(**kw)),
                  "the two tiers disagree at D = 8192")
            res["probe_join_gid_ms"] = cuda_ms(lambda: kj.probe_join_gid(**kw), iters)
            res["global_table_build_device_ms"] = kernel_device_ms(
                lambda: kj.build_join_table(kw["dim_keys"], kw["dim_bucket"]))
        out[label + " (not a query)"] = res
    return out


def _topk_context(device, calls):
    """Whole-operation yardsticks for the headline top-k, as context and
    not as a port: the port's topk_permutation (host clock, it waits on
    the card twice), torch.topk and torch.sort on the same 64-bit key."""
    f24 = calls["topk_ts_desc"][0][1]["gid"]  # only for the row count
    n = f24.shape[0]
    key = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64,
                        device=device)

    def wall_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    return {
        "rows": n, "k": 100,
        "topk_permutation_wall_ms": wall_ms(lambda: ksort.topk_permutation(key, 100)),
        "torch_topk_ms": cuda_ms(lambda: torch.topk(key, 100), 5, warmup=1),
        "torch_sort_ms": cuda_ms(lambda: torch.sort(key), 3, warmup=1),
        "torch_sort_stable_ms": cuda_ms(
            lambda: torch.sort(key, stable=True), 3, warmup=1),
    }


def _as_int64(t, unsigned):
    wide = t.to(torch.int64)
    return wide & ((1 << (8 * t.element_size())) - 1) if unsigned else wide


def b1_library_ms(kw):
    """One library call beside a recorded groupby_agg call: index_add_ of
    the value stream as int64 at the buckets, or torch.bincount of the
    buckets where the call sums nothing. Neither filters. The buckets
    (key - base) are made beforehand, those outside [0, K), which the
    kernel drops, shifted into one spare slot."""
    n, K = kw["n"], kw["num_buckets"]
    key = _as_int64(kw["gid"][:n], kw.get("gid_unsigned", False)) - kw.get("gid_base", 0)
    idx = torch.where((key >= 0) & (key < K), key + 1, 0)
    del key
    if kw.get("values") is None:
        return dict(library_ms=cuda_ms(lambda: torch.bincount(idx, minlength=K + 1), 5,
                                       warmup=1),
                    library="torch.bincount (int64 buckets shifted by one beforehand, no"
                            " filter)")
    vals = _as_int64(kw["values"][:n], kw.get("values_unsigned", False))
    lib = torch.zeros(K + 1, dtype=torch.int64, device=idx.device)
    return dict(library_ms=cuda_ms(lambda: lib.index_add_(0, idx, vals), 5, warmup=1),
                library="torch.Tensor.index_add_ (int64, sums only, no filter; buckets"
                        " shifted by one beforehand)")


def b2_library_ms(kw):
    """One library call beside a recorded groupby_multi_agg call:
    index_add_ of its summed streams as int64 [n, S] at the buckets,
    shifted as in ``b1_library_ms``. It neither filters nor counts."""
    n, K = kw["n"], kw["num_buckets"]
    key = _as_int64(kw["gid"][:n], kw.get("gid_unsigned", False)) - kw.get("gid_base", 0)
    idx = torch.where((key >= 0) & (key < K), key + 1, 0)
    del key
    uns = kw.get("streams_unsigned") or (False,) * len(kw["streams"])
    vals = torch.stack([_as_int64(t[:n], u) for t, u in zip(kw["streams"], uns)], dim=1)
    lib = torch.zeros((K + 1, vals.shape[1]), dtype=torch.int64, device=idx.device)
    return dict(library_ms=cuda_ms(lambda: lib.index_add_(0, idx, vals), 5, warmup=1),
                library="torch.Tensor.index_add_ (int64 [n, S], sums only, no filter;"
                        " buckets shifted by one beforehand)")


def _hash_streams(kw):
    """(role, tensor) of every stream a recorded hash_groupby call reads,
    each tensor once."""
    named = [("key", t) for t in kw["keys"]] + [("value", t) for t in kw.get("values", ())]
    named += [("distinct", t) for t in kw.get("distinct", ())] + [("mask", kw.get("mask"))]
    seen, out = set(), []
    for role, t in named:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            out.append((role, t))
    return out


def _hash_device(kw):
    """The device of a recorded hash_groupby call: its ``device``, else
    its streams'."""
    return kw.get("device") or _hash_streams(kw)[0][1].device


def hash_bound_of(kw, groups):
    """Least time for the call: every key, value and mask stream read
    once at its stored width and the results (count, first row, one
    word per aggregate) written once, over the memory rate; against a
    hash, a compare and an atomic a key word and a row, and one atomic
    per aggregate, over the ALU rate."""
    n = kw["n"]
    streams = _hash_streams(kw)
    outs = 2 + len(kw.get("values", ())) + len(kw.get("distinct", ()))
    nbytes = n * sum(t.element_size() for _r, t in streams) + groups * outs * 8
    nops = n * (3 * len(kw["keys"]) + outs)
    shape = f"n={n} groups={groups} " + " ".join(
        f"{r}={str(t.dtype).split('.')[-1]}" for r, t in streams)
    return _bound(nbytes, nops, shape)


_SCATTER = {"sum": "sum", "min": "amin", "max": "amax", "mean": "mean"}


def hash_library_ms(kw):
    """The library chain beside a recorded call: torch.unique
    (return_inverse) of the masked-in key tuples, one scatter_reduce_ per
    aggregate on the values as stored, and for count_distinct a unique of
    (group, value) pairs and a bincount. The mask is applied and the keys
    are widened and stacked beforehand. Not the kernel's semantics at
    every corner (a u64 min in signed order), a yardstick of the time."""
    n = kw["n"]
    rows = torch.arange(n, device=_hash_device(kw)) if kw.get("mask") is None else (
        torch.nonzero(kw["mask"][:n]).flatten())
    # no key: every row in one group
    keys = [k[:n][rows].to(torch.int64) for k in kw["keys"]] or [torch.zeros_like(rows)]
    key = keys[0] if len(keys) == 1 else torch.stack(keys, 1)
    vals = [v[:n][rows] for v in kw.get("values", ())]
    vals = [v if v.dtype == torch.float64 else v.to(torch.int64) for v in vals]
    dist = [d[:n][rows].to(torch.int64) for d in kw.get("distinct", ())]
    kinds = kw.get("kinds", ())

    def chain():
        if key.dim() == 1:
            uniq, inv = torch.unique(key, return_inverse=True)
        else:
            uniq, inv = torch.unique(key, dim=0, return_inverse=True)
        G = uniq.shape[0]
        for v, kind in zip(vals, kinds):
            torch.zeros(G, dtype=v.dtype, device=v.device).scatter_reduce_(
                0, inv, v, _SCATTER[kind], include_self=False)
        for d in dist:
            pairs = torch.unique(torch.stack([inv, d], 1), dim=0)
            torch.bincount(pairs[:, 0], minlength=G)

    return dict(library_ms=cuda_ms(chain, 3, warmup=1),
                library="torch.unique(return_inverse) + one scatter_reduce_ per aggregate"
                        " (+ unique of (group, value) pairs and bincount per count_distinct);"
                        " mask applied, keys widened and stacked beforehand")


def _peak_bytes(fn):
    """Device bytes a call allocates at its peak beyond what was held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def check_and_time_hash(label, kw, iters):
    """hash_groupby on a recorded call: equal to its plain version (in
    first-row order; integers exactly, order-proof floats by their bits),
    then the kernel in its tier, the same call in the hash tier (spans
    withheld, also held to the plain version), the plain version and the
    library chain timed, and the bytes each tier allocates at its peak."""
    forms = dict(hg.FORMS)
    got, want = hg.hash_groupby(**kw), hg.hash_groupby_plain(**kw)
    torch.cuda.synchronize()
    tier = [k for k in hg.TIERS if hg.FORMS[k] > forms[k]][0]
    err = check_hash_case(label, got, want)
    as_hash = dict(kw, key_spans=None, distinct_spans=None)
    err = max(err, check_hash_case(label + " (hash tier)", hg.hash_groupby(**as_hash), want))
    groups = int(want.first_index.numel())
    del got, want
    out = dict(max_abs_err=err, groups=groups, tier=tier,
               ms=cuda_ms(lambda: hg.hash_groupby(**kw), iters),
               hash_tier_ms=cuda_ms(lambda: hg.hash_groupby(**as_hash), iters),
               plain_ms=cuda_ms(lambda: hg.hash_groupby_plain(**kw), 2, warmup=1),
               # the group ids (slots), count and first row alone, in the
               # call's tier and in the hash tier: the rest of ms is the
               # value streams' atomics and count_distinct
               ids_count_first_ms=cuda_ms(lambda: hg.hash_groupby(
                   kw["keys"], kw["n"], kw.get("mask"), key_spans=kw.get("key_spans"),
                   device=kw.get("device")), iters),
               hash_tier_ids_count_first_ms=cuda_ms(
                   lambda: hg.hash_groupby(kw["keys"], kw["n"], kw.get("mask"),
                                           device=kw.get("device")), iters),
               peak_bytes=_peak_bytes(lambda: hg.hash_groupby(**kw)),
               hash_tier_peak_bytes=_peak_bytes(lambda: hg.hash_groupby(**as_hash)))
    out.update(hash_library_ms(kw))
    out.update(hash_bound_of(kw, groups))
    return out


def phase_times(device, calls, parent=None):
    """Every call the main paths made (as recorded in phase 4: the same
    tensors, sizes and options) goes through its wrapper and its plain
    version once more; the results must be equal, and only then are
    both timed. ``calls`` maps query name to a list of
    (kernel name, keyword arguments)."""
    headline_of = {"groupby_agg": "headline", "groupby_multi_agg": "multi_sum",
                   "extract_ge": "topk_ts_desc", "dim_join_gid": "join_small_dim",
                   "probe_join_gid": "join_big_dim", "hash_groupby": "G1_min_max_mean"}
    out = {name: {"other_shapes": {}} for name in _KERNELS}
    checked = 0
    for query, recorded in calls.items():
        for i, (kernel, kw) in enumerate(recorded):
            head = headline_of[kernel] == query
            iters = 20 if head else 5
            if kernel == "extract_ge":
                res = check_and_time_extract(query, kw, iters)
            elif kernel == "hash_groupby":
                res = check_and_time_hash(query, kw, 10 if head else 3)
            elif kernel in ("dim_join_gid", "probe_join_gid"):
                res = check_and_time_join(kernel, query, kw, iters)
            else:
                res = check_and_time(kernel, query, kw, iters)
            checked += 1
            if head:
                out[kernel].update(res)
            else:
                label = query if len(recorded) == 1 else f"{query} call {i + 1}"
                out[kernel]["other_shapes"][label] = res

    kernel, kw = calls["headline"][0]
    check(kernel == "groupby_agg" and kw["gid"].dtype == torch.int16
          and kw["values"].dtype == torch.int16
          and kw["num_buckets"] == N_KEYS + 1 and len(kw["preds"]) == 1
          and kw["preds"][0].src == "value",
          "the headline query did not reach the kernel as i16 key, u16 value"
          " compared in place")
    # every row in one bucket: the slowest the shared-table atomics get
    hot = dict(kw, gid=torch.zeros_like(kw["gid"]), num_buckets=1)
    out["groupby_agg"]["other_shapes"]["one_hot_key (not a query)"] = (
        check_and_time("groupby_agg", "one hot key", hot, 5))

    # the library yardsticks of B1's other shapes, on the very recorded
    # arguments: index_add_ on int64 (sums only, no filter, no count), and
    # for the count-only query torch.bincount
    for query, res in out["groupby_agg"]["other_shapes"].items():
        if query in ("or_two_columns", "numeric_key_base", "mask_form", "k_100000",
                     "count_only", "one_hot_key (not a query)"):
            res.update(b1_library_ms(hot if query.startswith("one_hot") else
                                     calls[query][0][1]))

    # the library yardstick (never called by the port): index_add_ on
    # int64, sums only, no filter, no count
    n, K = kw["n"], kw["num_buckets"]
    idx64, v64 = kw["gid"][:n].to(torch.int64), kw["values"][:n].to(torch.int64)
    lib = torch.zeros(K, dtype=torch.int64, device=device)
    out["groupby_agg"]["library_ms"] = cuda_ms(
        lambda: lib.index_add_(0, idx64, v64), 5, warmup=1)
    out["groupby_agg"]["library"] = (
        "torch.Tensor.index_add_ (int64, sums only, no filter)")
    del idx64, v64

    kernel, kw = calls["multi_sum"][0]
    check(kernel == "groupby_multi_agg" and len(kw["streams"]) == 2
          and kw["mask"] is not None,
          "the multi-sum query did not reach the kernel with two streams"
          " and a mask")
    n, K = kw["n"], kw["num_buckets"]
    idx64 = kw["gid"][:n].to(torch.int64)
    vw = torch.stack([t[:n].to(torch.int64) for t in kw["streams"]], dim=1)
    lib2 = torch.zeros((K, 2), dtype=torch.int64, device=device)
    out["groupby_multi_agg"]["library_ms"] = cuda_ms(
        lambda: lib2.index_add_(0, idx64, vw), 5, warmup=1)
    out["groupby_multi_agg"]["library"] = (
        "torch.Tensor.index_add_ (int64 [n, 2], sums only, no filter)")
    del idx64, vw

    if "ms" in out["extract_ge"]:
        # the top-k route reached the kernels as the histogram pair: a
        # count-only pass over a 32-bit prefix stream, then the same
        # restricted by an in-kernel `eq` on the first stream
        (k1, kw1), (k2, kw2), (k3, _kw3) = calls["topk_ts_desc"]
        check((k1, k2, k3) == ("groupby_agg", "groupby_agg", "extract_ge")
              and kw1["gid"].dtype == torch.int32 and kw1.get("values") is None
              and not kw1.get("preds") and kw1["num_buckets"] == 4096
              and len(kw2["preds"]) == 1 and kw2["preds"][0].op == "eq"
              and kw2["preds"][0].src == "stream",
              "the headline top-k did not reach the kernels as two 4096-bucket"
              " count histograms and one extraction")
        # level 1 is a plain count per bucket, which one library call does
        level1 = out["groupby_agg"]["other_shapes"]["topk_ts_desc call 1"]
        prefix = kw1["gid"][:kw1["n"]]
        level1["library_ms"] = cuda_ms(
            lambda: torch.bincount(prefix, minlength=4096), 5, warmup=1)
        level1["library"] = "torch.bincount (int32 keys, no predicate)"
        level2 = out["groupby_agg"]["other_shapes"]["topk_ts_desc call 2"]
        level2["library_ms"] = None
        level2["library"] = (
            "none: no single call counts per bucket only the rows a compare on a"
            " second stream selects (bincount takes float weights, not a filter)")
    # the join queries reached the probes as the narrowed (32-bit) and
    # the 64-bit fact key stream, at the two dimension sizes
    (k1, kw1), (k2, kw2) = calls["join_small_dim"]
    check((k1, k2) == ("dim_join_gid", "groupby_agg")
          and kw1["fact_keys"].dtype == torch.int32
          and kw1["dim_keys"].shape[0] == N_DIMS and kw2["gid"].dtype == torch.int32
          and kw2["values"].dtype == torch.int16
          and 0 < kw2["num_buckets"] <= N_REGIONS,
          "the small-dim join did not reach the kernels as a u32 key stream"
          " against 1024 dims, then i32 buckets with the u16 value stream")
    out["dim_join_gid"].update(dim_join_extras(kw1, 20, parent))
    out["dim_join_gid"]["other_shapes"].update(
        dim_shapes_off_the_main_path(device, kw1["n"], 20, parent))
    # B1 after a join: index_add_ on int64, the bucket shifted by one
    # beforehand so that -1 (no dimension row) lands in a spare slot
    n, K = kw2["n"], kw2["num_buckets"]
    idx64 = kw2["gid"][:n].to(torch.int64) + 1
    v64 = kw2["values"][:n].to(torch.int64)
    lib3 = torch.zeros(K + 1, dtype=torch.int64, device=device)
    after_join = out["groupby_agg"]["other_shapes"]["join_small_dim call 2"]
    after_join["library_ms"] = cuda_ms(
        lambda: lib3.index_add_(0, idx64, v64), 5, warmup=1)
    after_join["library"] = (
        "torch.Tensor.index_add_ (int64, sums only, buckets shifted by one"
        " beforehand so that -1 has a slot)")
    del idx64, v64
    (k1, kw1), (k2, kw2) = calls["join_big_dim"]
    check((k1, k2) == ("probe_join_gid", "groupby_agg")
          and kw1["fact_keys"].dtype == torch.int64
          and kw1["dim_keys"].shape[0] == N_BIG_DIMS
          and not bool((kw1["dim_keys"][1:] > kw1["dim_keys"][:-1]).all()),
          "the big-dim join did not reach the kernels as a u64 key stream"
          " against 2^18 unsorted dims")
    out["probe_join_gid"]["other_shapes"].update(
        probe_shapes_off_the_main_path(device, kw1["n"], 5))
    # the general GROUP BY reached the hash aggregate as the stored i16 key
    # (dictionary ids), the mask, the u16 and u32 streams as stored and
    # mean's float64 argument; every row on one key is its slowest shape
    kernel, hkw = calls["G1_min_max_mean"][0]
    check(kernel == "hash_groupby" and [k.dtype for k in hkw["keys"]] == [torch.int16]
          and hkw["mask"] is not None and list(hkw["kinds"]) == ["min", "max", "mean"]
          and [v.dtype for v in hkw["values"]] == [torch.int16, torch.int32, torch.float64],
          "G1 did not reach the hash aggregate as an i16 key, a mask, u16 / u32 streams"
          " as stored and a float64 stream")
    check(hkw["key_spans"] == [(0, N_KEYS, False)], "G1's key span is not its dictionary's")
    hot_key = dict(hkw, keys=[torch.zeros_like(hkw["keys"][0])])
    out["hash_groupby"]["other_shapes"]["one_hot_key (not a query)"] = (
        check_and_time_hash("one hot key", hot_key, 5))
    # the same in the direct global tier: G3's call (two keys, 102 400
    # slots) with every row on the slot of (0, 0)
    kernel, g3 = calls["G3_two_keys"][0]
    hot_key = dict(g3, keys=[torch.zeros_like(k) for k in g3["keys"]])
    out["hash_groupby"]["other_shapes"]["G3 with one hot key (not a query)"] = (
        check_and_time_hash("G3, one hot key", hot_key, 5))
    check(out["hash_groupby"]["other_shapes"]["G3 with one hot key (not a query)"]["tier"]
          == "global", "G3's hot key did not take the direct global tier")
    del hot_key

    for name, d in out.items():
        d["max_abs_err"] = max([d.get("max_abs_err", 0.0)] + [
            o["max_abs_err"] for o in d["other_shapes"].values()])
    log(f"phase 5: {checked + 1} main-path shapes equal to their plain"
        f" versions (tolerance 0), then timed")
    return out


# -- phase 6: the mesh paths ----------------------------------------------------
#
# Phase 4's table over a mesh of MESH_SHARDS shards on the one card: bench.py
# multijoin's rows per chip (2^24, bench.py:407) in each shard. Shards on one
# device run one after another, so the mesh times measure what the tier costs
# (per-shard launches, the exchange, the merge), not how it scales.

MESH_SHARDS = 4
MESH_REPS = 3  # timed runs of each query after a first, which loads the shards
# the exchange of a mesh query: at most 8 words a group (or distinct pair,
# or top-k candidate) and shard
MESH_BYTES_PER_UNIT = 64
# bench.py multijoin (bench.py:407-410): dimension tables of 1024 and 256 rows,
# 1024 buckets, at phase 4's 2^26 fact rows
MJ_DIM1, MJ_DIM2, MJ_BUCKETS = 1024, 256, 1024
MJ_MULT1, MJ_ADD1, MJ_MULT2, MJ_ADD2 = 7919, 3, 104729, 11


# a table of its own for the full ORDER BY's fallbacks: 2^16 rows a shard
MESH_SMALL_ROWS = MESH_SHARDS << 16
MESH_SMALL_PASS = 40_000  # rows r < 40 000, all in shard 0: > its bucket capacity 2^15
# a full ORDER BY's exchange: the sample sort moves each table row's key
# and row id (16 bytes) at most twice over (buckets of twice a shard's
# share), and a few words for its decision
SAMPLE_SORT_BYTES_PER_ROW = 32
ORDER_DECISION_BYTES = 4096


def order_exchange_bound(rows, sample_sort, longest=0, n_keys=0):
    """The most bytes a full ORDER BY over the mesh may exchange: the
    sample sort of the table's ``rows`` where it is tried, and the
    compare-split where it serves, each of whose stages moves every
    shard's run of ``longest`` rows (the most passing rows of a shard)
    as a padding byte and 8 bytes for each of ``n_keys`` keys and the
    row id."""
    b = MESH_SHARDS.bit_length() - 1
    stages = b * (b + 1) // 2
    tried = SAMPLE_SORT_BYTES_PER_ROW * rows + ORDER_DECISION_BYTES if sample_sort else 0
    return tried + stages * MESH_SHARDS * longest * (1 + 8 * (n_keys + 1))


def _mesh_counters():
    """The mesh routes' counters: GROUP BY, JOIN + GROUP BY, top-k, full
    ORDER BY (either sort), and the full ORDER BYs the sample sort served."""
    return (mesh_exec.MESH_GROUPBY_RUNS, mesh_exec.MESH_JOIN_RUNS, mesh_exec.MESH_TOPK_RUNS,
            mesh_exec.MESH_ORDER_RUNS, mesh_exec.MESH_BUCKET_SORT_RUNS)


def event_ms(fn):
    """fn() between two CUDA events on the current stream, synchronised:
    (its result, the milliseconds between the events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def small_order_table(seed):
    """Table ``o`` (MESH_SMALL_ROWS rows): ``r`` the row id, ``c`` one
    value on every row, ``u`` random u64 with the u64 max on 1 % of the
    rows; and the full ORDER BY queries on it that the sample sort cannot
    serve exactly: (name, sql, sample sort?, expected rows, bound on the
    bytes exchanged: the sample sort tried, then the compare-split of
    the MESH_SMALL_PASS rows, all in shard 0)."""
    rng = np.random.default_rng(seed)
    n = MESH_SMALL_ROWS
    r = np.arange(n, dtype=np.uint64)
    u = rng.integers(0, 1 << 40, n, dtype=np.uint64)
    u[rng.random(n) < 0.01] = np.uint64((1 << 64) - 1)
    ones = np.ones(n, bool)
    rel = relation_from_numpy(
        ["r", "c", "u"], [(SType.UINT64, r, ones, None),
                          (SType.UINT64, np.full(n, 42, np.uint64), ones, None),
                          (SType.UINT64, u, ones, None)])
    m = MESH_SMALL_PASS
    order = np.argsort(u[:m], kind="stable")
    bound = order_exchange_bound(n, True, m, 1)
    return rel, [
        ("order_overflow", f"select r, c from o where r < {m} order by c;", False,
         [[str(i), "42"] for i in range(m)], bound),
        ("order_sentinel_key", f"select r, u from o where r < {m} order by u;", False,
         [[str(i), str(int(u[i]))] for i in order], bound),
    ]


def mesh_order_queries(c, dictionary):
    """Full ORDER BY queries over the mesh beyond phase 4's: (name, sql,
    sample sort?, expected rows, bound on the bytes exchanged). Three bounded keys whose widths sum to
    59 bits (the string rank 11, ``v`` as u16 16, ``w`` as u32 32) pack
    into one u64 and take the sample sort; an unbounded second key
    (``ts``) takes the compare-split."""
    names = [d.decode() for d in dictionary]
    k, v, w, ts = c["k"], c["v"], c["w"], c["ts"]
    keep = (v < 10) & (w < 65536)
    n_keep = int(keep.sum())
    longest = int(keep.reshape(MESH_SHARDS, -1).sum(axis=1).max())

    def rows(idx, *cols):
        return [[names[int(x[i])] if x is k else str(int(x[i])) for x in cols] for i in idx]

    return [
        ("order_packed_three_keys",
         "select k, v, w from t where v < 10 and w < 65536 order by k desc, v, w;", True,
         rows(_first_rows([N_KEYS - 1 - k, v, w], keep, n_keep), k, v, w),
         order_exchange_bound(len(k), True)),
        ("order_v_desc_ts",
         "select ts, v from t where v < 10 and w < 65536 order by v desc, ts;", False,
         rows(_first_rows([np.uint64(999) - v, ts], keep, n_keep), ts, v),
         order_exchange_bound(len(k), False, longest, 2)),
    ]


def mesh_queries(tables):
    """(name, sql, route, check of the rows, bound on the bytes
    exchanged) of every phase 4 query over the mesh and of the full
    ORDER BYs of phase 6: route 0 GROUP BY, 1 JOIN + GROUP BY, 2 top-k,
    3 the full ORDER BY through the sample sort, 4 through the
    compare-split. The bound of the first three is MESH_BYTES_PER_UNIT a
    unit and shard, the units being groups, distinct pairs besides (their
    count is the sum of the answer's count_distinct) or top-k candidates
    a shard; a full ORDER BY's is ``order_exchange_bound``."""
    out = []

    def per_unit(units):
        return MESH_BYTES_PER_UNIT * units * MESH_SHARDS

    for name, sql, _kernel, _fused, expected in tables["gqs"]:
        out.append((name, sql, 0, lambda rows, e=expected: sorted(rows) == e,
                    per_unit(len(expected))))
    for name, sql, expected in tables["hqs"]:
        units = len(expected)
        if "count_distinct" in sql:
            units += sum(int(r[1]) for r in expected)
        out.append((name, sql, 0, lambda rows, e=expected: rows == e, per_unit(units)))
    for name, sql, _per_run, expected in tables["jqs"]:
        if expected is not None:
            out.append((name, sql, 1, lambda rows, e=expected: rows == e,
                        per_unit(len(expected))))
    n_p = tables["full"].get_table_data("t").num_rows
    for name, sql, route, _per_run, expected in tables["oqs"]:
        if route == "topk":
            limit = re.search(r"limit (\d+)(?: offset (\d+))?", sql)
            out.append((name, sql, 2, lambda rows, e=expected: rows == e,
                        per_unit(sum(int(x) for x in limit.groups(0)))))
        else:
            out.append((name, sql, 3, lambda rows, e=expected: rows == e,
                        order_exchange_bound(n_p, True)))
    for name, sql, bucket, expected, bound in tables["mesh_oqs"]:
        out.append((name, sql, 3 if bucket else 4, lambda rows, e=expected: rows == e, bound))
    return out


def multijoin_data(n, seed):
    """bench.py multijoin's tables (bench.py:412-423) at n fact rows, with
    each row's ordinal kept for the numpy answer: dim1 keys ordinal * 7919
    + 3 in a random order with a bucket each, dim2 keys ordinal * 104729 +
    11 with a 0/1 flag, fact keys drawn from both, values < 1000."""
    rng = np.random.default_rng(seed)
    d1_keys = rng.permutation(np.arange(MJ_DIM1, dtype=np.uint64) * MJ_MULT1 + MJ_ADD1)
    d1_bucket = rng.integers(0, MJ_BUCKETS, MJ_DIM1).astype(np.int32)
    d2_keys = rng.permutation(np.arange(MJ_DIM2, dtype=np.uint64) * MJ_MULT2 + MJ_ADD2)
    d2_flag = rng.integers(0, 2, MJ_DIM2).astype(np.int32)
    o1 = rng.integers(0, MJ_DIM1, n)
    o2 = rng.integers(0, MJ_DIM2, n)
    fv = rng.integers(0, 1000, n).astype(np.uint64)
    bucket_of = np.empty(MJ_DIM1, np.int32)
    bucket_of[(d1_keys - MJ_ADD1) // MJ_MULT1] = d1_bucket
    flag_of = np.empty(MJ_DIM2, np.int32)
    flag_of[(d2_keys - MJ_ADD2) // MJ_MULT2] = d2_flag
    return dict(
        d1_keys=d1_keys, d1_bucket=d1_bucket, d2_keys=d2_keys, d2_flag=d2_flag,
        f_k1=o1.astype(np.uint64) * MJ_MULT1 + MJ_ADD1,
        f_k2=o2.astype(np.uint64) * MJ_MULT2 + MJ_ADD2, fv=fv,
        gid=bucket_of[o1], mask=fv < 800, active=flag_of[o2] == 1)


def _sum_count_answer(gid, keep, fv):
    counts = np.bincount(gid[keep], minlength=MJ_BUCKETS)
    sums = np.bincount(gid[keep], weights=fv[keep].astype(np.float64), minlength=MJ_BUCKETS)
    check(sums.max() < 2.0**53, "expected sum not exact in float64")
    return [counts.astype(np.int64).tolist(), sums.astype(np.int64).tolist()]


def _timed_tier(mesh, calls, reps):
    """Each kernel-tier call checked against its numpy answer, its
    exchange bytes by op within its bound, then timed (CUDA events, median
    of ``reps``). ``calls``: name -> (fn, check of its result, bound on
    the bytes exchanged)."""
    out = {}
    for name, (fn, ok, bound) in calls.items():
        before = launch_counts()
        with distributed.exchange_tally(mesh) as tally:
            res, _ms = event_ms(fn)
        check(ok(res), f"{name}: result differs from the numpy answer")
        del res
        moved = tally.by_op()
        check(0 < sum(moved.values()) <= bound,
              f"{name}: exchange of {moved} bytes, bound {bound}")
        times = [event_ms(fn)[1] for _ in range(reps)]
        after = launch_counts()
        runs = reps + 1
        check(all((after[k] - before[k]) % runs == 0 for k in after),
              f"{name}: launches differ between calls")
        launched = {k: (after[k] - before[k]) // runs for k in after
                    if after[k] > before[k]}
        out[name] = dict(ms=statistics.median(times), runs_ms=times, exchange_bytes=moved,
                         shards=mesh.size, launches=launched)
        log(f"phase 6: {name}: {out[name]['ms']:.3f} ms (median of {reps}), exchange"
            f" {moved} bytes, launches a call {launched}, equal to numpy")
    return out


def tier_calls(device, mesh, n):
    """The kernel-tier functions at bench multijoin's shape on ``mesh`` (the
    single controller's, or a process mesh: each process checks its own
    shards and the replicated results), each with a check against numpy
    (tolerance 0) and a bound on the bytes it exchanges:
    distributed_sum_count, distributed_join_aggregate and
    distributed_multi_join_aggregate; the sorts (distributed_sort and
    distributed_order_permutation by (f.k1, f.v), distributed_bucket_sort
    of the same order packed in one u64, distributed_topk of it and of a
    key over all 64 bits); the
    grouped aggregates by the dim1 bucket (distributed_grouped_aggregate,
    distributed_count_distinct) and by (bucket, f.v), about 10^6 groups
    (distributed_grouped_aggregate_sharded)."""
    t0 = time.perf_counter()
    table = multihost.make_global_table
    d = multijoin_data(n, seed=31)
    sc_args = table(mesh, [d["mask"], d["gid"], d["fv"]])
    fk1, fk2, fv, fm = table(mesh, [d["f_k1"], d["f_k2"], d["fv"], d["mask"]])
    d1k, d1b = table(mesh, [d["d1_keys"], d["d1_bucket"]])
    dim_keys = torch.from_numpy(d["d1_keys"].view(np.int64)).to(device)
    dim_bucket = torch.from_numpy(d["d1_bucket"]).to(device)
    d2k = torch.from_numpy(d["d2_keys"].view(np.int64)).to(device)
    d2f = torch.from_numpy(d["d2_flag"]).to(device)
    want = _sum_count_answer(d["gid"], d["mask"], d["fv"])
    want_multi = _sum_count_answer(d["gid"], d["mask"] & d["active"], d["fv"])

    # the sorts: (f.k1, f.v) in one u64 (f.k1 < 2^23, f.v < 2^10)
    key = (d["f_k1"] << np.uint64(10)) | d["fv"]
    key_t = torch.from_numpy(key.view(np.int64)).to(device)
    want_sorted = torch.from_numpy(np.sort(key).view(np.int64)).to(device)
    keyd, rowid = table(mesh, [key, np.arange(n, dtype=np.int64)])
    top_k = 100
    # the top-k again on a key over all 64 bits (the sql_topk timestamp):
    # the histogram's 24-bit prefix cannot tell keys below 2^40 apart
    ts = np.random.default_rng(37).integers(0, 1 << 63, n, dtype=np.uint64)
    ts_t = torch.from_numpy(ts.view(np.int64)).to(device)
    ts_top = torch.from_numpy(np.sort(np.partition(ts, n - top_k)[n - top_k:])[::-1].copy()
                              .view(np.int64)).to(device)
    (tsd,) = table(mesh, [ts])
    del ts
    # the grouped aggregates by bucket: presence of each (bucket, f.v)
    keep = d["mask"]
    g, v = d["gid"][keep].astype(np.int64), d["fv"][keep].astype(np.int64)
    pairs = np.bincount(g * 1000 + v, minlength=MJ_BUCKETS * 1000)
    seen = pairs.reshape(MJ_BUCKETS, 1000) > 0
    occ = np.nonzero(seen.any(1))[0]
    grouped_want = [occ.tolist(), np.bincount(g, minlength=MJ_BUCKETS)[occ].tolist(),
                    np.bincount(g, weights=v, minlength=MJ_BUCKETS)[occ].astype(np.int64).tolist(),
                    seen[occ].argmax(1).tolist(), (999 - seen[occ, ::-1].argmax(1)).tolist()]
    distinct_want = [occ.tolist(), seen[occ].sum(1).tolist()]
    pair_occ = np.nonzero(pairs)[0]
    k2_sums = np.bincount(g * 1000 + v, weights=d["f_k2"][keep].astype(np.float64),
                          minlength=MJ_BUCKETS * 1000)
    check(k2_sums.max() < 2.0**53, "expected sum not exact in float64")
    sharded_want = [pair_occ.tolist(), pairs[pair_occ].tolist(),
                    k2_sums[pair_occ].astype(np.int64).tolist()]
    gidd, maskd = table(mesh, [d["gid"], d["mask"]])
    del g, v, pairs, seen, k2_sums, key
    nl = n // mesh.size
    log(f"phase {6 if mesh.group is None else 7}: bench multijoin's tables at {n} rows and"
        f" their numpy answers made in"
        f" {time.perf_counter() - t0:.1f} s")

    # each shard's output is held against the answer on ``device`` (a
    # shard may lie on another card)
    def sort_ok(res):
        (k1s, fvs), (rows,) = res
        for i in mesh.local:  # shard i holds global ranks [i nl, (i + 1) nl)
            got = ((k1s[i] << 10) | fvs[i]).to(device)
            if not (torch.equal(got, want_sorted[i * nl:(i + 1) * nl])
                    and torch.equal(key_t[rows[i].to(device)], got)):
                return False
        return True

    def order_ok(perm):
        return all(torch.equal(key_t[perm[i].to(device)], want_sorted[i * nl:(i + 1) * nl])
                   for i in mesh.local)

    def bucket_ok(res):
        keys, rows, counts, overflow = res
        c = counts.tolist()
        if bool(overflow) or sum(c) != n:
            return False
        for i in mesh.local:  # shard i holds the ranks after the lower shards' counts
            at = sum(c[:i])
            got = keys[i][:c[i]].to(device)
            if not (torch.equal(got, want_sorted[at:at + c[i]])
                    and torch.equal(key_t[rows[i][:c[i]].to(device)], got)):
                return False
        return True

    def topk_ok(res, keys=key_t, want_top=want_sorted[-top_k:].flip(0)):
        vals, rows = res
        return torch.equal(vals, want_top) and torch.equal(keys[rows], vals)

    def grouped_ok(res):
        (gk,), aggs, valid = res
        return bool(valid.all()) and [gk.tolist()] + [a.tolist() for a in aggs] == grouped_want

    def distinct_ok(res):
        (gk,), counts, valid = res
        return bool(valid.all()) and [gk.tolist(), counts.tolist()] == distinct_want

    def sharded_ok(res):
        (gk, fk), aggs, valid = res
        flat = [multihost.fetch_sharded(mesh, [None if t is None else t[m]
                                               for t, m in zip(col, valid)]).astype(np.int64)
                for col in (gk, fk, *aggs)]
        return [(flat[0] * 1000 + flat[1]).tolist(), flat[2].tolist(),
                flat[3].tolist()] == sharded_want

    row_bytes_sort = 3 * 8  # two u64 keys and a row id
    stages = 3  # log2(4) (log2(4) + 1) / 2
    small = MESH_BYTES_PER_UNIT * (MJ_BUCKETS + MJ_DIM1) * mesh.size
    return {
        "distributed_sum_count": (
            lambda: distributed.distributed_sum_count(mesh, *sc_args, MJ_BUCKETS),
            lambda r: [r[0].tolist(), r[1].tolist()] == want, small),
        "distributed_join_aggregate": (
            lambda: distributed.distributed_join_aggregate(
                mesh, fk1, fv, fm, dim_keys, dim_bucket, MJ_BUCKETS),
            lambda r: [r[0].tolist(), r[1].tolist()] == want, small),
        "distributed_multi_join_aggregate": (
            lambda: distributed.distributed_multi_join_aggregate(
                mesh, fk1, fk2, fv, fm, d1k, d1b, d2k, d2f, MJ_BUCKETS),
            lambda r: [r[0].tolist(), r[1].tolist()] == want_multi, small),
        "distributed_sort": (
            lambda: distributed.distributed_sort(mesh, [fk1, fv], [rowid]), sort_ok,
            stages * n * row_bytes_sort),
        "distributed_order_permutation": (
            lambda: distributed.distributed_order_permutation(
                mesh, [fk1, fv], [False, False], [True, True]), order_ok,
            stages * n * (2 * 8 + 8)),
        "distributed_bucket_sort": (
            lambda: distributed.distributed_bucket_sort(mesh, keyd, rowid), bucket_ok,
            2 * 16 * n + 65536),
        "distributed_topk": (
            lambda: distributed.distributed_topk(mesh, keyd, rowid, top_k), topk_ok,
            mesh.size * top_k * 16),
        "distributed_topk (64-bit key)": (
            lambda: distributed.distributed_topk(mesh, tsd, rowid, top_k),
            lambda r: topk_ok(r, ts_t, ts_top), mesh.size * top_k * 16),
        "distributed_grouped_aggregate": (
            lambda: distributed.distributed_grouped_aggregate(
                mesh, maskd, [gidd], [fv] * 4, ["count", "sum", "min", "max"],
                values_unsigned=[True] * 4), grouped_ok,
            MESH_BYTES_PER_UNIT * MJ_BUCKETS * mesh.size),
        "distributed_count_distinct": (
            lambda: distributed.distributed_count_distinct(mesh, maskd, [gidd], fv),
            distinct_ok, MESH_BYTES_PER_UNIT * len(pair_occ) * mesh.size),
        "distributed_grouped_aggregate_sharded": (
            lambda: distributed.distributed_grouped_aggregate_sharded(
                mesh, maskd, [gidd, fv], [fk2, fk2], ["count", "sum"],
                values_unsigned=[True, True], keys_unsigned=[False, True]),
            sharded_ok, stages * MESH_BYTES_PER_UNIT * len(pair_occ) * mesh.size),
    }


def kernel_tier(device, mesh, n, reps):
    """``tier_calls`` on the single controller's mesh, each timed with its
    exchange bytes (``_timed_tier``)."""
    out = _timed_tier(mesh, tier_calls(device, mesh, n), reps)
    for name in out:
        out[name]["rows"] = n
    return out


def phase_mesh(device, tables, reps):
    """Phase 4's queries and the full ORDER BYs of ``mesh_order_queries``
    and ``small_order_table`` over MeshTableProvider(n_shards=MESH_SHARDS)
    on the card, each answer equal to its numpy answer (tolerance 0), its
    route counter rising once a run (a full ORDER BY's also says which
    sort served it), its exchange within its bound (``mesh_queries``); then the kernel-tier functions at bench multijoin's shape.
    The single-card route's time of each query is taken first, by the
    same clock, outside the counted window. Returns launches, per-query
    launches and times, the kernel-tier results and one recorded call per
    kernel (the first the mesh path made)."""
    full, rt = tables["full"], tables["rt"]
    n = full.get_table_data("t").num_rows
    small, small_qs = small_order_table(seed=47)
    full.add_table("o", small)
    tables["mesh_oqs"] = mesh_order_queries(tables["cols"], tables["dictionary"]) + small_qs
    qs = mesh_queries(tables)
    single = {}
    for name, sql, _route, _ok, _bound in qs:
        run_query(rt, full, sql)  # warm
        single[name] = statistics.median(
            event_ms(lambda: run_query(rt, full, sql))[1] for _ in range(reps))

    # the mesh routes run on the provider's shards whatever the Runtime's
    # device; None sends a plan they decline to the host engine, so no
    # single-card launch mixes into the mesh path's counts
    mesh_rt = Runtime(device=None)
    t0 = time.perf_counter()
    provider = MeshTableProvider(n_shards=MESH_SHARDS, device="cuda")
    for name in ("t", "d1", "d2", "o"):
        provider.add_table(name, full.get_table_data(name))
    mesh = provider.mesh
    check(mesh.devices == [device] * MESH_SHARDS or torch.cuda.device_count() > 1,
          f"mesh devices {mesh.devices}")
    per_query, first_calls = {}, {}
    zero_launch_counts()
    for name, sql, route, ok, bound in qs:
        before, counters = launch_counts(), _mesh_counters()
        # the first run, untimed, is the one whose kernel calls are
        # recorded (the first of each kernel is kept) and whose exchange
        # is tallied
        with distributed.exchange_tally(mesh) as tally, _RecordedCalls() as rec:
            res = run_query(mesh_rt, provider, sql)
            torch.cuda.synchronize()
        for kernel, kw in rec.calls:
            first_calls.setdefault(kernel, (name, kw))
        rec.calls.clear()
        moved = tally.bytes()
        check(ok(res.rows), f"{name}: mesh rows or their order differ from the numpy answer")
        check(0 < moved <= bound, f"{name}: exchange of {moved} bytes > {bound}")
        # warm runs, timed as the single-card route was (no recorder):
        # device bytes a run allocates beyond what is held (the columns
        # of both providers and the recorded first calls)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            res, ms = event_ms(lambda: run_query(mesh_rt, provider, sql))
            times.append(ms)
            check(ok(res.rows), f"{name}: mesh rows differ on a repeat")
        peak = torch.cuda.max_memory_allocated() - held
        runs = reps + 1
        delta = [b - a for a, b in zip(counters, _mesh_counters())]
        want = [runs * (route == r) for r in range(3)] + [runs * (route >= 3),
                                                          runs * (route == 3)]
        check(delta == want, f"{name}: mesh route counters {delta}, expected {want}")
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(all(c % runs == 0 for c in launched.values()),
              f"{name}: launches {launched} differ between runs")
        per_query[name] = dict(
            mesh_ms=statistics.median(times), single_card_ms=single[name],
            exchange_bytes=moved, exchange_by_op=tally.by_op(), exchange_bound=bound,
            held_bytes=held, peak_bytes_beyond_held=peak,
            launches={k: c // runs for k, c in launched.items() if c})
        if route >= 3:
            per_query[name]["sort"] = "sample sort" if route == 3 else "compare-split"
            per_query[name]["rows"] = len(res.rows)
        log(f"phase 6: {name}: mesh {per_query[name]['mesh_ms']:.3f} ms, single card"
            f" {single[name]:.3f} ms (CUDA events, median of {reps}); exchange {moved}"
            f" bytes (bound {bound}); launches a run {per_query[name]['launches']}"
            + (f"; {per_query[name]['sort']}" if route >= 3 else ""))
    log(f"phase 6: {len(per_query)} queries over {MESH_SHARDS} shards of"
        f" {provider.padded_rows(n) // MESH_SHARDS} rows equal to numpy in"
        f" {time.perf_counter() - t0:.1f} s")
    tier = kernel_tier(device, mesh, n, reps)
    launches = launch_counts()
    for name in ("groupby_agg", "groupby_multi_agg", "extract_ge", "dim_join_gid",
                 "probe_join_gid", "hash_groupby"):
        check(launches[name] > 0, f"{name}: not launched on the mesh path")
    log(f"phase 6: launches on the mesh path {launches}")
    return dict(launches=launches, per_query=per_query, kernel_tier=tier,
                first_calls=first_calls)


def mesh_shapes(first_calls, phase="phase 6", where="mesh"):
    """Each kernel's first call on the mesh path (a shard's rows), held
    against its plain version (tolerance 0) and timed."""
    out = {}
    for kernel, (query, kw) in first_calls.items():
        label = f"{where} {query}"
        if kernel == "extract_ge":  # 20 calls: a 2^22-row call is about the host's time
            res = check_and_time_extract(label, kw, 20)
        elif kernel == "hash_groupby":
            res = check_and_time_hash(label, kw, 3)
        elif kernel in ("dim_join_gid", "probe_join_gid"):
            res = check_and_time_join(kernel, label, kw, 5)
        else:
            res = check_and_time(kernel, label, kw, 5)
            res.update(b1_library_ms(kw) if kernel == "groupby_agg" else b2_library_ms(kw))
        out[kernel] = dict(query=query, **res)
    log(f"{phase}: {len(out)} kernels' first {where} calls equal to their plain versions"
        f" (tolerance 0)")
    return out


# -- phase 7: the process mesh ----------------------------------------------------
#
# Phase 6's kernel tier again, its MESH_SHARDS shards of 2^24 rows driven by
# MULTIHOST_PROCESSES processes (parallel/multihost.py: two shards a
# process), each a fresh interpreter running this script with
# MULTIHOST_FLAG. On one card both processes share it: NCCL refuses two
# ranks on one card, so they exchange through gloo, their CUDA tensors
# staged through pinned host memory, and the times measure the tier's cost
# and that staging, not scaling. With two cards or more the same runs once
# more over NCCL, one process a card.

MULTIHOST_PROCESSES = 2
MULTIHOST_FLAG = "--multihost-worker"
MULTIHOST_TIMEOUT_S = 420  # a worker still running then is killed, and the script fails
MULTIHOST_OPS = {"gather_lengths", "result_broadcast"}  # ops of a process mesh alone


def multihost_worker(rank, world, port, backend, tally_path, out_path):
    """One process of phase 7: join the group, build the tier's tables on
    its shards, run every call once (its kernels' first calls recorded,
    its result checked against numpy on this process's shards and the
    replicated outputs) and MESH_REPS times more between barriers (host
    clock to a synchronise), then hold the first calls against their
    plain versions. Process 0 checks that every call's exchange bytes, by
    op and summed over the processes, equal phase 6's. Writes its numbers
    as JSON to ``out_path``."""
    multihost.init_multihost(f"127.0.0.1:{port}", world, rank, backend=backend,
                             timeout_s=MULTIHOST_TIMEOUT_S)
    for name in _build.sources():
        _build.load(name)
    mesh = multihost.global_mesh(MESH_SHARDS // world, "cuda")
    device = mesh.root
    log(f"phase 7: process {rank} of {world} ({backend}) drives shards {mesh.local} on {device}")
    calls = tier_calls(device, mesh, N_ROWS)
    barrier = torch.distributed.barrier
    zero_launch_counts()
    first_calls, out = {}, {}
    for name, (fn, ok, _bound) in calls.items():
        before = launch_counts()
        barrier()
        with distributed.exchange_tally(mesh) as tally, _RecordedCalls() as rec:
            res = fn()
            torch.cuda.synchronize()
        for kernel, kw in rec.calls:
            first_calls.setdefault(kernel, (name, kw))
        rec.calls.clear()
        check(ok(res), f"{name}: process {rank}: result differs from the numpy answer")
        del res
        runs = []
        for _ in range(MESH_REPS):
            barrier()
            with distributed.exchange_tally(mesh) as warm:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            runs.append(dict(ms=ms, stage_ms=warm.stage_ms(), cross=warm.cross_bytes()))
        after = launch_counts()
        out[name] = dict(exchange_bytes=tally.by_op(), runs=runs,
                         launches={k: (after[k] - before[k]) // (MESH_REPS + 1) for k in after
                                   if after[k] > before[k]})
        log(f"phase 7: process {rank}: {name}: {statistics.median(r['ms'] for r in runs):.3f}"
            f" ms (median of {MESH_REPS}), exchange {out[name]['exchange_bytes']} bytes,"
            f" {runs[0]['cross']} across processes, staging {runs[0]['stage_ms']:.3f} ms,"
            f" equal to numpy")
    launches = launch_counts()
    every = [None] * world
    torch.distributed.all_gather_object(every, {k: v["exchange_bytes"] for k, v in out.items()})
    if rank == 0:
        with open(tally_path) as f:
            single = json.load(f)
        for name, want in single.items():
            got = {}
            for tallies in every:
                for op, b in tallies[name].items():
                    got[op] = got.get(op, 0) + b
            check({op: b for op, b in got.items() if op not in MULTIHOST_OPS} == want
                  and set(got) - set(want) <= MULTIHOST_OPS,
                  f"{name}: process mesh exchange {got} bytes, phase 6 {want}")
        log(f"phase 7: every call's exchange bytes, summed over {world} processes, equal"
            f" phase 6's op by op")
    shapes = mesh_shapes(first_calls, "phase 7", f"process {rank}")
    with open(out_path, "w") as f:
        json.dump(dict(rank=rank, backend=backend, shards=mesh.local, calls=out,
                       launches=launches, first_calls=shapes), f)
    torch.distributed.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_multihost(backend, world, tally_path, tmp):
    """``world`` worker processes of this script on ``backend``; their logs
    printed, each killed at MULTIHOST_TIMEOUT_S. Fails unless every one
    exits 0. Returns their JSON outputs, by rank."""
    port = _free_port()
    outs = [os.path.join(tmp, f"{backend}{r}.json") for r in range(world)]
    logs = [open(os.path.join(tmp, f"{backend}{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), MULTIHOST_FLAG, str(r), str(world),
         str(port), backend, tally_path, outs[r]], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.perf_counter() + MULTIHOST_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"{backend}{r}.log")) as f:
            print(f.read(), end="", flush=True)
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"phase 7: {backend} process {r} failed or timed out"
              f" (exit {p.returncode})")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    return res


def phase_multihost(tier6):
    """Phase 7: ``multihost_worker`` in MULTIHOST_PROCESSES processes over
    gloo, and over NCCL where there is a card for each; every call's
    time (the slower process's, median of MESH_REPS) beside phase 6's,
    its exchange bytes, those that crossed processes and the staging
    time, summed over the processes."""
    torch.cuda.empty_cache()  # the workers share this card
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tally_path = os.path.join(tmp, "phase6_tally.json")
        with open(tally_path, "w") as f:
            json.dump({name: r["exchange_bytes"] for name, r in tier6.items()}, f)
        log(f"phase 7: gloo, {MULTIHOST_PROCESSES} processes on"
            f" {min(cards, MULTIHOST_PROCESSES)} card(s): NCCL refuses two ranks on one card,"
            f" so processes that share a card exchange through gloo (CUDA tensors staged"
            f" through pinned host memory)")
        runs["gloo"] = run_multihost("gloo", MULTIHOST_PROCESSES, tally_path, tmp)
        if cards >= MULTIHOST_PROCESSES:
            runs["nccl"] = run_multihost("nccl", MULTIHOST_PROCESSES, tally_path, tmp)
        else:
            log(f"phase 7: NCCL not run: {cards} card, and NCCL needs one a process")
    out = {"processes": MULTIHOST_PROCESSES, "shards": MESH_SHARDS, "rows": N_ROWS,
           "cards": cards, "nccl": "nccl" in runs, "backends": {}}
    for backend, ranks in runs.items():
        calls = {}
        for name, single in tier6.items():
            per = [r["calls"][name] for r in ranks]
            ms = [max(p["runs"][i]["ms"] for p in per) for i in range(MESH_REPS)]
            by_op = {}
            for p in per:
                for op, b in p["exchange_bytes"].items():
                    by_op[op] = by_op.get(op, 0) + b
            calls[name] = dict(
                ms=statistics.median(ms), runs_ms=ms, single_process_ms=single["ms"],
                exchange_bytes=by_op,
                cross_process_bytes=sum(p["runs"][0]["cross"] for p in per),
                stage_ms=[sum(p["runs"][i]["stage_ms"] for p in per)
                          for i in range(MESH_REPS)],
                launches={k: sum(p["launches"].get(k, 0) for p in per)
                          for k in set().union(*(p["launches"] for p in per))})
            log(f"phase 7: {backend}: {name}: {calls[name]['ms']:.3f} ms (phase 6:"
                f" {single['ms']:.3f}), {calls[name]['cross_process_bytes']} bytes across"
                f" processes, staging {[f'{x:.3f}' for x in calls[name]['stage_ms']]} ms")
        launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
        out["backends"][backend] = dict(
            calls=calls, launches=launches,
            first_calls={f"process {r['rank']}": r["first_calls"] for r in ranks})
    for name in ("groupby_agg", "extract_ge", "dim_join_gid", "hash_groupby"):
        check(out["backends"]["gloo"]["launches"][name] > 0,
              f"{name}: not launched on the process mesh")
    log(f"phase 7: {len(tier6)} kernel-tier calls over {MULTIHOST_PROCESSES} processes equal"
        f" to numpy on every process in {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 8: storage -------------------------------------------------------------
#
# Phase 4's table (plus an ``id`` UINT64 primary key) written through the
# LSM table service (db/lsm.py) as cstable v0.2 segments, read back by a new
# service on the same directory as after a restart, and queried on the card
# through the same routes. The rows are cut below phase 4's 2^26 (see
# STORAGE_ROWS); the answers are phase 4's numpy answers at this size.

STORAGE_ROWS = 1 << 22  # two commits of 2^21: the host-side read of a
# primary-keyed table costs about 6 us a row (PERF.md, phase 8)
STORAGE_COMMITS = 2
STORAGE_WARM = 3  # CUDA-event timed runs of each query after its first
STORAGE_COLUMNS = [("id", SType.UINT64)] + COLUMNS


def _create_sql(name, columns, pk=None):
    types = {SType.STRING: "STRING", SType.UINT64: "UINT64", SType.INT64: "UINT64"}
    cols = ", ".join(f"{c} {types[st]}" for c, st in columns)
    return f"CREATE TABLE {name} ({cols}{f', PRIMARY KEY ({pk})' if pk else ''});"


def stored_columns(cols):
    """Phase 4's columns as the table service stores them: its schema has
    no signed integer type, so ``cat`` is kept as ``cat - CAT_LO``
    (0..99, UINT64); the expected answers are made with ``cat_lo=0``."""
    out = dict(cols)
    out["cat"] = (cols["cat"] - CAT_LO).astype(np.uint64)
    return out


def _batch(columns, arrays, lo, hi, dictionaries):
    n = hi - lo
    ones = np.ones(n, bool)
    return Relation(
        [c for c, _st in columns],
        [Column(st, arrays[c][lo:hi], ones, dictionaries.get(c)) for c, st in columns], n)


def write_storage(datadir, cols, dictionary, dims, n, commits):
    """Create the fact table and the two dimension tables in a
    DurableTableService at ``datadir`` and write them: the fact table as
    ``commits`` commits (one segment each). Returns the seconds of each
    fact commit (its batch insert included)."""
    svc = DurableTableService(datadir, arena_flush_rows=n + 1)  # commits by hand
    host = Runtime(device=None)
    txn = host.new_transaction(svc)
    for sql in (_create_sql("t", STORAGE_COLUMNS, pk="id"),
                _create_sql("d1", [("k", SType.UINT64), ("region", SType.STRING)]),
                _create_sql("d2", [("k", SType.UINT64), ("region", SType.STRING)])):
        host.build_query_plan(txn, sql).execute(0)
    arrays = dict(cols, id=np.arange(n, dtype=np.uint64))
    secs = []
    for c in range(commits):
        lo, hi = c * n // commits, (c + 1) * n // commits
        t0 = time.perf_counter()
        svc.tables["t"].insert_batch(_batch(STORAGE_COLUMNS, arrays, lo, hi, {"k": dictionary}))
        svc.tables["t"].commit()
        secs.append(time.perf_counter() - t0)
    regions = np.array([b"r%04d" % i for i in range(N_REGIONS)], dtype=object)
    for (name, (ordinal, region)), mult in zip(dims.items(), (DIM_MULT, BIG_DIM_MULT)):
        d = {"k": ordinal.astype(np.uint64) * mult + 3, "region": region.astype(np.int32)}
        svc.tables[name].insert_batch(_batch(
            [("k", SType.UINT64), ("region", SType.STRING)], d, 0, len(ordinal),
            {"region": regions}))
        svc.tables[name].commit()
    check([len(svc.tables[x]._segments) for x in ("t", "d1", "d2")] == [commits, 1, 1],
          "phase 8: one segment a commit")
    return secs


def check_stored_relation(rel, n):
    """What the routes are handed after the merge of the segments: every
    column C-contiguous in its SType's dtype, ``k`` int32 ids over one
    dictionary of N_KEYS strings."""
    check(rel.num_rows == n, f"phase 8: {rel.num_rows} rows read, {n} written")
    for name, c in zip(rel.names, rel.columns):
        check(c.data.dtype == dtype_for(c.stype) and c.data.flags.c_contiguous
              and c.valid.flags.c_contiguous, f"phase 8: column {name}: {c.data.dtype}")
    k = rel.columns[rel.names.index("k")]
    check(k.stype == SType.STRING and k.data.dtype == np.int32
          and len(k.dictionary) == N_KEYS, "phase 8: the string key after the merge")


def storage_stream(svc, rt, n, cols):
    """The streaming cursor over the reopened table, before anything built
    its merged view: SELECT id, v WHERE cat < 0 yields the rows of
    ``execute`` (and of numpy), each segment read once, and no more than
    one segment's relation alive while rows are pulled."""
    table = svc.tables["t"]
    check(table._relation_cache is None, "phase 8: merged view built before the stream")
    sql = f"select id, v from t where cat < {-CAT_LO};"  # cat < 0 before the shift
    reads, alive_max = [], 0
    read = table._read_segment

    def counted(seg, fd=None):
        rel = read(seg, fd=fd)
        reads.append(weakref.ref(rel))
        return rel

    table._read_segment = counted
    t0 = time.perf_counter()
    try:
        res = rt.build_query_plan(rt.new_transaction(svc), sql).execute_stream(0)
        check(type(res).__name__ == "StreamingResultList", "phase 8: no streaming cursor")
        streamed = []
        for i, row in enumerate(res.rows):
            streamed.append(row)
            if i % 4096 == 0:
                alive_max = max(alive_max, sum(r() is not None for r in reads))
    finally:
        del table._read_segment
    stream_s = time.perf_counter() - t0
    check(len(reads) == len(table._segments) and alive_max <= 1,
          f"phase 8: {len(reads)} segment reads, {alive_max} segments alive at once")
    check(table._relation_cache is None, "phase 8: the stream built the merged view")
    keep = cols["cat"][:n] < 0
    want = [[str(i), str(v)] for i, v in zip(np.nonzero(keep)[0], cols["v"][:n][keep])]
    check(streamed == want, "phase 8: streamed rows differ from the numpy answer")
    t0 = time.perf_counter()
    got = rt.build_query_plan(rt.new_transaction(svc), sql).execute(0).rows
    read_s = time.perf_counter() - t0
    check(got == streamed, "phase 8: execute and execute_stream differ")
    log(f"phase 8: stream of {len(streamed)} rows in {stream_s:.1f} s, {len(reads)} segment"
        f" reads, at most {alive_max} alive; execute (the merged view) {read_s:.1f} s")
    return dict(rows=len(streamed), stream_s=stream_s, execute_s=read_s,
                segments_alive_max=alive_max)


def _warm_event_ms(rt, provider, sql, expected_rows, counter):
    """STORAGE_WARM runs between CUDA events, each equal to the first
    run's rows and raising the route counter ``counter`` once."""
    before = getattr(device_exec, counter)
    ms = []
    for _ in range(STORAGE_WARM):
        res, t = event_ms(lambda: run_query(rt, provider, sql))
        check(res.rows == expected_rows, f"phase 8: {sql}: rows differ on a warm run")
        ms.append(t)
    rose = getattr(device_exec, counter) - before
    check(rose == STORAGE_WARM, f"phase 8: {sql}: {counter} rose {rose}")
    return statistics.median(ms)


def _route_counter(path, q):
    """The route counter a query of phase 4's lists must raise."""
    if path == "group_by":
        return "FUSED_GROUPBY_COUNT" if q[3] else "MULTI_SUM_GROUPBY_COUNT"
    if path == "order_by":
        return "SCAN_TOPK_COUNT" if q[2] == "topk" else "SCAN_ORDER_COUNT"
    return {"general_group_by": "GENERAL_GROUPBY_COUNT", "join": "JOIN_GROUPBY_COUNT"}[path]


def storage_queries(rt, svc, cols, dictionary, dims, n):
    """Phase 4's four paths over the stored table, each with the launch
    counts set to 0 just before it and read just after; every query's
    first run (which uploads its columns) checked by the path's own
    function, then STORAGE_WARM runs timed by CUDA events."""
    c = dict(cols, cat=cols["cat"] - CAT_LO)
    gqs = queries(c, dictionary, cat_lo=0)
    hqs = general_queries(c, dictionary, n, cat_lo=0)
    oqs = order_queries(cols, dictionary, n)
    jqs = join_queries(cols, dims, n)
    per_query, launches, first = {}, {}, {}
    paths = (("group_by", groupby_path, gqs), ("general_group_by", general_path, hqs),
             ("order_by", order_path, oqs), ("join", join_path, jqs))
    for path, fn, qs in paths:
        zero_launch_counts()
        e2e, _per, calls = fn(rt, svc, qs, 2)  # the first run uploads; one warm run
        launches[path] = launch_counts()
        for q in qs:
            name, sql = q[0], q[1]
            recorded = calls[name] if isinstance(calls[name], list) else [calls[name]]
            for kernel, kw in recorded:
                first.setdefault(kernel, (name, kw))
            rows = run_query(rt, svc, sql).rows
            warm = _warm_event_ms(rt, svc, sql, rows, _route_counter(path, q))
            per_query[name] = dict(first_ms=e2e[name]["first_ms"], warm_ms=warm)
    for path, kernels in (("group_by", ("groupby_agg", "groupby_multi_agg")),
                          ("general_group_by", ("hash_groupby",)),
                          ("order_by", ("groupby_agg", "extract_ge")),
                          ("join", ("dim_join_gid", "probe_join_gid", "groupby_agg",
                                    "groupby_multi_agg", "hash_groupby"))):
        for k in kernels:
            check(launches[path][k] > 0, f"phase 8: {k} not launched on the {path} path")
    return per_query, launches, first, gqs


def storage_compaction(rt, svc, gq):
    """compact() folds the segments into one; the headline GROUP BY then
    gives the same rows, and its first run uploads the new relation's
    columns once (a second run reuses the same tensors)."""
    name, sql, _kernel, _fused, expected = gq
    table = svc.tables["t"]
    old = svc.get_table_data("t")
    t0 = time.perf_counter()
    table.compact()
    compact_s = time.perf_counter() - t0
    check(len(table._segments) == 1, "phase 8: compaction left several segments")
    t0 = time.perf_counter()
    rel = svc.get_table_data("t")
    read_s = time.perf_counter() - t0
    check(rel is not old, "phase 8: the merged view survived the compaction")
    del old
    used = [rel.columns[rel.names.index(x)] for x in ("k", "v")]
    check(all(getattr(c, "_device_cache", None) is None for c in used),
          "phase 8: columns on the card before the first query")
    res, first_ms = event_ms(lambda: run_query(rt, svc, sql))
    check(sorted(res.rows) == expected, f"phase 8: {name} after compaction differs")
    cached = [c._device_cache[str(rt.device)] for c in used]
    warm = _warm_event_ms(rt, svc, sql, res.rows, "FUSED_GROUPBY_COUNT")
    check(all(c._device_cache[str(rt.device)] is d for c, d in zip(used, cached)),
          "phase 8: a warm run uploaded the columns again")
    log(f"phase 8: compaction {compact_s:.1f} s, read {read_s:.1f} s; {name} after it:"
        f" first {first_ms:.3f} ms (uploads), warm {warm:.3f} ms, same rows")
    return dict(compact_s=compact_s, read_s=read_s, first_ms=first_ms, warm_ms=warm)


def storage_query_cache(rt, datadir, dims):
    """QueryCache over a CSTableScanProvider on the big dimension table's
    segment: the second identical GROUP BY is a hit, launches no kernel,
    takes no route and gives the same rows (equal to numpy)."""
    seg_dir = os.path.join(datadir, "d2")
    (seg,) = [f for f in os.listdir(seg_dir) if f.endswith(".cst")]
    provider = CSTableScanProvider("d2", os.path.join(seg_dir, seg))
    cache = QueryCache(os.path.join(datadir, "qcache"))
    sql = "select region, count(1) from d2 group by region;"
    _ordinal, region = dims["d2"]
    occ, cnt, _ = _bincounts(region, N_REGIONS, np.ones(len(region), bool))
    expected = sorted(["r%04d" % o, str(int(a))] for o, a in zip(occ, cnt))
    out = {}
    for run in ("miss", "hit"):
        before, route = launch_counts(), device_exec.FUSED_GROUPBY_COUNT
        txn = rt.new_transaction(provider, query_cache=cache)
        res, out[f"{run}_ms"] = event_ms(
            lambda: rt.build_query_plan(txn, sql).execute(0))
        check(sorted(res.rows) == expected, f"phase 8: query cache {run}: rows")
        launched = sum(launch_counts().values()) - sum(before.values())
        took = device_exec.FUSED_GROUPBY_COUNT - route
        check((launched, took) == ((1, 1) if run == "miss" else (0, 0)),
              f"phase 8: query cache {run}: {launched} launches, route taken {took}")
        check(len(os.listdir(cache.cache_dir)) == 1, f"phase 8: query cache {run}: entries")
    log(f"phase 8: query cache: miss {out['miss_ms']:.3f} ms (one launch), hit"
        f" {out['hit_ms']:.3f} ms (none), same rows")
    return out


def phase_storage(device):
    """Phase 8. Returns the numbers of the {"storage": ...} line, the
    launches of each path and the first call of each kernel on them."""
    t0 = time.perf_counter()
    codec = native._try_load()
    check(codec is not None, "phase 8: the storage codec is not loaded")
    log(f"phase 8: storage codec {codec._name}")
    n = STORAGE_ROWS
    cols, dictionary = make_table(n, seed=44)
    dims = make_dims(seed=43)
    stored = stored_columns(cols)
    with tempfile.TemporaryDirectory() as datadir:
        write_s = write_storage(datadir, stored, dictionary, dims, n, STORAGE_COMMITS)
        seg_bytes = sum(os.path.getsize(os.path.join(datadir, "t", f))
                        for f in os.listdir(os.path.join(datadir, "t")) if f.endswith(".cst"))
        log(f"phase 8: {n} rows written as {STORAGE_COMMITS} commits"
            f" ({[f'{s:.1f}' for s in write_s]} s), segments {seg_bytes} bytes")
        t1 = time.perf_counter()
        svc = DurableTableService(datadir)  # a restart: a new service on the directory
        reopen_s = time.perf_counter() - t1
        rt = Runtime(plan_cache=PlanCache(), device=device)
        stream = storage_stream(svc, rt, n, cols)
        check_stored_relation(svc.get_table_data("t"), n)
        per_query, launches, first, gqs = storage_queries(rt, svc, cols, dictionary, dims, n)
        compaction = storage_compaction(rt, svc, gqs[0])
        qcache = storage_query_cache(rt, datadir, dims)
        svc.tables["t"]._relation_cache = None
        del svc
    out = dict(rows=n, commits=STORAGE_COMMITS, segment_bytes=seg_bytes,
               write_s_per_commit=write_s, reopen_s=reopen_s, stream=stream,
               queries=per_query, compaction=compaction, query_cache=qcache,
               native_codec=codec._name,
               phase_s=time.perf_counter() - t0)
    log(f"phase 8: {len(per_query)} queries over the stored table equal to numpy at {n}"
        f" rows in {out['phase_s']:.1f} s")
    return out, launches, first


# -- phase 9: the device fuzz corpora ----------------------------------------------
#
# The seeds of the port's CPU fuzz tests (tests/test_torch_fuzz_groupby.py,
# test_torch_order_routes.py, test_torch_join_routes.py,
# test_torch_mesh_sql.py), their tables and queries made by copies of the
# tests' generators (this script imports nothing of the tests; a CPU test
# holds the copies to the originals): every query under Runtime(device=
# "cuda"), Runtime(device="cpu") (the plain versions) and the host engine
# (device=None), the ResultLists equal at tolerance 0 (the floats are
# multiples of 1/64), with the CPU tests' floors on the route counters.

FUZZ_SIZES = [0, 1, 7, 100, 3000, 20000]
FUZZ_CARDS = [1, 2, 17, 257, 4099]


def _provider_of(tables):
    p = RelationTableProvider()
    for name, rel in tables.items():
        p.add_table(name, rel)
    return p


def fuzz_group_table(rng):
    """tests/test_fuzz_device_parity.py:_make_table."""
    n = rng.choice(FUZZ_SIZES)
    card = rng.choice(FUZZ_CARDS)
    npr = np.random.default_rng(rng.randrange(1 << 30))
    k1 = npr.integers(0, card, max(n, 1))[:n].astype(np.uint64)
    k2 = npr.integers(-20, 20, max(n, 1))[:n].astype(np.int64)
    v = npr.integers(0, 10_000, max(n, 1))[:n].astype(np.uint64)
    if n and rng.random() < 0.3:
        hot = npr.integers(0, n, max(n // 50, 1))
        v[hot] = np.uint64(1 << 63) + v[hot]
    v_valid = npr.random(max(n, 1))[:n] < (1.0 if rng.random() < 0.5 else 0.85)
    f = (npr.integers(-4096, 4096, max(n, 1))[:n] / 64.0).astype(np.float64)
    f_valid = npr.random(max(n, 1))[:n] < (1.0 if rng.random() < 0.5 else 0.9)
    return {"t": Relation(
        ["k1", "k2", "v", "f"],
        [Column(SType.UINT64, k1, np.ones(n, bool)),
         Column(SType.INT64, k2, np.ones(n, bool)),
         Column(SType.UINT64, np.where(v_valid, v, 0).astype(np.uint64), v_valid.copy()),
         Column(SType.FLOAT64, np.where(f_valid, f, 0.0), f_valid.copy())],
        n)}


FUZZ_GROUP_EXPRS = ["k1", "k2", "k1 % 13", "k1 % 3", "if(k2 > 0, 1, 0)", "k1 + 1"]
FUZZ_AGG_EXPRS = ["count(1)", "count(v)", "sum(v)", "sum(k2)", "sum(v + 1)", "min(k2)",
                  "max(k2)", "min(f)", "max(f)", "sum(f)", "mean(f)", "mean(k2)",
                  "count_distinct(v)", "sum(f * 2.0)", "max(v)"]
FUZZ_WHERE_TERMS = ["v < 5000", "k1 > 5", "k2 >= 0", "f > 0.0", "v % 7 = 1", "k2 < 10"]


def fuzz_group_query(rng):
    """tests/test_fuzz_device_parity.py:_gen_query."""
    n_keys = rng.choice([0, 1, 1, 2])
    keys = rng.sample(FUZZ_GROUP_EXPRS, n_keys)
    n_aggs = rng.randint(1, 3)
    aggs = rng.sample(FUZZ_AGG_EXPRS, n_aggs)
    q = f"select {', '.join(keys + aggs)} from t"
    if rng.random() < 0.6:
        terms = rng.sample(FUZZ_WHERE_TERMS, rng.randint(1, 3))
        clause = terms[0]
        for t in terms[1:]:
            clause += f" {rng.choice(['and', 'or'])} {t}"
        q += " where " + clause
    if keys:
        q += " group by " + ", ".join(keys)
        if rng.random() < 0.3:
            agg = rng.choice(aggs)
            thr = rng.choice([0, 1, 100, 100000])
            op = rng.choice([">", ">=", "<", "!="])
            q += f" having {agg} {op} {thr}"
    ordinals = ", ".join(f"{i + 1}{' desc' if rng.random() < 0.3 else ''}"
                         for i in range(len(keys) + n_aggs))
    q += f" order by {ordinals}"
    if rng.random() < 0.3:
        q += f" limit {rng.choice([0, 1, 5, 1000])}"
    return q + ";"


FUZZ_ROUTE_AGGS = ["count(1)", "count(v)", "sum(v)", "sum(k2)", "sum(v + 1)", "sum(k1)",
                   "sum(v) + count(1)"]
FUZZ_ROUTE_WHERE = ["v < 5000", "k1 > 5", "k2 >= 0", "v % 7 = 1", "k2 < 10", "v = 77",
                    "5000 >= v"]


def fuzz_route_case(seed):
    """tests/test_torch_fuzz_groupby.py:_route_case."""
    rng = random.Random(5000 + seed)
    tables = fuzz_group_table(rng)
    key = rng.choice(["k1", "k2"])
    aggs = rng.sample(FUZZ_ROUTE_AGGS, rng.randint(1, 3))
    q = f"select {key}, {', '.join(aggs)} from t"
    if rng.random() < 0.7:
        terms = rng.sample(FUZZ_ROUTE_WHERE, rng.randint(1, 3))
        clause = terms[0]
        for t in terms[1:]:
            clause += f" {rng.choice(['and', 'or'])} {t}"
        q += " where " + clause
    q += f" group by {key} order by 1"
    if rng.random() < 0.3:
        q += f" limit {rng.choice([1, 5, 1000])}"
    return tables, q + ";"


FUZZ_ORDER_SIZES = [1, 3, 50, 700, 5000]


def fuzz_order_table(rng):
    """tests/test_fuzz_device_order.py:_make_table."""
    n = rng.choice(FUZZ_ORDER_SIZES)
    npr = np.random.default_rng(rng.randrange(1 << 30))
    u = npr.integers(0, 9, n).astype(np.uint64)
    if n > 2 and rng.random() < 0.5:
        hot = npr.integers(0, n, max(n // 20, 1))
        u[hot] = np.uint64(0xFFFFFFFFFFFFFFFF)
    u_valid = npr.random(n) >= (0.2 if rng.random() < 0.5 else 0.0)
    i = npr.integers(-50, 50, n).astype(np.int64)
    if n > 2 and rng.random() < 0.3:
        i[npr.integers(0, n, 2)] = np.iinfo(np.int64).min
        i[npr.integers(0, n, 2)] = np.iinfo(np.int64).max
    f = (npr.integers(-512, 512, n) / 64.0).astype(np.float64)
    if n > 4 and rng.random() < 0.6:
        f[npr.integers(0, n, max(n // 30, 1))] = np.nan
        f[npr.integers(0, n, max(n // 30, 1))] = -0.0
        f[npr.integers(0, n, 1)] = np.inf
        f[npr.integers(0, n, 1)] = -np.inf
    f_valid = npr.random(n) >= (0.15 if rng.random() < 0.5 else 0.0)
    labels = [b"", b"NULL", b"a", b"Zz", b"mid", b"\xc3\xa9"]
    sv = [labels[k] for k in npr.integers(0, len(labels), n)]
    if rng.random() < 0.5:
        null_at = npr.random(n) < 0.25
        sv = [None if m else v for v, m in zip(sv, null_at)]
    return {"t": Relation(
        ["u", "i", "f", "s"],
        [Column(SType.UINT64, np.where(u_valid, u, 0).astype(np.uint64), u_valid),
         Column(SType.INT64, i, np.ones(n, bool)),
         Column(SType.FLOAT64, np.where(f_valid, f, 0.0), f_valid),
         Column.from_strings(sv)],
        n)}


FUZZ_KEY_EXPRS = ["u", "i", "f", "s", "u + i", "i * 2", "f + 1.5", "u % 4"]
FUZZ_ORDER_WHERE = ["u < 7", "i >= 0", "f < 2.0", "u % 2 = 0", "i + u > 3"]


def fuzz_order_query(rng):
    """tests/test_fuzz_device_order.py:_gen_order_query."""
    nk = rng.randint(1, 3)
    keys = rng.sample(FUZZ_KEY_EXPRS, nk)
    specs = ", ".join(
        f"{k}{' desc' if rng.random() < 0.4 else (' asc' if rng.random() < 0.3 else '')}"
        for k in keys)
    q = "select u, i, f, s, u + i as x from t"
    if rng.random() < 0.6:
        terms = rng.sample(FUZZ_ORDER_WHERE, rng.randint(1, 2))
        q += " where " + f" {rng.choice(['and', 'or'])} ".join(terms)
    q += f" order by {specs}"
    if rng.random() < 0.6:
        q += f" limit {rng.choice([0, 1, 2, 9, 100, 10000])}"
        if rng.random() < 0.4:
            q += f" offset {rng.choice([0, 1, 5, 50])}"
    return q + ";"


def topk_table(n, seed):
    """tests/test_device_topk.py:_table (with NULLs)."""
    npr = np.random.default_rng(seed)
    u = npr.integers(0, 50, n).astype(np.uint64)
    i = npr.integers(-25, 25, n).astype(np.int64)
    f = (npr.integers(-256, 256, n) / 32.0).astype(np.float64)
    b = npr.random(n) < 0.5
    sv = [[b"alpha", b"Beta", b"NULL", b"", b"zeta", b"m"][k] for k in npr.integers(0, 6, n)]
    null_at = npr.random(n) < 0.2
    u_valid = ~(npr.random(n) < 0.15)
    f_valid = ~(npr.random(n) < 0.15)
    sv = [None if m else v for v, m in zip(sv, null_at)]
    return {"t": Relation(
        ["u", "i", "f", "b", "s"],
        [Column(SType.UINT64, np.where(u_valid, u, 0).astype(np.uint64), u_valid),
         Column(SType.INT64, i, np.ones(n, bool)),
         Column(SType.FLOAT64, np.where(f_valid, f, 0.0), f_valid),
         Column(SType.BOOL, b, np.ones(n, bool)),
         Column.from_strings(sv)],
        n)}


def topk_case(seed):
    """tests/test_torch_order_routes.py:test_scan_topk_fuzz_port_matches_jax_host_engine."""
    keys = ["u", "i", "f", "s", "b"]
    wheres = ["u < 30", "i >= 0", "f > 0.0", "u % 3 = 1"]
    rng = random.Random(4000 + seed)
    tables = topk_table(rng.choice([1, 9, 100, 1500]), seed)
    nk = rng.choice([1, 1, 2, 3])
    order = ", ".join(f"{k}{' desc' if rng.random() < 0.4 else ''}" for k in rng.sample(keys, nk))
    rest = ", ".join(k for k in keys if k not in order)
    q = "select u, i, f, b, s from t"
    if rng.random() < 0.6:
        q += " where " + rng.choice(wheres)
    q += f" order by {order}, {rest}"
    if rng.random() < 0.75:
        q += f" limit {rng.choice([1, 3, 17, 400])}"
        if rng.random() < 0.3:
            q += f" offset {rng.choice([1, 5, 50])}"
    return tables, q + ";"


def fuzz_join_tables(rng):
    """tests/test_fuzz_device_parity.py:_make_join_tables."""
    n = rng.choice([0, 1, 100, 5000, 20000])
    d = rng.choice([1, 16, 257, 1024])
    npr = np.random.default_rng(rng.randrange(1 << 30))
    dk = npr.permutation(d * 3)[:d].astype(np.uint64)
    dattr = npr.integers(0, 9, max(d, 1))[:d].astype(np.uint64)
    fk = dk[npr.integers(0, d, max(n, 1))][:n].astype(np.uint64)
    if n and rng.random() < 0.5:
        miss = npr.random(n) < 0.1
        fk = np.where(miss, fk + np.uint64(d * 5), fk)
    fv = npr.integers(0, 1000, max(n, 1))[:n].astype(np.uint64)
    fv_valid = npr.random(max(n, 1))[:n] < (1.0 if rng.random() < 0.5 else 0.9)
    ff = (npr.integers(-2048, 2048, max(n, 1))[:n] / 64.0).astype(np.float64)
    return {
        "facts": Relation(
            ["k", "v", "f"],
            [Column(SType.UINT64, fk, np.ones(n, bool)),
             Column(SType.UINT64, np.where(fv_valid, fv, 0).astype(np.uint64), fv_valid.copy()),
             Column(SType.FLOAT64, ff, np.ones(n, bool))],
            n),
        "dims": Relation(
            ["k", "attr"],
            [Column(SType.UINT64, dk, np.ones(d, bool)),
             Column(SType.UINT64, dattr, np.ones(d, bool))],
            d),
    }


FUZZ_JOIN_AGGS = ["count(1)", "sum(facts.v)", "min(facts.v)", "max(facts.v)", "sum(facts.f)",
                  "mean(facts.f)", "count(facts.v)"]
FUZZ_JOIN_WHERES = ["facts.v < 500", "facts.f > 0.0", "facts.v % 3 = 0"]


def fuzz_join_query(rng):
    """tests/test_fuzz_device_parity.py:_gen_join_query."""
    aggs = rng.sample(FUZZ_JOIN_AGGS, rng.randint(1, 3))
    jt = "join" if rng.random() < 0.8 else "left join"
    q = f"select dims.attr, {', '.join(aggs)} from facts {jt} dims on facts.k = dims.k"
    if rng.random() < 0.5:
        q += " where " + rng.choice(FUZZ_JOIN_WHERES)
    q += " group by dims.attr"
    ordinals = ", ".join(str(i + 1) for i in range(1 + len(aggs)))
    return q + f" order by {ordinals};"


FUZZ_ROUTABLE_AGGS = ["count(1)", "sum(facts.v)", "count(facts.v)", "sum(facts.v + 3)",
                      "sum(facts.v * 2)", "sum(facts.v) + count(1)"]
FUZZ_ROUTABLE_WHERES = ["facts.v < 500", "facts.v % 3 = 0", "facts.f > 0.0",
                        "facts.v >= 100 and facts.v < 900"]


def routable_join_query(rng):
    """tests/test_torch_join_routes.py:_gen_routable_query."""
    aggs = rng.sample(FUZZ_ROUTABLE_AGGS, rng.randint(1, 4))
    q = f"select dims.attr, {', '.join(aggs)} from facts join dims on facts.k = dims.k"
    if rng.random() < 0.6:
        q += " where " + rng.choice(FUZZ_ROUTABLE_WHERES)
    q += " group by dims.attr"
    if rng.random() < 0.5:
        q += " order by " + ", ".join(str(i + 1) for i in range(1 + len(aggs)))
    return q + ";"


def _with_rng(make_tables, make_query, base):
    def case(seed):
        rng = random.Random(base + seed)
        tables = make_tables(rng)
        return tables, make_query(rng)
    return case


_GROUP_ROUTES = ("FUSED_GROUPBY_COUNT", "MULTI_SUM_GROUPBY_COUNT", "GENERAL_GROUPBY_COUNT")
_ORDER_ROUTES = ("SCAN_TOPK_COUNT", "SCAN_ORDER_COUNT")


class Corpus:
    """One fuzz corpus of phase 9: ``seeds`` seeds of ``case(seed) ->
    (tables, sql)``; the route counters a seed may raise; the CPU test's
    floor, on the route runs summed over the first ``upto`` seeds (``by
    == "runs"``) or on the seeds that took a route (``"seeds"``); the
    first ``mesh_seeds`` seeds also run over the mesh; ``expect(tables,
    sql)``, where given, is the route runs each seed must show."""

    def __init__(self, seeds, case, counters, by, floor, upto=None, mesh_seeds=0,
                 expect=None):
        self.seeds, self.case, self.counters = seeds, case, counters
        self.by, self.floor, self.upto = by, floor, upto or seeds
        self.mesh_seeds, self.expect = mesh_seeds, expect


def _join_expect(tables, sql):
    """test_join_fuzz_port_matches_jax_host_engine: only a left join or an
    empty fact table keeps a plan off the route."""
    return int(" left join " not in sql and tables["facts"].num_rows > 0)


FUZZ_CORPORA = {
    "groupby": Corpus(60, _with_rng(fuzz_group_table, fuzz_group_query, 1000), _GROUP_ROUTES,
                      "runs", 24, upto=40, mesh_seeds=40),
    "groupby_route": Corpus(50, fuzz_route_case, _GROUP_ROUTES, "runs", 12),
    "order": Corpus(30, _with_rng(fuzz_order_table, fuzz_order_query, 3000), _ORDER_ROUTES,
                    "seeds", 15, mesh_seeds=30),
    "scan_topk": Corpus(25, topk_case, _ORDER_ROUTES, "seeds", 25,
                        expect=lambda tables, sql: 1),
    "join": Corpus(20, _with_rng(fuzz_join_tables, fuzz_join_query, 5000),
                   ("JOIN_GROUPBY_COUNT",), "runs", 10, expect=_join_expect),
    "join_routable": Corpus(20, _with_rng(fuzz_join_tables, routable_join_query, 7000),
                            ("JOIN_GROUPBY_COUNT",), "runs", 10, expect=_join_expect),
}
FUZZ_MESH_SHARDS = 4


def _outcome(rt, provider, sql):
    """(columns, rows), or the error by type and message: a few generated
    queries are type errors and must be so under every device."""
    try:
        res = rt.build_query_plan(rt.new_transaction(provider), sql).execute(0)
        return res.columns, res.rows
    except Exception as e:  # noqa: BLE001 - compared by name and message
        return ("error", type(e).__name__, str(e))


def fuzz_corpus(name, runtimes):
    """One corpus: every seed under each Runtime of ``runtimes`` (the
    card's first, the host engine's last) and, for its mesh seeds, over a
    MeshTableProvider of FUZZ_MESH_SHARDS shards on the card (served by
    the host engine's Runtime): every outcome equal to the host engine's,
    each Runtime taking the same routes. Returns the counts."""
    corpus = FUZZ_CORPORA[name]
    host_rt = runtimes[-1]
    runs = routed = errors = 0
    mesh = [0] * 3  # seeds on a mesh route, on a mesh sort, on the sample sort

    def route_runs():
        return sum(getattr(device_exec, c) for c in corpus.counters)

    for seed in range(corpus.seeds):
        tables, sql = corpus.case(seed)
        provider = _provider_of(tables)
        want = _outcome(host_rt, provider, sql)
        errors += want[0] == "error"
        took = []
        for rt in runtimes[:-1]:
            before = route_runs()
            got = _outcome(rt, provider, sql)
            check(got == want, f"phase 9: {name} seed {seed} on {rt.device}: {sql!r}"
                  f" differs from the host engine")
            took.append(route_runs() - before)
        check(len(set(took)) == 1, f"phase 9: {name} seed {seed}: routes {took} by device")
        if corpus.expect is not None:
            check(took[0] == corpus.expect(tables, sql),
                  f"phase 9: {name} seed {seed}: {took[0]} route runs")
        runs += took[0] if seed < corpus.upto else 0
        routed += took[0] > 0
        if seed < corpus.mesh_seeds:
            mp = MeshTableProvider(n_shards=FUZZ_MESH_SHARDS, device=runtimes[0].device.type)
            for tname, rel in tables.items():
                mp.add_table(tname, rel)
            before = _mesh_counters()
            got = _outcome(host_rt, mp, sql)
            check(got == want, f"phase 9: {name} seed {seed} over {FUZZ_MESH_SHARDS} shards:"
                  f" {sql!r} differs from the host engine")
            after = _mesh_counters()
            mesh[0] += sum(after[:3]) > sum(before[:3])
            mesh[1] += after[3] > before[3]
            mesh[2] += after[4] > before[4]
    count = runs if corpus.by == "runs" else routed
    check(count >= corpus.floor, f"phase 9: {name}: {count} {corpus.by} < {corpus.floor}")
    out = dict(seeds=corpus.seeds, errors=errors, floor_by=corpus.by, count=count,
               floor=corpus.floor)
    if name == "groupby":  # test_fuzz_seeds_take_the_mesh_routes
        check(mesh[0] >= 15, f"phase 9: {mesh[0]} of 40 fuzz queries took a mesh route")
        out["mesh_routed"] = mesh[0]
    if name == "order":  # test_order_fuzz_seeds_take_the_mesh_sorts
        check(mesh[1] >= 8 and 0 < mesh[2] < mesh[1],
              f"phase 9: mesh sorts {mesh[1]}, sample sorts {mesh[2]}")
        out.update(mesh_sorted=mesh[1], mesh_sample_sorts=mesh[2])
    return out


def mod_by_zero(runtimes):
    """tests/test_fuzz_device_parity.py:test_mod_by_zero_raises_on_device_path
    under every Runtime: integer modulo by zero raises."""
    provider = _provider_of(fuzz_group_table(random.Random(7)))
    sql = "select k1, sum(v % 0) from t group by k1 order by 1;"
    for rt in runtimes:
        got = _outcome(rt, provider, sql)
        check(got[0] == "error" and "modulo by zero" in got[2],
              f"phase 9: modulo by zero on {rt.device}: {got!r}")


def phase_fuzz(device):
    """Phase 9: every corpus under Runtime(device), Runtime("cpu") and the
    host engine, the mesh corpora over FUZZ_MESH_SHARDS shards on the
    card; then modulo by zero. Returns the counts by corpus and the
    kernels' launches."""
    t0 = time.perf_counter()
    runtimes = [Runtime(device=device), Runtime(device="cpu"), Runtime(device=None)]
    zero_launch_counts()
    out = {}
    for name in FUZZ_CORPORA:
        out[name] = fuzz_corpus(name, runtimes)
        log(f"phase 9: {name}: {out[name]}")
    mod_by_zero(runtimes)
    launches = launch_counts()
    for k in ("groupby_agg", "groupby_multi_agg", "dim_join_gid", "hash_groupby"):
        check(launches[k] > 0, f"phase 9: {k} never launched")
    log(f"phase 9: {sum(c['seeds'] for c in out.values())} fuzz seeds equal under"
        f" {[str(r.device) for r in runtimes]} and over {FUZZ_MESH_SHARDS} shards;"
        f" modulo by zero raises; launches {launches} in {time.perf_counter() - t0:.1f} s")
    return dict(corpora=out, launches=launches, seconds=time.perf_counter() - t0)


# -- phase 10: serving ----------------------------------------------------------------
#
# Phase 4's table served as users reach it: an in-memory TableService
# behind the port's EventQLServer + NativeTCPServer on one sniffed port
# (server/listener.py), every route on the card, phase 4's queries over the
# native protocol and some over HTTP, then eight clients at once; then a
# coordinator (parallel/cluster.py) over two worker servers, each holding
# half of the table on a mesh of CLUSTER_MESH_SHARDS shards (phase 6's four
# shards in all), through HTTP: the partial aggregates (QUERY_PARTIALAGGR)
# and a top-k pushdown (QUERY_REMOTE) on the workers' meshes, and a JOIN the
# fan-out refuses over two small workers of its own (the coordinator pulls
# their rows and runs its own routes); those two workers have no
# mesh_shards, so their partial aggregates run on a mesh of one shard of
# the card. The table service's schema has no signed type, so ``cat`` is
# stored shifted, as in phase 8.

SERVING_REPS = 3  # warm runs of a query over a protocol (host clock, median)
SERVING_HTTP = ("headline", "G1_min_max_mean", "topk_ts_desc", J1[0])
SERVING_CONCURRENT = ("headline", "G1_min_max_mean", "topk_ts_desc")
SERVING_CLIENTS = 8  # half over the native protocol, half over HTTP
SERVING_ROUNDS = 3
CLUSTER_WORKERS = 2
CLUSTER_MESH_SHARDS = 2
CLUSTER_QUERIES = ("headline", "G1_min_max_mean", "G5_float_sums", "topk_ts_desc")
CLUSTER_JOIN_ROWS = 1 << 20  # a worker of the remote-scan fallback
CLUSTER_JOIN = "join_small_dim"
CLUSTER_ONE_SHARD = ("headline", "G1_min_max_mean")  # over the JOIN's workers
PARTIAL_BYTES_A_GROUP = 64  # a worker's partial, beyond its query's envelope
# the envelope: the bytes of a worker's partial of the query with no group
# (np.savez_compressed of its zero-length arrays), as phase 10 measured it
# on an H100 80GB HBM3, plus 256 bytes
PARTIAL_ENVELOPE = {"headline": 9037 + 256, "G1_min_max_mean": 10831 + 256,
                    "G5_float_sums": 5089 + 256}
DIM_COLUMNS = [("k", SType.UINT64), ("region", SType.STRING)]
PATH_KERNELS = {
    "group_by": ("groupby_agg", "groupby_multi_agg"),
    "general_group_by": ("hash_groupby",),
    "order_by": ("groupby_agg", "extract_ge"),
    "join": ("dim_join_gid", "probe_join_gid", "groupby_agg", "groupby_multi_agg",
             "hash_groupby"),
}


def serving_service(stored, dictionary, dims, lo, hi, dim_part=(0, 1)):
    """An in-memory TableService holding rows [lo, hi) of phase 4's table
    (``stored``: its columns as ``stored_columns`` gives them) as one
    batch, and part ``i`` of ``parts`` of each dimension table
    (``dim_part`` = (i, parts))."""
    svc = TableService()
    host = Runtime(device=None)
    txn = host.new_transaction(svc)
    for name, columns in (("t", COLUMNS), ("d1", DIM_COLUMNS), ("d2", DIM_COLUMNS)):
        host.build_query_plan(txn, _create_sql(name, columns)).execute(0)
    svc.tables["t"].insert_batch(_batch(COLUMNS, stored, lo, hi, {"k": dictionary}))
    regions = np.array([b"r%04d" % i for i in range(N_REGIONS)], dtype=object)
    i, parts = dim_part
    for (name, (ordinal, region)), mult in zip(dims.items(), (DIM_MULT, BIG_DIM_MULT)):
        d = {"k": ordinal.astype(np.uint64) * mult + 3, "region": region.astype(np.int32)}
        a, b = i * len(ordinal) // parts, (i + 1) * len(ordinal) // parts
        svc.tables[name].insert_batch(_batch(DIM_COLUMNS, d, a, b, {"region": regions}))
    return svc


class _CountedSocket:
    """A client's socket that counts the bytes it receives."""

    def __init__(self, sock):
        self.sock, self.received = sock, 0

    def recv(self, n, *flags):
        data = self.sock.recv(n, *flags)
        self.received += len(data)
        return data

    def __getattr__(self, name):
        return getattr(self.sock, name)


def native_client(port):
    c = NativeTCPClient("127.0.0.1", port)
    c.sock = _CountedSocket(c.sock)
    return c


def native_sql(client, sql):
    """(rows, bytes received) of one statement over the native protocol."""
    before = client.sock.received
    ((_columns, rows),) = client.query(sql)
    return rows, client.sock.received - before


def http_sql(port, sql):
    """(rows, bytes of the response body) of one statement over HTTP; an
    error answer raises."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/sql",
                                 data=json.dumps({"query": sql}).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = resp.read()
    return json.loads(body)["results"][0]["rows"], len(body)


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def _same(rows, expected, as_set):
    return (sorted(rows) if as_set else rows) == expected


def serving_queries(tables, stored_cols, n):
    """name -> (path, sql, expected rows, compared as a set?, route
    counter) for phase 4's queries over the stored columns."""
    dictionary = tables["dictionary"]
    out = {}
    for q in queries(stored_cols, dictionary, cat_lo=0):
        out[q[0]] = ("group_by", q[1], q[4], True, _route_counter("group_by", q))
    for name, sql, rows in general_queries(stored_cols, dictionary, n, cat_lo=0):
        out[name] = ("general_group_by", sql, rows, False, "GENERAL_GROUPBY_COUNT")
    for q in tables["oqs"]:
        out[q[0]] = ("order_by", q[1], q[4], False, _route_counter("order_by", q))
    for q in tables["jqs"]:
        if q[3] is not None:
            out[q[0]] = ("join", q[1], q[3], False, "JOIN_GROUPBY_COUNT")
    return out


def serving_standalone(port, qs, inprocess_e2e):
    """Every query over the native protocol (a first run, then
    SERVING_REPS warm runs), those of SERVING_HTTP also over HTTP, each
    path's launch counts zeroed just before it and read just after.
    Returns per-query numbers, the launches of each path and the first
    call of each kernel."""
    per_query, launches, first = {}, {}, {}
    client = native_client(port)
    for path, kernels in PATH_KERNELS.items():
        zero_launch_counts()
        with _RecordedCalls() as rec:
            for name, (qpath, sql, expected, as_set, counter) in qs.items():
                if qpath != path:
                    continue
                before = getattr(device_exec, counter)
                (rows, nbytes), first_ms = _timed(lambda: native_sql(client, sql))
                check(len(rows) == len(expected) and _same(rows, expected, as_set),
                      f"phase 10: {name} over the native protocol differs from numpy")
                for kernel, kw in rec.calls:
                    first.setdefault(kernel, (name, kw))
                rec.calls.clear()
                runs, native_ms, http_ms = 1 + SERVING_REPS, [], []
                for _ in range(SERVING_REPS):
                    (again, _b), ms = _timed(lambda: native_sql(client, sql))
                    rec.calls.clear()
                    check(again == rows, f"phase 10: {name}: a warm native run differs")
                    native_ms.append(ms)
                entry = dict(rows=len(rows), first_ms=first_ms,
                             native_ms=statistics.median(native_ms), native_bytes=nbytes,
                             inprocess_ms=inprocess_e2e[name]["warm_ms_median"])
                if name in SERVING_HTTP:
                    for _ in range(SERVING_REPS):
                        (hrows, hbytes), ms = _timed(lambda: http_sql(port, sql))
                        rec.calls.clear()
                        check(_same(hrows, expected, as_set),
                              f"phase 10: {name} over HTTP differs from numpy")
                        http_ms.append(ms)
                    runs += SERVING_REPS
                    entry.update(http_ms=statistics.median(http_ms), http_bytes=hbytes)
                rose = getattr(device_exec, counter) - before
                check(rose == runs, f"phase 10: {name}: {counter} rose {rose} in {runs} runs")
                per_query[name] = entry
                log(f"phase 10: {name}: native {entry['native_ms']:.3f} ms"
                    + (f", HTTP {entry['http_ms']:.3f} ms" if http_ms else "")
                    + f", in process {entry['inprocess_ms']:.3f} ms (host clock, median of"
                    f" {SERVING_REPS}); {nbytes} bytes on the wire (native)")
        launches[path] = launch_counts()
        for k in kernels:
            check(launches[path][k] > 0, f"phase 10: {k} not launched on the {path} path")
    client.close()
    return per_query, launches, first


def serving_concurrency(port, qs):
    """SERVING_CLIENTS clients (even ones native, odd ones HTTP), each
    sending the SERVING_CONCURRENT queries in its own order, the rounds
    started together: every answer equal to numpy."""
    barrier = threading.Barrier(SERVING_CLIENTS)
    errors, round_ms = [], [[] for _ in range(SERVING_CLIENTS)]

    def client(i):
        try:
            c = native_client(port) if i % 2 == 0 else None
            for r in range(SERVING_ROUNDS):
                barrier.wait(timeout=600)
                t = time.perf_counter()
                for j in range(len(SERVING_CONCURRENT)):
                    name = SERVING_CONCURRENT[(i + j) % len(SERVING_CONCURRENT)]
                    _path, sql, expected, as_set, _counter = qs[name]
                    rows = native_sql(c, sql)[0] if c else http_sql(port, sql)[0]
                    if not _same(rows, expected, as_set):
                        errors.append(f"client {i}, round {r}: {name} differs from numpy")
                round_ms[i].append((time.perf_counter() - t) * 1e3)
            if c:
                c.close()
        except Exception as e:  # reported by the main thread
            errors.append(f"client {i}: {e!r}")
            barrier.abort()

    zero_launch_counts()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVING_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "phase 10: a concurrent client hung")
    check(not errors, f"phase 10: concurrent clients: {errors[:5]}")
    launches = launch_counts()
    per_round = [max(ms[r] for ms in round_ms) for r in range(SERVING_ROUNDS)]
    log(f"phase 10: {SERVING_CLIENTS} clients x {SERVING_ROUNDS} rounds of"
        f" {list(SERVING_CONCURRENT)} equal to numpy; slowest client a round"
        f" {[round(x, 3) for x in per_round]} ms; launches {launches}")
    return dict(clients=SERVING_CLIENTS, rounds=SERVING_ROUNDS, queries=SERVING_CONCURRENT,
                round_ms_slowest_client=per_round, launches=launches)


class _PartialBytes:
    """While active, the coordinator's partial_from_bytes records, for
    each worker partial it reads, (its bytes, its groups)."""

    def __enter__(self):
        self.seen = []
        self._orig = orig = cluster.partial_from_bytes

        def reading(data, template):
            out = orig(data, template)
            self.seen.append((len(data), out.n_groups))
            return out

        cluster.partial_from_bytes = reading
        return self

    def __exit__(self, *exc):
        cluster.partial_from_bytes = self._orig


def _coordinator(device, addrs):
    return EventQLServer(TableService(), port=0, device=device,
                         query_provider_factory=lambda: ClusterTableProvider(addrs)).start()


def cluster_queries(port, qs, names):
    """``names`` through HTTP to the coordinator on ``port``, with the
    launch counts zeroed just before and read just after: answers equal
    to numpy (a GROUP BY as a set: the merge orders groups by worker),
    the workers' mesh counters rising once a worker and run, every
    partial within PARTIAL_BYTES_A_GROUP bytes a group beyond its
    query's PARTIAL_ENVELOPE. Returns per-query numbers, the launches
    and the first call of each kernel."""
    per_query, first = {}, {}
    zero_launch_counts()
    with _RecordedCalls() as rec, _PartialBytes() as pb:
        for name in names:
            path, sql, expected, _as_set, _counter = qs[name]
            counter = "MESH_TOPK_RUNS" if path == "order_by" else "MESH_GROUPBY_RUNS"
            before = getattr(mesh_exec, counter)
            pb.seen.clear()
            (rows, nbytes), first_ms = _timed(lambda: http_sql(port, sql))
            ok = rows == expected if path == "order_by" else sorted(rows) == sorted(expected)
            check(ok, f"phase 10: {name} through the cluster differs from numpy")
            for kernel, kw in rec.calls:
                first.setdefault(kernel, (name, kw))
            rec.calls.clear()
            partials = list(pb.seen)
            if path != "order_by":
                check(len(partials) == CLUSTER_WORKERS and all(
                    size <= PARTIAL_BYTES_A_GROUP * groups + PARTIAL_ENVELOPE[name]
                    for size, groups in partials),
                    f"phase 10: {name}: partials (bytes, groups) {partials}, envelope"
                    f" {PARTIAL_ENVELOPE[name]}")
            times = []
            for _ in range(SERVING_REPS):
                (again, _b), ms = _timed(lambda: http_sql(port, sql))
                rec.calls.clear()
                check(again == rows, f"phase 10: {name}: a warm cluster run differs")
                times.append(ms)
            rose = getattr(mesh_exec, counter) - before
            runs = 1 + SERVING_REPS
            check(rose == CLUSTER_WORKERS * runs,
                  f"phase 10: {name}: {counter} rose {rose}, expected {CLUSTER_WORKERS * runs}")
            per_query[name] = dict(first_ms=first_ms, http_ms=statistics.median(times),
                                   http_bytes=nbytes, rows=len(rows),
                                   partials_bytes_groups=partials)
            log(f"phase 10: cluster {name}: {per_query[name]['http_ms']:.3f} ms (host"
                f" clock, median of {SERVING_REPS}; first {first_ms:.1f}); partials"
                f" (bytes, groups) {partials}")
    return per_query, launch_counts(), first


def serving_cluster(device, tables, stored, n, qs):
    """CLUSTER_QUERIES (cluster_queries) to a coordinator over
    CLUSTER_WORKERS workers, each holding its share of the table on a mesh
    of CLUSTER_MESH_SHARDS shards on the card."""
    share = n // CLUSTER_WORKERS
    workers = [NativeTCPServer(
        serving_service(stored, tables["dictionary"], tables["dims"], i * share,
                        (i + 1) * share, (i, CLUSTER_WORKERS)),
        port=0, device=device, mesh_shards=CLUSTER_MESH_SHARDS).start()
        for i in range(CLUSTER_WORKERS)]
    coordinator = _coordinator(device, [("127.0.0.1", w.port) for w in workers])
    try:
        per_query, launches, first = cluster_queries(coordinator.port, qs, CLUSTER_QUERIES)
        for k in ("hash_groupby", "groupby_agg", "extract_ge"):
            check(launches[k] > 0, f"phase 10: {k} not launched on the cluster path")
    finally:
        coordinator.stop()
        for w in workers:
            w.stop()
    return per_query, launches, first


def serving_cluster_join(device, tables, stored):
    """CLUSTER_JOIN through HTTP to a coordinator over two workers of
    CLUSTER_JOIN_ROWS rows each (and half of d1 each), made without
    mesh_shards: the fan-out refuses a JOIN, so the coordinator pulls the
    workers' rows (QUERY_REMOTE) and runs its own join route on the card;
    rows and their order equal numpy. Then CLUSTER_ONE_SHARD
    (cluster_queries) over the same workers: their partials run on a mesh
    of one shard of the card."""
    n = CLUSTER_WORKERS * CLUSTER_JOIN_ROWS
    cols, dims = tables["cols"], tables["dims"]
    (name, sql, per_run, expected), = [q for q in join_queries(cols, dims, n)
                                       if q[0] == CLUSTER_JOIN]
    workers = [NativeTCPServer(
        serving_service(stored, tables["dictionary"], dims, i * CLUSTER_JOIN_ROWS,
                        (i + 1) * CLUSTER_JOIN_ROWS, (i, CLUSTER_WORKERS)),
        port=0, device=device).start() for i in range(CLUSTER_WORKERS)]
    coordinator = _coordinator(device, [("127.0.0.1", w.port) for w in workers])
    try:
        zero_launch_counts()
        before = device_exec.JOIN_GROUPBY_COUNT
        times, first = [], {}
        with _RecordedCalls() as rec:
            for _ in range(1 + SERVING_REPS):
                (rows, nbytes), ms = _timed(lambda: http_sql(coordinator.port, sql))
                check(rows == expected, f"phase 10: {name} through the cluster differs")
                for kernel, kw in rec.calls:
                    first.setdefault(kernel, (name, kw))
                rec.calls.clear()
                times.append(ms)
        runs = 1 + SERVING_REPS
        rose = device_exec.JOIN_GROUPBY_COUNT - before
        check(rose == runs, f"phase 10: {name}: the coordinator's join route rose {rose}")
        launches = launch_counts()
        check(launches == {k: runs * per_run.get(k, 0) for k in launches},
              f"phase 10: {name} launches {launches}, expected {per_run} a run")
        pcols = {k: v[:n] for k, v in cols.items()}
        pqs = serving_queries(dict(tables, oqs=[], jqs=[]),
                              dict(pcols, cat=pcols["cat"] - CAT_LO), n)
        one_shard, one_launches, one_first = cluster_queries(
            coordinator.port, pqs, CLUSTER_ONE_SHARD)
        check(one_launches["hash_groupby"] > 0,
              "phase 10: hash_groupby not launched on the one-shard workers")
        for k, call in one_first.items():
            first.setdefault(k, call)
    finally:
        coordinator.stop()
        for w in workers:
            w.stop()
    out = dict(rows_per_worker=CLUSTER_JOIN_ROWS, first_ms=times[0],
               http_ms=statistics.median(times[1:]), http_bytes=nbytes, groups=len(rows))
    log(f"phase 10: cluster {name} (remote-scan fallback, {n} rows pulled):"
        f" {out['http_ms']:.1f} ms (host clock, median of {SERVING_REPS}; first"
        f" {times[0]:.1f}); launches {launches}; one-shard workers: launches {one_launches}")
    return out, launches, first, one_shard, one_launches


def phase_serving(device, tables, inprocess_e2e):
    """Phase 10 with every server's routes on ``device`` ("cuda"; "cpu"
    runs the kernels' plain versions). Returns the {"serving": ...}
    numbers and the first call of each kernel on the standalone and on
    the cluster paths."""
    t0 = time.perf_counter()
    cols = tables["cols"]
    n = len(cols["k"])
    stored = stored_columns(cols)
    qs = serving_queries(tables, dict(cols, cat=cols["cat"] - CAT_LO), n)
    svc = serving_service(stored, tables["dictionary"], tables["dims"], 0, n)
    http = EventQLServer(svc, device=device).start(bind=False)
    native = NativeTCPServer(svc, device=device)  # its connection handler serves the listener
    lis = Listener(http, native, port=0).start()
    log(f"phase 10: {n} rows served on one port (native + HTTP), answers made in"
        f" {time.perf_counter() - t0:.1f} s")
    try:
        per_query, launches, first = serving_standalone(lis.port, qs, inprocess_e2e)
        concurrency = serving_concurrency(lis.port, qs)
    finally:
        lis.stop()
        http.stop()
    del svc, http, native
    cluster_q, cluster_launches, cluster_first = serving_cluster(device, tables, stored, n, qs)
    join, join_launches, join_first, one_shard, one_launches = serving_cluster_join(
        device, tables, stored)
    for k, call in join_first.items():
        cluster_first.setdefault(k, call)
    launches["concurrent"] = concurrency.pop("launches")
    launches["cluster"] = cluster_launches
    launches["cluster_join"] = join_launches
    launches["cluster_one_shard"] = one_launches
    out = dict(rows=n, reps=SERVING_REPS, queries=per_query, concurrency=concurrency,
               cluster=dict(workers=CLUSTER_WORKERS, mesh_shards=CLUSTER_MESH_SHARDS,
                            rows_per_worker=n // CLUSTER_WORKERS, queries=cluster_q,
                            join_fallback=join,
                            one_shard=dict(rows_per_worker=CLUSTER_JOIN_ROWS,
                                           queries=one_shard)),
               launches=launches, phase_s=time.perf_counter() - t0)
    log(f"phase 10: {len(per_query)} queries served and"
        f" {len(cluster_q) + 1 + len(one_shard)} through the"
        f" cluster, equal to numpy, in {out['phase_s']:.1f} s")
    return out, first, cluster_first


# -- phase 11: charts on the card, and the cluster tier ---------------------------------
#
# (a) DRAW over phase 4's table under Runtime(device): four charts whose
# sub-queries take the GROUP BY (B1), top-k (B1's histograms + B3) and
# general GROUP BY (H1) routes, each SVG byte for byte the one the port's
# host engine renders for the same statement (every sub-query orders its
# rows, so both engines hand the chart the same rows in the same order).
# (b) A cluster as EventQL's users deploy it: the port's embedded ZooKeeper
# server in this process, a cluster of replication factor 2, three evqld
# processes on the card (--zookeeper_addr, --server_name, --device,
# --datadir, --partition_split_threshold_rows), a table partitioned on a
# UINT64 primary key. Rows go in through node1's HTTP insert API, routed by
# partition and written to every replica (majority acknowledgement); the
# leader's autosplit splits the partition while they arrive. Then: every
# replica's rows in each partition's keyrange against numpy, queries through
# node1 and node2, the node a query of the last partition reads first
# killed, the queries again through a live node. The
# partition plans are keyrange-scoped, which every device route declines:
# the workers answer them on their host engines, and the card runs (a).

CHART_REPS = 3  # warm runs of a chart (host clock, median)
CHARTS = {
    # name: (kernels it launches, phase 4's query it draws, route counter,
    # statement)
    "bar_headline": (
        ("groupby_agg",), "headline", "FUSED_GROUPBY_COUNT",
        "DRAW BARCHART WITH AXIS BOTTOM AXIS LEFT;"
        " SELECT k AS x, sum(v) AS y FROM t WHERE v < 800 GROUP BY k ORDER BY x;"),
    "line_legend_topk": (
        ("groupby_agg", "extract_ge"), "topk_ts_desc", "SCAN_TOPK_COUNT",
        "DRAW LINECHART WITH LEGEND TOP RIGHT INSIDE AXIS LEFT;"
        " SELECT ts AS x, v AS y FROM t ORDER BY ts DESC LIMIT 100;"),
    "area_ydomain_g1": (
        ("hash_groupby",), "G1_min_max_mean", "GENERAL_GROUPBY_COUNT",
        "DRAW AREACHART WITH YDOMAIN 0, 1000 AXIS LEFT;"
        " SELECT max(w) AS x, mean(v) AS y FROM t WHERE v < 800 GROUP BY k"
        " ORDER BY x, k;"),
    "point_grid": (
        ("groupby_agg",), "numeric_key_base", "FUSED_GROUPBY_COUNT",
        "DRAW POINTCHART WITH GRID HORIZONTAL VERTICAL AXIS BOTTOM;"
        " SELECT cat AS x, count(1) AS y FROM t GROUP BY cat ORDER BY x;"),
}


def render(rt, provider, sql):
    res = rt.build_query_plan(rt.new_transaction(provider), sql).execute(0)
    check(res.columns == ["__chart"] and len(res.rows) == 1, "a DRAW gave no chart")
    return res.rows[0][0]


def phase_charts(device, cols, dictionary, inprocess_e2e):
    """CHARTS under Runtime(device) against the host engine, each path's
    launch counts zeroed just before it and read just after. Returns the
    {"charts": ...} numbers, the launches by chart and each kernel's first
    call."""
    n = len(cols["k"])
    provider = provider_of(cols, dictionary, n)
    host, rt = Runtime(device=None), Runtime(device=device)
    per_chart, launches, first = {}, {}, {}
    for name, (kernels, bare, counter, sql) in CHARTS.items():
        want, host_ms = _timed(lambda: render(host, provider, sql))
        zero_launch_counts()
        with _RecordedCalls() as rec:
            before = getattr(device_exec, counter)
            svg, first_ms = _timed(lambda: render(rt, provider, sql))
            check(svg == want, f"phase 11: {name}: the SVG differs from the host engine's")
            check(getattr(device_exec, counter) == before + 1,
                  f"phase 11: {name}: {counter} did not rise by one")
            for kernel, kw in rec.calls:
                first.setdefault(kernel, (name, kw))
            rec.calls.clear()
            warm = []
            for _ in range(CHART_REPS):
                again, ms = _timed(lambda: render(rt, provider, sql))
                rec.calls.clear()
                check(again == want, f"phase 11: {name}: a warm run differs")
                warm.append(ms)
        launches[name] = launch_counts()
        for k in kernels:
            check(launches[name][k] > 0, f"phase 11: {k} not launched by {name}")
        check(getattr(device_exec, counter) == before + 1 + CHART_REPS,
              f"phase 11: {name}: {counter} did not rise once a run")
        per_chart[name] = dict(svg_bytes=len(svg), first_ms=first_ms,
                               warm_ms=statistics.median(warm), host_engine_ms=host_ms,
                               bare_query=bare,
                               bare_warm_ms=inprocess_e2e[bare]["warm_ms_median"])
        log(f"phase 11: {name}: {len(svg)} bytes of SVG equal to the host engine's;"
            f" {per_chart[name]['warm_ms']:.3f} ms warm (host clock, median of {CHART_REPS};"
            f" first {first_ms:.1f}), the bare {bare} {per_chart[name]['bare_warm_ms']:.3f} ms,"
            f" the host engine {host_ms:.1f} ms")
    return dict(rows=n, reps=CHART_REPS, charts=per_chart), launches, first


CLUSTER_TIER_NODES = ("node1", "node2", "node3")
CLUSTER_TIER_RF = 2
CLUSTER_TIER_ROWS = 1 << 16  # rows inserted, unless the routed rate forces a cut
CLUSTER_TIER_SPLIT_ROWS = 1 << 12  # --partition_split_threshold_rows
CLUSTER_TIER_BATCH = 256  # records in one POST /api/v1/tables/insert
CLUSTER_TIER_INSERT_S = 60.0  # the inserts' budget: no request starts after it
CLUSTER_TIER_START_S = 180.0  # a node that has not registered by then fails the phase
CLUSTER_TIER_DEADLINE_S = 120.0  # for a split, the read-back, "down", the first exact answer
CLUSTER_TIER_REPS = 3
CLUSTER_TIER_NAME = "phase11"
CLUSTER_TIER_QUERIES = ("headline", "G1_min_max_mean", "topk_ts_desc", "count_star",
                        "draw_bar")
REPO = os.path.dirname(os.path.abspath(__file__))


class _Nodes:
    """evqld processes of the cluster; each one is killed on exit."""

    def __init__(self, tmp):
        self.tmp, self.procs, self.logs = tmp, {}, {}

    def start(self, name, zk_addr, device):
        log_path = os.path.join(self.tmp, f"{name}.log")
        self.logs[name] = log_path
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(log_path, "w") as out:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "eventql_tpu_torch.cli.evqld",
                 "--zookeeper_addr", zk_addr, "--server_name", name, "--device", device,
                 "--datadir", os.path.join(self.tmp, name),
                 "--partition_split_threshold_rows", str(CLUSTER_TIER_SPLIT_ROWS),
                 "--listen_http", "127.0.0.1:0", "--listen_native", "127.0.0.1:0"],
                stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)

    def log_of(self, name):
        with open(self.logs[name]) as f:
            return f.read()

    def wait_listening(self, name):
        """The port the node serves HTTP and the native protocol on, once
        it prints that it listens."""
        deadline = time.monotonic() + CLUSTER_TIER_START_S
        while time.monotonic() < deadline:
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", self.log_of(name))
            if m:
                return int(m.group(1))
            check(self.procs[name].poll() is None,
                  f"phase 11: {name} exited: {self.log_of(name)[-2000:]}")
            time.sleep(0.2)
        raise AssertionError(f"phase 11: {name} did not start: {self.log_of(name)[-2000:]}")

    def kill(self, name):
        p = self.procs[name]
        p.kill()
        p.wait(timeout=30)

    def stop_all(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)


def _until(what, fn, deadline_s=CLUSTER_TIER_DEADLINE_S, every=0.25):
    """Poll ``fn`` until it returns a true value; (value, seconds)."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < deadline_s:
        try:
            out = fn()
            if out:
                return out, time.monotonic() - t0
        except (OSError, SQLError, RuntimeError_) as e:
            last = e
        time.sleep(every)
    raise AssertionError(f"phase 11: {what} within {deadline_s} s" + (f" ({last})" if last else ""))


def _records(stored, dictionary, ids):
    """The JSON insert body of rows ``ids`` of the table, one record a row."""
    names = [d.decode() for d in dictionary]
    body = []
    for i in ids.tolist():
        rec = {"id": i, "k": names[stored["k"][i]]}
        for c, st in COLUMNS[1:]:
            rec[c] = int(stored[c][i])
        body.append({"table": "t", "data": rec})
    return json.dumps(body).encode()


def _http_post(port, path, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def cluster_insert(port, stored, dictionary, order, n_want, split):
    """Rows ``order[:n]`` through POST /api/v1/tables/insert on ``port``,
    CLUSTER_TIER_BATCH records a request, one request at a time (clients
    at once only slow the routed inserts down: they contend in node1).
    ``n`` is ``n_want``, or the rows of the requests made before
    CLUSTER_TIER_INSERT_S passed (the routed rate falls as the table
    grows). After each
    request ``split()`` says whether the table has split yet. Returns (n,
    seconds, seconds to the first split or None)."""
    B = CLUSTER_TIER_BATCH
    t0 = time.perf_counter()
    n, split_s = 0, None
    while n < n_want and time.perf_counter() - t0 < CLUSTER_TIER_INSERT_S:
        status, _ = _http_post(port, "/api/v1/tables/insert",
                               _records(stored, dictionary, order[n:n + B]))
        check(status == 201, f"phase 11: an insert answered {status}")
        n += B
        if split_s is None and split():
            split_s = time.perf_counter() - t0
        if n % (16 * B) == 0:
            log(f"phase 11: {n} rows in {time.perf_counter() - t0:.1f} s")
    return n, time.perf_counter() - t0, split_s


def _scan_plan(info, begin, end):
    """A scan of table t's rows in the keyrange [begin, end) of ``id``."""
    scan = qn.SequentialScanNode("t", info.columns)
    for i, (cname, ctype) in enumerate(info.columns):
        scan.input_columns.append((cname, ctype))
        scan.select_list.append(qn.SelectListEntry(ColumnReferenceNode(cname, ctype, i), cname))
    scan.output_columns = [c[0] for c in info.columns]
    scan.keyrange = ("id", begin, end)
    return encode_plan(scan)


def _column_values(col):
    check(bool(col.valid.all()), "phase 11: a NULL where every row has a value")
    if col.dictionary is not None:
        return np.asarray(col.dictionary, dtype=object)[col.data]
    return col.data


def replicas_hold(cdir, addr_of, info, stored, dictionary, ids):
    """Every replica the table's metadata names holds, in the partition's
    keyrange, exactly the rows numpy has there (all columns). Returns the
    number of (partition, replica) pairs checked, or 0 when one differs."""
    meta = TableMetadata.from_json(cdir.get_table_config("default", "t")["metadata"])
    pairs = 0
    for e in meta.entries:
        begin, end = meta.keyrange(e.partition_id)
        lo = 0 if begin == "" else int(begin)
        hi = (1 << 64) if end == "" else int(end)
        want = ids[(ids >= lo) & (ids < hi)]
        for sid in e.servers:
            c = NativeTCPClient(*addr_of[sid])
            try:
                rel = relation_from_bytes(c.query_remote(_scan_plan(info, begin, end)))
            finally:
                c.close()
            got = {nm: _column_values(col) for nm, col in zip(rel.names, rel.columns)}
            order = np.argsort(got["id"], kind="stable")
            if rel.num_rows != len(want) or not np.array_equal(got["id"][order], want):
                return 0
            for c_name, _st in COLUMNS:
                expect = stored[c_name][want]
                if c_name == "k":
                    expect = np.asarray(dictionary, dtype=object)[expect]
                if not np.array_equal(got[c_name][order], expect):
                    return 0
            pairs += 1
    return pairs


def _partitions(port):
    rows, _ = http_sql(port, "DESCRIBE PARTITIONS t;")
    return rows


def cluster_expected(stored, dictionary, ids):
    """name -> (sql, expected rows, compared as a set?) of the rows ``ids``."""
    sub = {c: stored[c][ids] for c, _st in COLUMNS}
    n = len(ids)
    out = {}
    q = {x[0]: x for x in queries(sub, dictionary, cat_lo=0)}
    out["headline"] = (q["headline"][1], q["headline"][4], True)
    g = {name: (sql, rows) for name, sql, rows in general_queries(sub, dictionary, n, cat_lo=0)}
    out["G1_min_max_mean"] = (g["G1_min_max_mean"][0], sorted(g["G1_min_max_mean"][1]), True)
    o = {x[0]: x for x in order_queries(sub, dictionary, n)}
    out["topk_ts_desc"] = (o["topk_ts_desc"][1], o["topk_ts_desc"][4], False)
    out["count_star"] = ("select count(*) from t;", [[str(n)]], False)
    # the chart of the rows, as the port's host engine draws it in this process
    sql = CHARTS["bar_headline"][3]
    out["draw_bar"] = (sql, [[render(Runtime(device=None), provider_of(sub, dictionary, n),
                                     sql)]], False)
    return out


def _answer(port, sql):
    rows, _ = http_sql(port, sql)
    return rows


def cluster_answers(ports, expected, names=CLUSTER_TIER_QUERIES):
    """Every query through each HTTP port: exact, warm ms (host clock,
    median of CLUSTER_TIER_REPS). Returns {port label: {query: ms}}."""
    out = {}
    for label, port in ports.items():
        out[label] = {}
        for name in names:
            sql, want, as_set = expected[name]
            times = []
            for _ in range(1 + CLUSTER_TIER_REPS):  # the first run is not timed
                rows, ms = _timed(lambda: _answer(port, sql))
                check(_same(rows, want, as_set),
                      f"phase 11: {name} through {label} differs from numpy")
                times.append(ms)
            out[label][name] = statistics.median(times[1:])
    return out


def _exact(port, expected, name):
    sql, want, as_set = expected[name]
    return _same(_answer(port, sql), want, as_set)


def _reported_down(cdir, port, victim, addr):
    """The registry has ``victim`` down, and CLUSTER SHOW SERVERS through
    ``port`` lists no server up at its address."""
    status = {s.server_id: s.server_status for s in cdir.list_servers()}
    rows, _ = http_sql(port, "CLUSTER SHOW SERVERS;")
    up = {r[2] for r in rows if r[1] == "SERVER_UP"}
    return status[victim] == SERVER_DOWN and addr not in up


def phase_cluster(device):
    """Phase 11 (b) with the nodes' routes on ``device`` ("cuda"; "cpu"
    runs the kernels' plain versions). Returns the {"cluster": ...}
    numbers."""
    t_phase = time.perf_counter()
    N = CLUSTER_TIER_ROWS
    cols, dictionary = make_table(N, seed=11)
    stored = stored_columns(cols)
    stored["id"] = np.arange(N, dtype=np.uint64)
    order = np.random.default_rng(12).permutation(N).astype(np.uint64)
    tmp = tempfile.mkdtemp(prefix="evql_phase11_")
    nodes = _Nodes(tmp)
    zk = _ZooKeeperProcess(tmp)
    tools = {}
    try:
        zk_addr = f"{zk.start()}/{CLUSTER_TIER_NAME}"
        url = f"zk://{zk_addr}"
        cdir = ConfigDirectory(url)
        cdir.cluster_create(CLUSTER_TIER_NAME, replication_factor=CLUSTER_TIER_RF)
        # node1 first, so that it leads: the leader runs autosplit over
        # its own rows, and the first partition lies on node1 and node2
        t0 = time.perf_counter()
        node_device = "cuda" if torch.device(device).type == "cuda" else "cpu"
        nodes.start("node1", zk_addr, node_device)
        ports = {"node1": nodes.wait_listening("node1")}
        _until("node1 to lead", lambda: cdir.current_leader() == "node1")
        for name in CLUSTER_TIER_NODES[1:]:
            nodes.start(name, zk_addr, node_device)
        for name in CLUSTER_TIER_NODES[1:]:
            ports[name] = nodes.wait_listening(name)
        start_s = time.perf_counter() - t0
        servers = {s.server_id: s for s in cdir.list_servers()}
        check(sorted(servers) == list(CLUSTER_TIER_NODES) and all(
            s.server_status == SERVER_UP for s in servers.values()),
            f"phase 11: the registry holds {servers}")
        addr_of = {}
        for sid, s in servers.items():
            host, _, port = s.server_addr.rpartition(":")
            addr_of[sid] = (host, int(port))
        p1 = ports["node1"]
        http_sql(p1, _create_sql("t", [("id", SType.UINT64)] + COLUMNS, pk="id"))
        parts0 = _partitions(p1)
        log(f"phase 11: {len(CLUSTER_TIER_NODES)} nodes up in {start_s:.1f} s, table t in"
            f" {len(parts0)} partition(s) on {parts0[0][1]}")

        def split():
            meta = cdir.get_table_config("default", "t")["metadata"]
            return len(meta["partitions"]) > len(parts0)

        t_ins = time.perf_counter()
        n, insert_s, split_s = cluster_insert(p1, stored, dictionary, order, N, split)
        ids = np.sort(order[:n])
        log(f"phase 11: {n} rows inserted through node1 in {insert_s:.1f} s"
            f" ({n / insert_s:.1f} routed inserts a second)")
        if split_s is None:
            _until("a split", split)
            split_s = time.perf_counter() - t_ins
        provider = cluster_provider_from_config(url)
        try:
            info = provider.describe("t")
        finally:
            provider.close()
        pairs, readback_s = _until(
            "every replica's rows equal to numpy",
            lambda: replicas_hold(cdir, addr_of, info, stored, dictionary, ids))
        parts = _partitions(p1)
        check(len(parts) > len(parts0), f"phase 11: DESCRIBE PARTITIONS shows {len(parts)}")
        log(f"phase 11: first split {split_s:.1f} s after the inserts began; {len(parts)}"
            f" partitions; {pairs} (partition, replica) pairs equal to numpy"
            f" {readback_s:.1f} s after the inserts ended")
        tools["evqlctl_before_kill"] = evqlctl_statuses(url, CLUSTER_TIER_NODES)
        mr_want = mapreduce_expected(np.asarray([d.decode() for d in dictionary],
                                                dtype=object)[stored["k"][ids]], stored["v"][ids])
        tools["mapreduce_before_kill"] = distributed_mapreduce(url, mr_want)

        expected = cluster_expected(stored, dictionary, ids)
        before_ms = cluster_answers({"node1": p1, "node2": ports["node2"]}, expected)
        log(f"phase 11: {len(CLUSTER_TIER_QUERIES)} queries through node1 and node2 equal to"
            f" numpy: {before_ms} ms (host clock, median of {CLUSTER_TIER_REPS})")

        # the node a query of the last partition reads first: killing it
        # makes the queries fail over to its other replica
        meta = TableMetadata.from_json(cdir.get_table_config("default", "t")["metadata"])
        victim = meta.entries[-1].servers[0]
        via = "node1" if victim != "node1" else "node2"
        nodes.kill(victim)
        t_kill = time.perf_counter()
        _r, down_s = _until(f"{victim} reported down", lambda: _reported_down(
            cdir, ports[via], victim, "%s:%d" % addr_of[victim]))
        _until(f"an exact answer through {via} after the kill",
               lambda: _exact(ports[via], expected, "count_star"), every=0.05)
        exact_s = time.perf_counter() - t_kill
        after_ms = cluster_answers({via: ports[via]}, expected)
        provider = cluster_provider_from_config(url)
        try:
            rt = Runtime(device=device)
            for name in CLUSTER_TIER_QUERIES[:4]:
                sql, want, as_set = expected[name]
                rows = rt.build_query_plan(rt.new_transaction(provider), sql).execute(0).rows
                check(_same(rows, want, as_set),
                      f"phase 11: {name} through an in-process coordinator differs")
            failed = provider.num_failed_shards
        finally:
            provider.close()
        check(failed == 0, f"phase 11: {failed} failed shards after {victim} was killed")
        tools["evqlctl_after_kill"] = evqlctl_statuses(url, CLUSTER_TIER_NODES, victim)
        tools["mapreduce_after_kill"] = distributed_mapreduce(url, mr_want)
        log(f"phase 11: {victim} (the first replica of {len(meta.entries)} partition(s)'"
            f" last) killed: down after {down_s:.3f} s, first exact answer through {via}"
            f" after {exact_s:.3f} s; the queries through {via} equal to numpy:"
            f" {after_ms} ms")
    except BaseException:
        for name in nodes.logs:
            log(f"phase 11: {name}'s output ends: {nodes.log_of(name)[-3000:]}")
        log(f"phase 11: the ZooKeeper server's output ends: {zk.output()[-3000:]}")
        raise
    finally:
        nodes.stop_all()
        zk.kill()
        reset_sessions()
        shutil.rmtree(tmp, ignore_errors=True)
    return tools, dict(nodes=len(CLUSTER_TIER_NODES), replication_factor=CLUSTER_TIER_RF,
                rows=n, rows_wanted=N, cut=n < N, split_threshold_rows=CLUSTER_TIER_SPLIT_ROWS,
                insert_s=insert_s, routed_inserts_per_s=n / insert_s,
                partitions_at_creation=len(parts0), partitions=len(parts),
                replica_pairs_read_back=pairs, start_s=start_s, first_split_s=split_s,
                read_back_s=readback_s, query_ms=before_ms, query_ms_after_kill=after_ms,
                placements=[e.servers for e in meta.entries], killed=victim, queried_after=via,
                down_s=down_s, first_exact_after_kill_s=exact_s, failed_shards=failed,
                phase_s=time.perf_counter() - t_phase)


class _ZooKeeperProcess:
    """Phase 11's ZooKeeper server as its users run it: ``python -m
    eventql_tpu_torch.cli.zkserver`` in a process of its own, killed on
    every exit path."""

    def __init__(self, tmp):
        self.log_path, self.proc = os.path.join(tmp, "zkserver.log"), None

    def start(self):
        """Starts it; returns its ``host:port`` once it says it listens."""
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "eventql_tpu_torch.cli.zkserver", "--listen",
                 "127.0.0.1:0"], stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)
        deadline = time.monotonic() + CLUSTER_TIER_START_S
        while time.monotonic() < deadline:
            m = re.search(r"zookeeper server listening on (\S+)", self.output())
            if m:
                return m.group(1)
            check(self.proc.poll() is None, f"phase 11: zkserver exited: {self.output()[-2000:]}")
            time.sleep(0.1)
        raise AssertionError(f"phase 11: zkserver did not start: {self.output()[-2000:]}")

    def output(self):
        if not os.path.exists(self.log_path):
            return ""
        with open(self.log_path) as f:
            return f.read()

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait(timeout=30)


def _tool_output(main, argv):
    """(return code, standard output) of a CLI's main run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def evqlctl_statuses(url, names, down=None):
    """evqlctl cluster-list (the registry) and cluster-status (a ping of
    each server) over the registry at ``url``: every member of ``names``
    up, but ``down``, which both must show down."""
    out = {}
    for cmd in ("cluster-list", "cluster-status"):
        rc, text = _tool_output(evqlctl.main, ["-C", url, cmd])
        check(rc == 0, f"phase 11: evqlctl {cmd} returned {rc}")
        status = {line.split()[0]: line.split()[1] for line in text.splitlines()[2:] if line}
        want = {n: SERVER_DOWN if n == down else SERVER_UP for n in names}
        check(status == want, f"phase 11: evqlctl {cmd} shows {status}, not {want}")
        out[cmd] = status
    log(f"phase 11: evqlctl cluster-list and cluster-status show {out['cluster-status']}")
    return out


# a JavaScript MapReduce job (mapreduce/js_runtime.py's EVQL API): the
# headline GROUP BY's sum and count per key
MR_PROGRAM = """
var mapped = EVQL.mapTable({table: "TABLE", map_fn: function(row) {
  var v = parseInt(row.v, 10);
  return v < 800 ? [[row.k, v]] : [];
}});
var reduced = EVQL.reduce({sources: [mapped], shards: 4, reduce_fn: function(key, values) {
  var s = 0, c = 0;
  while (values.hasNext()) { s += parseInt(values.next(), 10); c += 1; }
  return [[key, [s, c]]];
}});
EVQL.downloadResults([reduced]);
"""


def mapreduce_expected(keys, v):
    """numpy's (key, [sum(v), count]) over the rows with v < 800."""
    keep = v < 800
    uniq, inv = np.unique(keys[keep], return_inverse=True)
    sums = np.bincount(inv, weights=v[keep].astype(np.float64), minlength=len(uniq))
    counts = np.bincount(inv, minlength=len(uniq))
    return sorted((str(k), [int(s), int(c)]) for k, s, c in zip(uniq, sums, counts))


def _pairs(results):
    return sorted((k, json.loads(v)) for k, v in results)


def distributed_mapreduce(url, want):
    """MR_PROGRAM over the cluster's table t through
    DistributedMapReduceScheduler: map shards on the partitions' replicas
    (failover down each replica list), reduce shards on live members."""
    provider = cluster_provider_from_config(url)
    try:
        sched = DistributedMapReduceScheduler(provider)
        (results, logs), ms = _timed(lambda: sched.execute_script(MR_PROGRAM.replace("TABLE", "t")))
    finally:
        provider.close()
    got = _pairs(results)
    check(got == want, f"phase 11: the distributed MapReduce job's {len(got)} pairs differ from"
                       f" numpy's {len(want)}: {got[:3]} / {want[:3]} ({logs[-3:]})")
    log(f"phase 11: the distributed MapReduce job: {len(want)} pairs equal to numpy in"
        f" {ms:.1f} ms, {sched.num_tasks_total} tasks")
    return dict(ms=ms, pairs=len(want), tasks=sched.num_tasks_total, logs=len(logs))


# -- phase 12: the tools on the card ----------------------------------------------------
#
# The port's other entry points, as their users run them, against phase 4's
# table on the card: (a) evqlbench in process, over its own synthetic table
# of N_ROWS rows (its default query is the headline GROUP BY: B1) and over a
# cstable file through -t; then a server holding the table in an in-memory
# TableService on the card (as phase 10's) for (b) evqlslap's query mode (4
# threads, unthrottled) and insert mode over HTTP, (c) the C client library,
# (d) the embedded C server API: the port's libevql_server.so loaded into this
# process and handed the table, and its C host program in a process of its
# own, (e) mysql2evql importing a mysqldump of the table's rows and (g)(i) a
# JavaScript MapReduce job over HTTP. (f) zkserver and evqlctl, and (g)(ii)
# the distributed MapReduce scheduler, run inside phase 11's cluster. Each
# step's route counters and launch counts are read just before and just
# after it; each kernel's first call in the phase is held against its plain
# version.

TOOLS_BENCH_ROUNDS = 5
TOOLS_CST_ROWS = 1 << 22  # phase 8's size
TOOLS_SLAP_THREADS = 4
TOOLS_SLAP_S = 5.0
TOOLS_SLAP_QUERIES = {  # query -> kernels a run launches
    "headline": ("groupby_agg",),
    "topk_ts_desc": ("groupby_agg", "extract_ge"),
    "G1_min_max_mean": ("hash_groupby",),
}
TOOLS_ROWBUFLEN = 1024  # rows a page of the C client's k_100000 fetch
# the cuts (PERF.md section 4): as many rows as about 15 s take, at the rates
# the port showed on the card's host (mysql2evql 31 000-49 000 rows a second,
# the JS interpreter's job 19 000-24 000)
TOOLS_IMPORT_ROWS = 500_000
TOOLS_IMPORT_BATCH = 1024
TOOLS_MR_ROWS = 1 << 18
ROUTE_COUNTERS = ("FUSED_GROUPBY_COUNT", "GENERAL_GROUPBY_COUNT", "SCAN_TOPK_COUNT",
                  "SCAN_ORDER_COUNT", "JOIN_GROUPBY_COUNT")


def _on_the_card(arguments):
    """Whether a call's arguments hold a CUDA tensor or name a CUDA device
    (the wrapper launches its kernel there; elsewhere it runs the plain
    version)."""
    for v in arguments.values():
        for t in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return True
            if isinstance(t, torch.device) and t.type == "cuda":
                return True
    return False


class _FirstCalls(_RecordedCalls):
    """_RecordedCalls that keeps only each kernel's first launching call,
    under the label of the step that made it (a load generator's
    thousands of calls would keep their tensors alive)."""

    def __init__(self):
        super().__init__()
        self.first, self.label, self._lock = {}, None, threading.Lock()

    def _recording(self, name, wrapper):
        sig = inspect.signature(wrapper)

        def call(*args, **kwargs):
            if name not in self.first:
                arguments = dict(sig.bind(*args, **kwargs).arguments)
                if _on_the_card(arguments):
                    with self._lock:
                        self.first.setdefault(name, (self.label, arguments))
            return wrapper(*args, **kwargs)

        return call


class _Steps:
    """Phase 12's steps: each one's launch counts zeroed just before it and
    read just after, and its route counters' rise. ``launching``: the
    routes run on the card (the plain versions on the CPU launch nothing)."""

    def __init__(self, rec, launching):
        self.rec, self.launching = rec, launching
        self.launches, self.routes, self.seconds = {}, {}, {}

    @contextlib.contextmanager
    def step(self, name):
        self.rec.label = name
        zero_launch_counts()
        before = {c: getattr(device_exec, c) for c in ROUTE_COUNTERS}
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = launch_counts()
        self.routes[name] = {c: getattr(device_exec, c) - before[c] for c in ROUTE_COUNTERS}

    def launched(self, name, kernels, what, times=None):
        for k in kernels:
            got = self.launches[name][k]
            check(not self.launching or (got == times if times else got > 0),
                  f"phase 12: {what}: {k} launched {got} times")


def _bench_numbers(text):
    best = re.search(r"best: ([\d.]+) ms  avg: ([\d.]+) ms", text)
    rows = re.search(r"result rows: (\d+)", text)
    thr = re.search(r"throughput: ([\d.]+) M input rows/s", text)
    check(best is not None and rows is not None, f"phase 12: evqlbench printed {text!r}")
    return dict(best_ms=float(best.group(1)), avg_ms=float(best.group(2)),
                result_rows=int(rows.group(1)),
                m_input_rows_per_s=float(thr.group(1)) if thr else None)


def tools_bench(steps, dev, tmp):
    """(a) evqlbench over its synthetic table (B1 six times: a warm-up and
    TOOLS_BENCH_ROUNDS rounds), its answer over the same table rebuilt
    from the tool's seed against numpy, then -t over a cstable file.
    ``dev``: "cuda", or "cpu" for the kernels' plain versions."""
    n, rounds = N_ROWS, TOOLS_BENCH_ROUNDS
    with steps.step("evqlbench"):
        rc, text = _tool_output(evqlbench.main, ["--device", dev, "--rows", str(n),
                                                 "-n", str(rounds)])
    check(rc == 0, f"phase 12: evqlbench returned {rc}")
    check(steps.routes["evqlbench"]["FUSED_GROUPBY_COUNT"] == rounds + 1,
          f"phase 12: evqlbench: {steps.routes['evqlbench']}")
    steps.launched("evqlbench", ("groupby_agg",), "evqlbench", times=rounds + 1)
    out = dict(rows=n, rounds=rounds, **_bench_numbers(text))
    with steps.step("evqlbench_answer"):
        rng = np.random.default_rng(42)  # the tool's table
        k = rng.integers(0, 1024, n).astype(np.uint64)
        v = rng.integers(0, 1000, n).astype(np.uint64)
        p = RelationTableProvider()
        ones = np.ones(n, bool)
        p.add_table("benchmark", Relation(
            ["k", "v"], [Column(SType.UINT64, k, ones), Column(SType.UINT64, v, ones)], n))
        rt = Runtime(device=dev)
        rows = run_query(rt, p, "select k, sum(v), count(1) from benchmark where v < 800"
                                " group by k;").rows
    occ, cnt, (sv,) = _bincounts(k.astype(np.int64), 1024, v < 800, v)
    check(sorted(rows) == sorted([str(o), str(int(s)), str(int(c))]
                                 for o, s, c in zip(occ, sv, cnt))
          and out["result_rows"] == len(occ), "phase 12: evqlbench's answer differs from numpy")
    del p, k, v, rows
    log(f"phase 12: evqlbench --device {dev} --rows {n} -n {rounds}: best {out['best_ms']} ms,"
        f" avg {out['avg_ms']} ms, {out['m_input_rows_per_s']} M input rows/s; B1 launched"
        f" {rounds + 1} times; its answer equal to numpy")

    m = TOOLS_CST_ROWS
    rng = np.random.default_rng(43)
    k = rng.integers(0, 1024, m).astype(np.uint64)
    v = rng.integers(0, 1000, m).astype(np.uint64)
    path = os.path.join(tmp, "bench.cst")
    ones = np.ones(m, bool)
    cstable_writer.write_cstable(path, Relation(
        ["k", "v"], [Column(SType.UINT64, k, ones), Column(SType.UINT64, v, ones)], m))
    cst = {}
    for name, query, want in (
            ("count", None, 1),
            ("group_by", "select k, sum(v), count(1) from t where v < 800 group by k;",
             len(np.unique(k[v < 800])))):
        step = f"evqlbench_cst_{name}"
        with steps.step(step):
            rc, text = _tool_output(evqlbench.main, ["--device", dev, "-t", f"t={path}", "-n",
                                                     "1"] + (["-q", query] if query else []))
        nums = _bench_numbers(text)
        check(rc == 0 and nums["result_rows"] == want,
              f"phase 12: evqlbench -t {step}: {text!r}")
        if name == "count":
            # the keyless count(1): the general route hands H1 no tensor,
            # only the device; a warm-up and one round, each a launch
            check(steps.routes[step]["GENERAL_GROUPBY_COUNT"] == 2,
                  f"phase 12: evqlbench -t {step}: routes {steps.routes[step]}")
            steps.launched(step, ("hash_groupby",), f"evqlbench -t {step}", times=2)
        routes = {c: d for c, d in steps.routes[step].items() if d}
        cst[name] = dict(query=query or "select count(1) from t;", routes=routes, **nums)
        log(f"phase 12: evqlbench -t t=<{m} rows>.cst {cst[name]['query']!r}: best"
            f" {nums['best_ms']} ms, served by {routes or 'no device route'}, launches"
            f" {steps.launches[step]}")
    out["cstable"] = dict(rows=m, **cst)
    return out


class _SlapTally(evqlslap.RollingStats):
    """evqlslap's RollingStats keeping the totals its windows reset."""

    made = []

    def __init__(self):
        super().__init__()
        self.total = dict(count=0, errors=0, latency_s=0.0, max_latency_s=0.0)
        _SlapTally.made.append(self)

    def record(self, latency, error):
        super().record(latency, error)
        with self.lock:
            t = self.total
            t["count"] += 1
            t["errors"] += int(error)
            t["latency_s"] += latency
            t["max_latency_s"] = max(t["max_latency_s"], latency)


def _slap(argv):
    """evqlslap's main in this process; (its totals, its printed counts)."""
    _SlapTally.made.clear()
    evqlslap.RollingStats = _SlapTally
    try:
        rc, text = _tool_output(evqlslap.main, argv)
    finally:
        evqlslap.RollingStats = _SlapTally.__bases__[0]
    check(rc == 0 and len(_SlapTally.made) == 1, f"phase 12: evqlslap returned {rc}")
    return _SlapTally.made[0].total, [int(x) for x in re.findall(r"rps: (\d+)", text)]


def tools_slap(steps, port, qs, phase10):
    """(b) evqlslap: each query of TOOLS_SLAP_QUERIES for TOOLS_SLAP_S s
    on TOOLS_SLAP_THREADS threads, then once more against numpy; then
    insert mode into a small table, whose count(*) equals the inserts the
    tool made."""
    out = {}
    for name, kernels in TOOLS_SLAP_QUERIES.items():
        _path, sql, expected, as_set, counter = qs[name]
        step = f"evqlslap_{name}"
        with steps.step(step):
            t0 = time.perf_counter()
            total, printed = _slap(["-p", str(port), "-t", str(TOOLS_SLAP_THREADS), "-d",
                                    str(TOOLS_SLAP_S), "-q", sql])
            wall = time.perf_counter() - t0
        check(total["errors"] == 0 and total["count"] > 0,
              f"phase 12: evqlslap {name}: {total}")
        check(steps.routes[step][counter] == total["count"],
              f"phase 12: evqlslap {name}: {counter} rose {steps.routes[step][counter]},"
              f" not once a request ({total['count']})")
        steps.launched(step, kernels, f"evqlslap {name}")
        rows, _nbytes = http_sql(port, sql)
        check(_same(rows, expected, as_set), f"phase 12: {name} after evqlslap differs from numpy")
        out[name] = dict(requests=total["count"], requests_per_s=total["count"] / wall,
                         mean_latency_ms=total["latency_s"] / total["count"] * 1e3,
                         max_latency_ms=total["max_latency_s"] * 1e3, printed=printed,
                         single_client_http_ms=phase10[name]["http_ms"])
        log(f"phase 12: evqlslap {name}: {total['count']} requests, 0 errors,"
            f" {out[name]['requests_per_s']:.2f} a second, latency mean"
            f" {out[name]['mean_latency_ms']:.3f} ms max {out[name]['max_latency_ms']:.3f} ms"
            f" (phase 10, one client: {phase10[name]['http_ms']:.3f} ms)")
    http_sql(port, _create_sql("slap", [("id", SType.UINT64), ("value", SType.UINT64)], pk="id"))
    with steps.step("evqlslap_insert"):
        total, printed = _slap(["-p", str(port), "-m", "insert", "--table", "slap", "-t",
                                str(TOOLS_SLAP_THREADS), "-d", str(TOOLS_SLAP_S)])
    rows, _nbytes = http_sql(port, "select count(*) from slap;")
    made = total["count"] - total["errors"]
    check(total["errors"] == 0 and rows == [[str(made)]] and sum(printed) <= made,
          f"phase 12: evqlslap insert: {total}, count(*) {rows}")
    out["insert"] = dict(inserts=made, inserts_per_s=made / TOOLS_SLAP_S,
                         printed=sum(printed), mean_latency_ms=total["latency_s"] / made * 1e3)
    log(f"phase 12: evqlslap insert: {made} inserts ({sum(printed)} in its printed windows),"
        f" count(*) equal")
    return out


def _cclient_setopt(lib):
    lib.evql_client_setopt.restype = ctypes.c_int
    lib.evql_client_setopt.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_size_t, ctypes.c_long]
    return lib.evql_client_setopt


def tools_cclient(steps, port, qs):
    """(c) the C client: the headline, and k_100000 fetched in pages of
    TOOLS_ROWBUFLEN rows."""
    out = {}
    c = cclient.CClient("127.0.0.1", port)
    try:
        for name, rowbuf in (("headline", None), ("k_100000", TOOLS_ROWBUFLEN)):
            _path, sql, expected, as_set, counter = qs[name]
            if rowbuf:
                check(_cclient_setopt(c._lib)(c._c, 2, struct.pack("<Q", rowbuf), 8, 0) == 0,
                      "phase 12: evql_client_setopt(ROWBUFLEN)")
            step = f"cclient_{name}"
            with steps.step(step):
                ((_cols, rows),), ms = _timed(lambda: c.query(sql))
            check(_same(rows, expected, as_set), f"phase 12: {name} through the C client differs"
                                                 " from numpy")
            check(steps.routes[step][counter] == 1, f"phase 12: C client {name}: {counter}")
            steps.launched(step, ("groupby_agg",), f"C client {name}")
            out[name] = dict(rows=len(rows), ms=ms, rows_a_page=rowbuf,
                             pages=-(-len(rows) // rowbuf) if rowbuf else 1)
            log(f"phase 12: C client {name}: {len(rows)} rows equal to numpy in {ms:.1f} ms"
                + (f" ({out[name]['pages']} pages of {rowbuf})" if rowbuf else ""))
    finally:
        c.close()
    return out


def _server_lib():
    lib = ctypes.CDLL(native_build.path(native_build.SERVER_LIB))
    lib.evql_server_init.restype = ctypes.c_void_p
    lib.evql_server_init.argtypes = [ctypes.c_void_p]
    for name in ("evql_server_start", "evql_server_getport"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.evql_server_listen.restype = ctypes.c_int
    lib.evql_server_listen.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("evql_server_geterror", "evql_server_getconf"):
        getattr(lib, name).restype = ctypes.c_char_p
    lib.evql_server_geterror.argtypes = [ctypes.c_void_p]
    lib.evql_server_getconf.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    for name in ("evql_server_shutdown", "evql_server_free"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    clib = cclient._load()
    clib.evql_conf_init.restype = ctypes.c_void_p
    clib.evql_conf_set.restype = ctypes.c_int
    clib.evql_conf_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    clib.evql_conf_free.restype = None
    clib.evql_conf_free.argtypes = [ctypes.c_void_p]
    return lib, clib


def tools_embedded(steps, dev, svc, qs):
    """(d)(i) the port's libevql_server.so in this process: server.device =
    ``dev``, its table service handed the table, the headline through the C
    client; (ii) its C host program with server.device=``dev``."""
    lib, clib = _server_lib()
    conf = clib.evql_conf_init()
    for key, value in (("server.listen", "127.0.0.1:0"), ("server.device", dev)):
        check(clib.evql_conf_set(conf, key.encode(), value.encode()) == 0, "phase 12: conf")
    server = lib.evql_server_init(conf)
    kill_r, kill_w = os.pipe()
    listener = None
    try:
        check(lib.evql_server_start(server) == 0,
              f"phase 12: evql_server_start: {lib.evql_server_geterror(server)}")
        embedded = ctypes.cast(server, ctypes.POINTER(ctypes.py_object))[0]
        check(embedded.http.runtime.device.type == dev,
              "phase 12: the embedded server's device")
        embedded.table_service.tables["t"] = svc.tables["t"]
        embedded.table_service.bump_schema_version()
        listener = threading.Thread(target=lib.evql_server_listen, args=(server, kill_r),
                                    daemon=True)
        listener.start()
        _until("the embedded server to listen", lambda: embedded.listener is not None)
        _path, sql, expected, as_set, counter = qs["headline"]
        c = cclient.CClient("127.0.0.1", embedded.listener.port)
        try:
            with steps.step("embedded_in_process"):
                ((_cols, rows),), ms = _timed(lambda: c.query(sql))
        finally:
            c.close()
        check(_same(rows, expected, as_set), "phase 12: the embedded server's headline differs")
        check(steps.routes["embedded_in_process"][counter] == 1, "phase 12: embedded route")
        steps.launched("embedded_in_process", ("groupby_agg",), "the embedded server")
        os.write(kill_w, b"x")
        listener.join(timeout=60)
        check(not listener.is_alive(), "phase 12: evql_server_listen did not return")
    finally:
        if listener is not None and listener.is_alive():
            os.write(kill_w, b"x")
            listener.join(timeout=60)
        lib.evql_server_shutdown(server)
        lib.evql_server_free(server)
        clib.evql_conf_free(conf)
        os.close(kill_r)
        os.close(kill_w)
    log(f"phase 12: libevql_server.so in process (server.device={dev}): the headline through"
        f" the C client equal to numpy in {ms:.1f} ms, B1 launched")
    (host, host_s) = _timed(lambda: subprocess.run(
        [native_build.path(native_build.SMOKE_BIN), f"server.device={dev}"], capture_output=True,
        text=True, timeout=600, env=native_build.host_env()))
    check(host.returncode == 0 and "embedded server smoke OK" in host.stdout,
          f"phase 12: the C host: {host.returncode} {host.stdout[-1000:]} {host.stderr[-2000:]}")
    log(f"phase 12: the C host embedded_server_smoke server.device={dev}: {host.stdout.strip()}"
        f" in {host_s / 1e3:.1f} s")
    return dict(in_process_ms=ms, c_host_s=host_s / 1e3, c_host=host.stdout.strip())


def _mysqldump(path, stored, dictionary, m):
    """A mysqldump of rows [0, m) of the table: an ``id`` primary key and
    phase 4's columns k, v, w, ts, in extended INSERTs of 1000 rows."""
    names = np.asarray([d.decode() for d in dictionary], dtype=object)
    with open(path, "w") as f:
        f.write("CREATE TABLE `imp` (\n  `id` bigint(20) unsigned NOT NULL,\n"
                "  `k` varchar(16) NOT NULL,\n  `v` bigint(20) unsigned NOT NULL,\n"
                "  `w` bigint(20) unsigned NOT NULL,\n  `ts` bigint(20) unsigned NOT NULL,\n"
                "  PRIMARY KEY (`id`)\n) ENGINE=InnoDB DEFAULT CHARSET=utf8;\n")
        k, v, w, ts = (stored[c][:m] for c in ("k", "v", "w", "ts"))
        for a in range(0, m, 1000):
            b = min(m, a + 1000)
            f.write("INSERT INTO `imp` VALUES " + ",".join(
                f"({i},'{names[k[i]]}',{v[i]},{w[i]},{ts[i]})" for i in range(a, b)) + ";\n")


def tools_mysql2evql(steps, port, stored, dictionary, tmp):
    """(e) mysql2evql --source_file of TOOLS_IMPORT_ROWS rows into the
    server; the headline, G1 and the top-k over ``ts`` (u64 values above
    2^53: read exactly, ROADMAP C15) over the imported table against
    numpy."""
    m = TOOLS_IMPORT_ROWS
    path = os.path.join(tmp, "dump.sql")
    _mysqldump(path, stored, dictionary, m)
    with steps.step("mysql2evql"):
        t0 = time.perf_counter()
        rc, text = _tool_output(mysql2evql.main, [
            "--source_file", path, "--source_table", "imp", "--port", str(port),
            "--batch_size", str(TOOLS_IMPORT_BATCH)])
        import_s = time.perf_counter() - t0
    check(rc == 0 and f"imported {m} rows into imp" in text, f"phase 12: mysql2evql: {text!r}")
    sub = {c: stored[c][:m] for c in stored}
    want = {q[0]: (q[1], q[4], True) for q in queries(sub, dictionary, cat_lo=0)}
    want.update({name: (sql, rows, False)
                 for name, sql, rows in general_queries(sub, dictionary, m, cat_lo=0)})
    want.update({q[0]: (q[1], q[4], False) for q in order_queries(sub, dictionary, m)})
    check(int(sub["ts"].max()) > 1 << 53, "phase 12: no ts above 2^53 in the import")
    out = dict(rows=m, rows_wanted="about 15 s of import", import_s=import_s,
               rows_per_s=m / import_s, queries={})
    # below FAST_TOPK_ROWS the top-k launches no kernel
    for name, counter, kernel in (("headline", "FUSED_GROUPBY_COUNT", ("groupby_agg",)),
                                  ("G1_min_max_mean", "GENERAL_GROUPBY_COUNT", ("hash_groupby",)),
                                  ("topk_ts_desc", "SCAN_TOPK_COUNT", ())):
        sql, expected, as_set = want[name]
        step = f"mysql2evql_{name}"
        with steps.step(step):
            (rows, _b), ms = _timed(lambda: http_sql(port, sql.replace(" from t ", " from imp ")))
        check(_same(rows, expected, as_set), f"phase 12: {name} over the import differs")
        check(steps.routes[step][counter] == 1, f"phase 12: {name} over the import: {counter}")
        steps.launched(step, kernel, f"{name} over the import")
        out["queries"][name] = dict(ms=ms, rows=len(rows))
    log(f"phase 12: mysql2evql imported {m} rows in {import_s:.1f} s"
        f" ({m / import_s:.0f} rows a second); the headline, G1 and the top-k over ts"
        f" over them equal to numpy")
    return out


def tools_mapreduce(steps, port, svc, stored, dictionary):
    """(g)(i) MR_PROGRAM over TOOLS_MR_ROWS rows of the table, POSTed to
    /api/v1/mapreduce/execute: its pairs against numpy."""
    m = TOOLS_MR_ROWS
    host = Runtime(device=None)
    host.build_query_plan(host.new_transaction(svc), _create_sql(
        "mr", [("k", SType.STRING), ("v", SType.UINT64)])).execute(0)
    svc.tables["mr"].insert_batch(_batch([("k", SType.STRING), ("v", SType.UINT64)], stored,
                                         0, m, {"k": dictionary}))
    with steps.step("mapreduce"):
        (status, body), ms = _timed(lambda: _http_post(
            port, "/api/v1/mapreduce/execute", MR_PROGRAM.replace("TABLE", "mr").encode(),
            timeout=900))
    text = body.decode()
    results = []
    for block in text.split("\n\n"):
        lines = block.strip().split("\n")
        if lines[0] == "event: result":
            r = json.loads(urllib.parse.unquote(lines[1][len("data: "):]))
            results.append((r["key"], r["value"]))
    want = mapreduce_expected(np.asarray([d.decode() for d in dictionary],
                                         dtype=object)[stored["k"][:m]], stored["v"][:m])
    check(status == 200 and "event: job_finished" in text and _pairs(results) == want,
          f"phase 12: the MapReduce job's pairs differ from numpy: {text[-2000:]}")
    log(f"phase 12: a JavaScript MapReduce job over {m} rows: {len(want)} pairs equal to numpy"
        f" in {ms / 1e3:.1f} s ({m / ms * 1e3:.0f} rows a second)")
    return dict(rows=m, rows_wanted="about 15 s of the job", ms=ms, rows_per_s=m / ms * 1e3,
                pairs=len(want))


def phase_tools(device, tables, phase10, cluster_tools):
    """Phase 12 with the tools' routes on ``device`` ("cuda"; "cpu" runs the
    kernels' plain versions). Returns the {"tools": ...} numbers, the
    launches by step and each kernel's first call in the phase."""
    t_phase = time.perf_counter()
    dev = "cuda" if torch.device(device).type == "cuda" else "cpu"
    cols, dictionary = tables["cols"], tables["dictionary"]
    n = len(cols["k"])
    tmp = tempfile.mkdtemp(prefix="evql_phase12_")
    rec = _FirstCalls()
    steps = _Steps(rec, dev == "cuda")
    out = {}
    try:
        with rec:
            out["evqlbench"] = tools_bench(steps, dev, tmp)
            stored = stored_columns(cols)
            qs = serving_queries(tables, dict(cols, cat=cols["cat"] - CAT_LO), n)
            svc = serving_service(stored, dictionary, tables["dims"], 0, n)
            http = EventQLServer(svc, device=dev).start(bind=False)
            native_srv = NativeTCPServer(svc, device=dev)
            lis = Listener(http, native_srv, port=0).start()
            try:
                out["evqlslap"] = tools_slap(steps, lis.port, qs, phase10)
                out["cclient"] = tools_cclient(steps, lis.port, qs)
                out["embedded"] = tools_embedded(steps, dev, svc, qs)
                out["mysql2evql"] = tools_mysql2evql(steps, lis.port, stored, dictionary, tmp)
                out["mapreduce"] = tools_mapreduce(steps, lis.port, svc, stored, dictionary)
            finally:
                lis.stop()
                http.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for kernel in ("groupby_agg", "extract_ge", "hash_groupby"):
        check(not steps.launching or sum(c[kernel] for c in steps.launches.values()) > 0,
              f"phase 12: {kernel} not launched")
    out.update(cluster=cluster_tools, launches=steps.launches,
               routes={s: {c: d for c, d in r.items() if d} for s, r in steps.routes.items()},
               step_s=steps.seconds, phase_s=time.perf_counter() - t_phase)
    log(f"phase 12: the tools on the card in {out['phase_s']:.1f} s")
    return out, steps.launches, rec.first


_REPLACES = {
    "hash_groupby": ("eventql_tpu_torch/kernels/csrc/hash_groupby.cu",
                     "eventql_tpu/kernels/groupby.py:246 (not a TPU kernel:"
                     " masked_grouped_aggregate, and :380 masked_grouped_count_distinct)",
                     "evql_hash_direct + evql_hash_distinct_direct (shared and global"
                     " tiers); evql_hash_group_ids + evql_hash_aggregate +"
                     " evql_hash_count_distinct (hash tier)"),
    "groupby_agg": ("eventql_tpu_torch/kernels/csrc/groupby_agg.cu",
                    "eventql_tpu/kernels/pallas_groupby.py:109", "evql_groupby_agg"),
    "groupby_multi_agg": ("eventql_tpu_torch/kernels/csrc/groupby_agg.cu",
                          "eventql_tpu/kernels/pallas_groupby.py:698",
                          "evql_groupby_multi_agg"),
    "extract_ge": ("eventql_tpu_torch/kernels/csrc/extract.cu",
                   "eventql_tpu/kernels/extract.py:29", "evql_extract_ge"),
    "dim_join_gid": ("eventql_tpu_torch/kernels/csrc/join.cu",
                     "eventql_tpu/kernels/join.py:142", "evql_dim_join_gid"),
    "probe_join_gid": ("eventql_tpu_torch/kernels/csrc/join.cu",
                       "eventql_tpu/kernels/join.py:449",
                       "evql_build_join_table + evql_probe_join_table"),
}


def main():
    if len(sys.argv) == 8 and sys.argv[1] == MULTIHOST_FLAG:  # one process of phase 7
        rank, world, port = (int(x) for x in sys.argv[2:5])
        multihost_worker(rank, world, port, *sys.argv[5:8])
        return
    if len(sys.argv) > 1:
        sys.exit("chip_smoke: takes no arguments; the size is the slice's")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    secs = _build.build_all(verbose=True)
    for name in _build.sources():
        _build.load(name)
    PARENT.update(parent_kernels())
    parent = PARENT["join"].dim_join_gid if PARENT else None
    parent_secs = PARENT["join"]._build.build_all() if PARENT else 0.0
    log(f"phase 2: kernels built in {secs:.1f} s: {_build.sources()}"
        + (f"; the earlier tree's in {parent_secs:.1f} s from ${PARENT_TREE}" if PARENT else ""))

    probe_errs = phase_kernels(device, N_KERNEL_CASE_ROWS)
    probe = phase_probes(device)
    run = phase_main_path(device, N_ROWS, N_PREFIX_ROWS, REPS)
    expr_run = phase_expr_program(device, run, REPS)
    times = phase_times(device, run["calls"], parent)
    context = _topk_context(device, run["calls"])
    del run["calls"]
    tables = run.pop("tables")
    mesh_run = phase_mesh(device, tables, MESH_REPS)
    # what phase 10 serves again: the table's columns and the answers
    serving_tables = {k: tables[k] for k in ("cols", "dictionary", "dims", "oqs", "jqs")}
    del tables
    shard_shapes = mesh_shapes(mesh_run.pop("first_calls"))
    multi = phase_multihost(mesh_run["kernel_tier"])
    multi_launches = multi["backends"]["gloo"]["launches"]
    storage, storage_launches, storage_first = phase_storage(device)
    storage_shapes = mesh_shapes(storage_first, "phase 8", "stored")
    fuzz = phase_fuzz(device)
    serving, serving_first, cluster_first = phase_serving("cuda", serving_tables, run["e2e"])
    serving_shapes = mesh_shapes(serving_first, "phase 10", "serving")
    cluster_shapes = mesh_shapes(cluster_first, "phase 10", "cluster")
    del serving_first, cluster_first
    charts, chart_launches, chart_first = phase_charts(
        device, serving_tables["cols"], serving_tables["dictionary"], run["e2e"])
    chart_shapes = mesh_shapes(chart_first, "phase 11", "chart")
    del chart_first
    cluster_tools, tier = phase_cluster(device)
    tools, tools_launches, tools_first = phase_tools(device, serving_tables, serving["queries"],
                                                     cluster_tools)
    del serving_tables
    tools_shapes = mesh_shapes(tools_first, "phase 12", "tools")
    del tools_first
    kernels = []
    for name, t in times.items():
        source, replaces, entry = _REPLACES[name]
        check(run["launches"][name] > 0, f"{name}: not launched on a main path")
        launches_by_path = {p: c[name] for p, c in run["launches_by_path"].items()}
        launches_by_path["mesh"] = mesh_run["launches"][name]
        launches_by_path["multihost"] = multi_launches[name]
        launches_by_path["storage"] = sum(c[name] for c in storage_launches.values())
        launches_by_path["serving"] = sum(c[name] for c in serving["launches"].values())
        launches_by_path["charts"] = sum(c[name] for c in chart_launches.values())
        launches_by_path["tools"] = sum(c[name] for c in tools_launches.values())
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "entry": entry,
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            "shape": t["shape"],
            "bytes": t["bytes"],
            "other_shapes": t["other_shapes"],
            "mesh_shape": shard_shapes.get(name),
            "storage_shape": storage_shapes.get(name),
            "serving_shape": serving_shapes.get(name),
            "cluster_shape": cluster_shapes.get(name),
            "chart_shape": chart_shapes.get(name),
            "tools_shape": tools_shapes.get(name),
        })
        # probe_join_gid: its table-build kernels alone; dim_join_gid: one
        # row (its table build) and the earlier kernel; hash_groupby: its
        # groups, and its group ids + count + first row alone
        for key in ("build_ms", "one_row_device_ms", "one_row_one_dim_device_ms",
                    "parent_ms", "parent", "turns_ms", "turns_new_ms", "groups",
                    "ids_count_first_ms", "tier",
                    "hash_tier_ms", "hash_tier_ids_count_first_ms", "peak_bytes",
                    "hash_tier_peak_bytes"):
            if key in t:
                kernels[-1][key] = t[key]
    kernels.append(expr_program_row(expr_run))
    kernels += probe_kernel_rows(probe, probe_errs)
    log(json.dumps({"e2e_ms": run["e2e"], "rows": N_ROWS,
                    "launches_per_query": run["per_query"],
                    "device_bytes_held": run["resident"],
                    "peak_bytes_general_group_by": run["peak_general"],
                    "topk_context": context}))
    log(json.dumps({"mesh": {"shards": MESH_SHARDS, "device": str(device),
                             "queries": mesh_run["per_query"],
                             "kernel_tier": mesh_run["kernel_tier"]}}))
    log(json.dumps({"multihost": multi}))
    log(json.dumps({"storage": storage}))
    log(json.dumps({"fuzz": fuzz}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"cluster": dict(card=smi, charts=charts, chart_launches=chart_launches,
                                    tier=tier)}))
    log(json.dumps({"tools": dict(card=smi, **tools)}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
