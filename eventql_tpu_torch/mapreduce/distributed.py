"""Distributed MapReduce: shards executed on the cluster nodes that
own the data.

Re-implements the reference's MapReduce execution tier:
  * map shards run on a partition's replica servers via
    POST /api/v1/mapreduce/tasks/map_partition (SSE response carrying
    result_id / log / error events) with a cache-only first round and
    per-replica failover (reference: mapreduce/tasks/map_table.cc:94-141
    execute, :143-262 executeRemote);
  * reduce shards are placed on allocator-chosen servers and pull their
    inputs straight from the map servers' result caches with
    ?sample=<mod>:<idx> key-hash sharding (reference:
    mapreduce/tasks/reduce.cc:67-130 + mapreduce_servlet.cc
    fetchResult);
  * results are content-addressed sstables downloaded as
    [u32 klen][u32 vlen][key][val]... [0][0] octet streams in the
    platform byte order (reference: MapReduceService::downloadResult,
    mapreduce_service.cc:366-425; BinaryMessageWriter::appendUInt32 is
    native little-endian);
  * the scheduler runs shards dependency-ordered with a bounded pool
    and a random placement shuffle (reference:
    mapreduce_scheduler.cc:49-203, kDefaultMaxConcurrentTasks=64).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import random
import struct
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, urlencode

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.mapreduce.service import (
    DEFAULT_MAX_CONCURRENT_TASKS,
    _as_str,
)

_LEN = struct.Struct("<II")


def download_result(url: str, timeout: float = 30.0):
    """Stream a result table: yields (key, value) byte pairs; raises on
    a missing [0][0] end-of-stream record (reference:
    MapReduceService::downloadResult, mapreduce_service.cc:366-425)."""
    req = urllib.request.Request(url)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError_(
                f"received non-200 response for {url}: {resp.status}"
            )
        buf = b""
        eos = False
        while True:
            chunk = resp.read(65536)
            if not chunk:
                break
            buf += chunk
            while len(buf) >= 8:
                klen, vlen = _LEN.unpack_from(buf)
                if klen == 0 and vlen == 0:
                    eos = True
                    buf = buf[8:]
                    continue
                if len(buf) - 8 < klen + vlen:
                    break
                yield buf[8 : 8 + klen], buf[8 + klen : 8 + klen + vlen]
                buf = buf[8 + klen + vlen :]
        if not eos:
            raise RuntimeError_("unexpected EOF")


def _sse_events(resp):
    """Parse an SSE stream into (event, data) pairs."""
    event, data = None, []
    for raw in resp:
        line = raw.decode("utf-8", "replace").rstrip("\r\n")
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data.append(line[5:].lstrip())
        elif line == "" and event is not None:
            yield event, "\n".join(data)
            event, data = None, []
    if event is not None:
        yield event, "\n".join(data)


def post_task(addr: str, path: str, params: List[Tuple[str, str]],
              timeout: float = 600.0,
              on_log: Optional[Callable[[str], None]] = None):
    """POST a task RPC whose body is a urlencoded parameter list and
    whose response is an SSE stream; returns the result_id event's data
    (None for an empty result or a 204 cache miss). The reference's
    task clients parse the same three event names
    (map_table.cc:180-200, reduce.cc:170-190)."""
    from urllib.parse import unquote

    url = f"http://{addr}{path}"
    body = urlencode(params).encode()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        raise RuntimeError_(f"HTTP Error ({e.code}): {url}")
    with resp:
        if resp.status == 204:
            return None
        if resp.status != 200:
            raise RuntimeError_(f"HTTP Error ({resp.status}): {url}")
        result_id = None
        errors = []
        for event, data in _sse_events(resp):
            if event == "result_id":
                result_id = data or None
            elif event == "log" and on_log is not None:
                on_log(unquote(data))
            elif event == "error":
                errors.append(data)
        if errors:
            raise RuntimeError_("; ".join(errors))
        return result_id


class DistributedMapReduceScheduler:
    """Runs a task DAG across the cluster (reference:
    MapReduceScheduler + MapReduceTaskBuilder). Job specs are the same
    dicts MapReduceService.execute accepts; map_table shards go to the
    partition owners, reduce shards to allocator-placed servers."""

    def __init__(
        self,
        provider,  # ClusterTableProvider: metadata + server address book
        max_concurrent_tasks: int = DEFAULT_MAX_CONCURRENT_TASKS,
        on_log: Optional[Callable[[str], None]] = None,
        on_progress: Optional[Callable[[int, int, int], None]] = None,
    ):
        self.provider = provider
        self.max_concurrent_tasks = max_concurrent_tasks
        self.on_log = on_log or (lambda line: None)
        self.on_progress = on_progress or (lambda total, done, running: None)
        self._sem = threading.Semaphore(max_concurrent_tasks)
        self.num_tasks_total = 0
        self.num_tasks_completed = 0
        self.num_tasks_running = 0
        self._counts = threading.Lock()

    # -- address helpers -------------------------------------------------
    def _addr_str(self, server_id: str) -> Optional[str]:
        addr = self.provider._addr_of(server_id)
        if addr is None:
            return None
        return f"{addr[0]}:{addr[1]}"

    def _live_server_ids(self) -> List[str]:
        from eventql_tpu_torch.config.config_directory import SERVER_UP

        cdir = getattr(self.provider, "cdir", None)
        if cdir is not None:
            return [
                s.server_id
                for s in cdir.list_servers()
                if s.server_status == SERVER_UP
            ]
        return [f"{h}:{p}" for h, p in self.provider.workers]

    # -- shard bookkeeping ------------------------------------------------
    def _start_shards(self, n: int):
        with self._counts:
            self.num_tasks_total += n
        self.on_progress(
            self.num_tasks_total, self.num_tasks_completed,
            self.num_tasks_running)

    def _run_pool(self, fns):
        """Run shard thunks under the global concurrency cap in a
        random order (reference: random_shuffle of shard_perms_,
        mapreduce_scheduler.cc:71)."""
        order = list(range(len(fns)))
        random.shuffle(order)
        results = [None] * len(fns)

        def one(i):
            with self._sem:
                with self._counts:
                    self.num_tasks_running += 1
                try:
                    return fns[i]()
                finally:
                    with self._counts:
                        self.num_tasks_running -= 1
                        self.num_tasks_completed += 1
                    self.on_progress(
                        self.num_tasks_total,
                        self.num_tasks_completed,
                        self.num_tasks_running,
                    )

        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(self.max_concurrent_tasks, max(len(fns), 1))
        ) as pool:
            futs = {pool.submit(one, i): i for i in order}
            for fut in concurrent.futures.as_completed(futs):
                results[futs[fut]] = fut.result()
        return results

    # -- task execution ----------------------------------------------------
    def _map_table(self, spec: dict) -> List[Tuple[str, str]]:
        """One map shard per partition, executed on a replica server;
        returns [(server_addr, result_id)] for non-empty shards
        (reference: MapTableTask, tasks/map_table.cc)."""
        table = spec.get("table") or spec["table_name"]
        meta = self.provider._table_metadata(table)
        if meta is None:
            raise RuntimeError_(f"table not found: {table}")

        entries = meta.entries
        kb, kl = spec.get("keyrange_begin"), spec.get("keyrange_limit")
        if kb is not None or kl is not None:
            entries = [
                e
                for e in entries
                if _keyranges_overlap(meta, e, kb, kl)
            ]

        params_base = [
            ("table", table),
            ("map_function", spec["map_fn"]),
            ("globals", _as_str(spec.get("globals", ""))),
            ("params", _as_str(spec.get("params", ""))),
            ("required_columns",
             ",".join(spec.get("required_columns", []) or [])),
        ]

        def run_shard(entry):
            params = params_base + [("partition", entry.partition_id)]
            # round 1: cache only (reference: map_table.cc:99-115)
            for sid in entry.servers:
                addr = self._addr_str(sid)
                if addr is None:
                    continue
                try:
                    rid = post_task(
                        addr,
                        "/api/v1/mapreduce/tasks/map_partition",
                        params + [("cache_only", "true")],
                        on_log=self.on_log,
                    )
                    if rid is not None:
                        return (addr, rid)
                except Exception:
                    continue
            # round 2: execute, failover down the replica list
            errors = []
            for sid in entry.servers:
                addr = self._addr_str(sid)
                if addr is None:
                    continue
                try:
                    rid = post_task(
                        addr,
                        "/api/v1/mapreduce/tasks/map_partition",
                        params,
                        on_log=self.on_log,
                    )
                    return (addr, rid) if rid is not None else None
                except Exception as e:  # noqa: BLE001 — replica failover
                    errors.append(str(e))
            # tolerate failed shards (reference: map_table.cc:131-140)
            self.on_log(
                f"map shard {entry.partition_id} failed on every replica: "
                + "; ".join(errors)
            )
            failed.append(entry)
            return None

        failed = []
        self._start_shards(len(entries))
        results = [r for r in self._run_pool(
            [lambda e=e: run_shard(e) for e in entries]) if r is not None]
        # A partition that split while the job ran is gone from the
        # metadata by the time its replicas look it up, so every replica
        # fails its shard: map the partitions that now cover its keyrange
        # instead (partitions split, never merge). A failed shard of a
        # partition that still exists stays tolerated.
        while failed:
            now = self.provider._table_metadata(table)
            if now is None:
                break
            entries = [
                c
                for e in failed
                if now.find(e.partition_id) is None
                for c in now.entries
                if _keyranges_overlap(now, c, *meta.keyrange(e.partition_id))
                and _keyranges_overlap(now, c, kb, kl)
            ]
            failed.clear()
            meta = now
            if not entries:
                break
            self.on_log(
                f"{len(entries)} map shard(s) over the partitions that"
                " split while the job ran"
            )
            self._start_shards(len(entries))
            results += [r for r in self._run_pool(
                [lambda e=e: run_shard(e) for e in entries]) if r is not None]
        return results

    def _reduce(self, spec: dict, inputs) -> List[Tuple[str, str]]:
        """num_shards reduce tasks, each sampling its key share of every
        input; placed on stable allocator-chosen servers (reference:
        ReduceTask, tasks/reduce.cc:67-130)."""
        num_shards = max(1, int(spec.get("num_shards", 1)))
        shards = []
        for shard_idx in range(num_shards):
            input_urls = [
                f"http://{addr}/api/v1/mapreduce/result/{rid}"
                f"?sample={num_shards}:{shard_idx}"
                for addr, rid in inputs
            ]
            shards.append((shard_idx, input_urls))

        live = self._live_server_ids()
        if not live:
            raise RuntimeError_("no available servers")

        def run_shard(shard_idx, input_urls):
            placement = hashlib.sha1(
                ("~".join(sorted(input_urls)) + f"~{shard_idx}").encode()
            ).hexdigest()
            # stable placement: rendezvous-hash the live servers
            # (reference: ServerAllocator::allocateStable BEST_EFFORT)
            order = sorted(
                live,
                key=lambda sid: hashlib.sha1(
                    f"{placement}~{sid}".encode()).hexdigest(),
            )
            params = [
                ("reduce_fn", spec["reduce_fn"]),
                ("globals", _as_str(spec.get("globals", ""))),
                ("params", _as_str(spec.get("params", ""))),
            ] + [("input_table", u) for u in input_urls]
            errors = []
            for sid in order:
                addr = self._addr_str(sid)
                if addr is None:
                    continue
                try:
                    rid = post_task(
                        addr,
                        "/api/v1/mapreduce/tasks/reduce",
                        params,
                        on_log=self.on_log,
                    )
                    return (addr, rid) if rid is not None else None
                except Exception as e:  # noqa: BLE001 — failover
                    errors.append(str(e))
            raise RuntimeError_(
                "ReduceTask::execute failed: " + ", ".join(errors)
            )

        self._start_shards(len(shards))
        return [
            r
            for r in self._run_pool(
                [lambda s=s: run_shard(*s) for s in shards]
            )
            if r is not None
        ]

    def _download(self, results) -> List[Tuple[str, str]]:
        """Pull final result tables back to the coordinator (reference:
        MapReduceScheduler::downloadResult)."""
        out: List[Tuple[str, str]] = []
        for addr, rid in results:
            url = f"http://{addr}/api/v1/mapreduce/result/{rid}"
            for k, v in download_result(url):
                out.append(
                    (k.decode("utf-8", "replace"),
                     v.decode("utf-8", "replace"))
                )
        return out

    # -- job DAG ------------------------------------------------------------
    def execute(self, job_spec: dict) -> List[List[Tuple[str, str]]]:
        jobs = job_spec.get("jobs", {})
        cache: Dict[str, List[Tuple[str, str]]] = {}
        return [
            self._run_job(t, jobs, cache) for t in job_spec.get("execute", [])
        ]

    def execute_script(self, program: str):
        """JS job programs over the distributed tier (same surface as
        MapReduceService.execute_script)."""
        from eventql_tpu_torch.mapreduce.js_runtime import (
            JobContext,
            normalize_task_spec,
        )

        results: List[Tuple[str, str]] = []
        logs: List[str] = []
        prev_log = self.on_log
        self.on_log = logs.append

        def execute_tasks(task_list, root_id):
            jobs = {t["id"]: normalize_task_spec(t) for t in task_list}
            results.extend(self._run_job(root_id, jobs, {}))

        ctx = JobContext(
            execute_tasks=execute_tasks,
            write_output=lambda s: results.append(("", s)),
            log_fn=logs.append,
        )
        try:
            ctx.run(program)
        finally:
            self.on_log = prev_log
        return results, logs

    def _run_results(self, sources, jobs, cache):
        """Source tasks produce (addr, result_id) handles."""
        handles = []
        for src in sources:
            handles.extend(self._run_task(src, jobs, cache))
        return handles

    def _run_task(self, name, jobs, cache) -> List[Tuple[str, str]]:
        if name in cache:
            return cache[name]
        spec = jobs.get(name)
        if spec is None:
            raise RuntimeError_(f"unknown job: '{name}'")
        op = spec.get("op")
        if op == "map_table":
            out = self._map_table(spec)
        elif op == "reduce":
            inputs = self._run_results(spec.get("sources", []), jobs, cache)
            out = self._reduce(spec, inputs)
        else:
            raise RuntimeError_(
                f"mapreduce op cannot produce a result table: '{op}'"
            )
        cache[name] = out
        return out

    def _run_job(self, name, jobs, cache) -> List[Tuple[str, str]]:
        """Terminal ops: download / save the referenced result tables."""
        spec = jobs.get(name)
        if spec is None:
            raise RuntimeError_(f"unknown job: '{name}'")
        op = spec.get("op")

        if op == "return_results":
            handles = self._run_results(spec.get("sources", []), jobs, cache)
            out = self._download(handles)
            serialize_src = spec.get("serialize_fn") or ""
            if serialize_src:
                from eventql_tpu_torch.mapreduce.js_runtime import TaskContext

                ser = TaskContext(
                    serialize_src,
                    _as_str(spec.get("globals", "")),
                    _as_str(spec.get("params", "")),
                )
                out = [
                    ("", s)
                    for s in (ser.call_serialize(k, v) for k, v in out)
                    if s
                ]
            return out

        if op == "save_to_table":
            handles = self._run_results(spec.get("sources", []), jobs, cache)
            table = spec.get("table") or spec["table_name"]
            for addr, rid in handles:
                url = f"http://{addr}/api/v1/mapreduce/tasks/save_to_table"
                body = urlencode(
                    [("result_id", rid), ("table_name", table)]
                ).encode()
                req = urllib.request.Request(url, data=body, method="POST")
                with urllib.request.urlopen(req, timeout=600.0) as resp:
                    if resp.status not in (201, 204):
                        raise RuntimeError_(
                            f"save_to_table failed ({resp.status}): {url}"
                        )
            return []

        # map_table / reduce as a terminal op: download its table
        return self._download(self._run_task(name, jobs, cache))


def _keyranges_overlap(meta, entry, kb, kl) -> bool:
    """Does partition `entry` overlap [kb, kl)? (keyrange pruning,
    reference: tasks/map_table.cc:63-77)."""
    from eventql_tpu_torch.db.metadata import _cmp_key

    begin, end = meta.keyrange(entry.partition_id)
    if kl is not None and kl != "" and begin != "":
        if _cmp_key(meta.keyspace, begin, kl) >= 0:
            return False
    if kb is not None and kb != "" and end != "":
        if _cmp_key(meta.keyspace, end, kb) <= 0:
            return False
    return True
