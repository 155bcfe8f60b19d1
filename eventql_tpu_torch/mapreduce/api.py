"""EVQL MapReduce driver API.

Mirrors the reference's client-side job-building surface
(reference: mapreduce/prelude.js — EVQL.mapTable / reduce / join /
downloadResults / saveToTable / broadcast / log), building the same
JSON task-DAG specs the service executes
(mapreduce_task_builder.cc:100-115 op dispatch). User functions are
Python (see COMPARISON.md: the UDF language follows the host runtime;
the reference embeds SpiderMonkey).

Usage:
    evql = EVQL(service)           # or EVQL.connect(host, port)
    m = evql.map_table(table="ev", map_fn=my_map)
    r = evql.reduce(sources=[m], reduce_fn=my_reduce)
    results = evql.download_results([r])
"""

from __future__ import annotations

import inspect
import json
import sys
from typing import Callable, List, Optional, Union


def _fn_source(fn: Union[str, Callable]) -> str:
    """User functions ship as source strings (the reference serializes
    JS closures through __encode_js, prelude.js:13-37)."""
    if isinstance(fn, str):
        return fn
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError) as e:
        raise ValueError(
            "map/reduce functions must be source strings or named"
            f" functions with retrievable source: {e}"
        )
    return src


class EVQL:
    """Job builder + executor over a local MapReduceService or a remote
    server's /api/v1/mapreduce/execute endpoint."""

    def __init__(self, service=None, host: str = None, port: int = None):
        self._service = service
        self._host = host
        self._port = port
        self._seq = 0
        self._jobs = {}

    @classmethod
    def connect(cls, host: str, port: int) -> "EVQL":
        return cls(host=host, port=port)

    # -- logging (prelude.js:154-156) ------------------------------------
    @staticmethod
    def log(*args):
        print(" ".join(str(a) for a in args), file=sys.stderr)

    # -- job definition ---------------------------------------------------
    def _mk_job_id(self) -> str:
        self._seq += 1
        return f"job-{self._seq}"

    def map_table(
        self,
        table: str,
        map_fn: Union[str, Callable],
        required_columns: Optional[List[str]] = None,
        params: Optional[dict] = None,
    ) -> str:
        """One map task per table shard (prelude.js api.mapTable)."""
        jid = self._mk_job_id()
        self._jobs[jid] = {
            "id": jid,
            "op": "map_table",
            "table": table,
            "map_fn": _fn_source(map_fn),
            "required_columns": required_columns or [],
            "params": params or {},
        }
        return jid

    def reduce(
        self,
        sources: List[str],
        reduce_fn: Union[str, Callable],
        shards: int = 1,
        params: Optional[dict] = None,
    ) -> str:
        """Shuffle + reduce over source jobs (prelude.js api.reduce)."""
        if not isinstance(sources, list):
            raise ValueError("sources must be a list")
        jid = self._mk_job_id()
        self._jobs[jid] = {
            "id": jid,
            "op": "reduce",
            "sources": list(sources),
            "reduce_fn": _fn_source(reduce_fn),
            "shards": shards,
            "params": params or {},
        }
        return jid

    def join(
        self,
        sources: List[str],
        map_fn: Union[str, Callable, None] = None,
        shards: int = 1,
    ) -> str:
        """Key-join of source outputs: every value for a key merges into
        one dict, optionally post-mapped (prelude.js api.join:238-268 —
        sugar over reduce)."""
        post = ""
        if map_fn is not None:
            post = "\n".join(
                "    " + line
                for line in _fn_source(map_fn).strip().split("\n")
            )
        reduce_src = (
            "def _join_reduce(key, values):\n"
            "    import json as _json\n"
            "    joined = {}\n"
            "    for v in values:\n"
            "        joined.update(_json.loads(v))\n"
        )
        if map_fn is not None:
            reduce_src += (
                post
                + "\n"
                + f"    return {_fn_name(map_fn)}(joined)\n"
            )
        else:
            reduce_src += "    return [(key, _json.dumps(joined))]\n"
        return self.reduce(sources, reduce_src, shards=shards)

    # -- execution ---------------------------------------------------------
    def _collect(self, root: dict) -> List[dict]:
        """Dependency closure, root first (prelude.js executeJob)."""
        out = [root]
        seen = set()

        def walk(job):
            for sid in job.get("sources", []):
                if sid in seen:
                    continue
                dep = self._jobs.get(sid)
                if dep is None:
                    raise ValueError(f"invalid job id: {sid}")
                seen.add(sid)
                out.append(dep)
                walk(dep)

        walk(root)
        return out

    def _execute(self, root: dict):
        jobs = {j["id"]: j for j in self._collect(root)}
        spec = {"jobs": jobs, "execute": [root["id"]]}
        if self._service is not None:
            return self._service.execute(spec)
        import urllib.request

        req = urllib.request.Request(
            f"http://{self._host}:{self._port}/api/v1/mapreduce/execute",
            data=json.dumps(spec).encode(),
        )
        with urllib.request.urlopen(req) as resp:
            body = json.loads(resp.read())
        return [
            [(e["key"], e["value"]) for e in out]
            for out in body["results"]
        ]

    def download_results(self, sources: List[str]):
        """Run the DAG and return [(key, value)] lists per source
        (prelude.js api.downloadResults)."""
        jid = self._mk_job_id()
        job = {"id": jid, "op": "return_results", "sources": list(sources)}
        self._jobs[jid] = job
        return self._execute(job)

    def save_to_table(self, table: str, sources: List[str]):
        """Run the DAG and insert results into a table
        (prelude.js api.saveToTable)."""
        jid = self._mk_job_id()
        job = {
            "id": jid,
            "op": "save_to_table",
            "table": table,
            "sources": list(sources),
        }
        self._jobs[jid] = job
        return self._execute(job)


def _fn_name(fn: Union[str, Callable]) -> str:
    if isinstance(fn, str):
        # first "def <name>(" in the source
        for line in fn.split("\n"):
            line = line.strip()
            if line.startswith("def ") and "(" in line:
                return line[4 : line.index("(")].strip()
        raise ValueError("could not find a def in map_fn source")
    return fn.__name__
