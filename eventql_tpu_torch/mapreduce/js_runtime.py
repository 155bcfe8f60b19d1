"""JavaScript MapReduce runtime integration.

The reference runs MapReduce jobs as JavaScript on SpiderMonkey: the
job program executes in a JS context where the EVQL/Z1 driver API
builds a task DAG and `evql_executemr` hands it to the C++ scheduler;
worker tasks get a fresh context, `__load_closure` installs broadcast
globals + `params` + the shipped function, and `callMapFunction` /
`callReduceFunction` invoke it per row / per key-group
(reference: mapreduce/runtime/javascript/javascript_context.cc:100-436,
mapreduce/prelude.js).

This module provides the same machinery on the in-repo ES5
interpreter:

* `JobContext`   — program-level context exposing the EVQL/Z1 API
  (mapTable/reduce/join/downloadResults/saveToTable/broadcast/log/
  writeToOutput) with prelude-compatible task-spec output.
* `TaskContext`  — worker-side context: load_closure + map/reduce
  entry points with reference calling conventions (map: `__fn(row)`;
  reduce: `__fn(key, iter{hasNext,next})`; tuples returned as
  `[ToString(e[0]), JSON.stringify(e[1])]` —
  javascript_context.cc enumerateTuples).
* function/closure encoding: functions ship as `String(fn)` source,
  nested inside JSON via a magic-prefix marker, mirroring
  prelude.js __encode_js/__decode_js.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.mapreduce.js.interp import (
    UNDEFINED,
    FUNCTION_TYPES,
    Interpreter,
    JSArray,
    JSError,
    JSObject,
    NativeFunction,
    json_stringify,
    python_to_js,
    to_boolean,
    to_string,
)
from eventql_tpu_torch.mapreduce.js.lexer import JSSyntaxError

# function-in-JSON marker (role of prelude.js __kFnMagic; internal to
# this runtime — both ends are ours)
FN_MAGIC = "\b\bFN<evql.js.fn>\b\b"


def _nf(fn, name):
    return NativeFunction(fn, name)


# -- closure encoding --------------------------------------------------------

def encode_js(interp: Interpreter, value) -> str:
    """JSON-encode a JS value, shipping functions as magic-prefixed
    source strings (prelude.js __encode_js)."""
    if isinstance(value, FUNCTION_TYPES):
        return FN_MAGIC + repr(value)

    def replacer(it, this, args):
        v = args[1] if len(args) > 1 else UNDEFINED
        if isinstance(v, FUNCTION_TYPES):
            return FN_MAGIC + repr(v)
        if isinstance(v, (str, bool, float, JSObject, JSArray)) \
                or v is None:
            return v
        return UNDEFINED

    out = json_stringify(interp, value, _nf(replacer, "replacer"))
    return "null" if out is UNDEFINED else out


def decode_js(interp: Interpreter, text: str):
    """Inverse of encode_js: JSON-decode, reviving magic-prefixed
    function sources into function objects (prelude.js __decode_js)."""
    if text.startswith(FN_MAGIC):
        return interp.compile_function(text[len(FN_MAGIC):])
    data = json.loads(text) if text else None

    def revive(v):
        if isinstance(v, str) and v.startswith(FN_MAGIC):
            return interp.compile_function(v[len(FN_MAGIC):])
        if isinstance(v, list):
            return JSArray([revive(e) for e in v])
        if isinstance(v, dict):
            return JSObject({k: revive(e) for k, e in v.items()})
        return python_to_js(v)

    return revive(data)


def enumerate_tuples(interp: Interpreter, rval) -> List[Tuple[str, str]]:
    """Convert a map/reduce return value into string tuples with the
    reference's convention: key via ToString, value via JSON.stringify
    (javascript_context.cc enumerateTuples)."""
    if isinstance(rval, JSArray):
        elems = rval.elements
    elif isinstance(rval, JSObject):
        elems = list(rval.props.values())
    else:
        raise RuntimeError_(
            "map/reduce function must return a list/array of tuples")
    out: List[Tuple[str, str]] = []
    for elem in elems:
        if isinstance(elem, JSArray):
            k = elem.elements[0] if elem.elements else UNDEFINED
            v = elem.elements[1] if len(elem.elements) > 1 else UNDEFINED
        elif isinstance(elem, JSObject):
            k = elem.props.get("0", UNDEFINED)
            v = elem.props.get("1", UNDEFINED)
        else:
            raise RuntimeError_(
                "map/reduce function must return a list/array of tuples")
        val = json_stringify(interp, v)
        out.append((to_string(k),
                    "null" if val is UNDEFINED else val))
    return out


# -- worker-side task context -----------------------------------------------

class TaskContext:
    """Per-task JS context (the reference creates a JavaScriptContext
    per task: mapreduce_service.cc mapPartition/reduceTables)."""

    def __init__(self, fn_src: str, globals_json: str = "",
                 params_json: str = "", log_fn: Optional[Callable] = None):
        self.interp = Interpreter()
        log = log_fn or (lambda msg: print(msg, file=sys.stderr))
        install_console(self.interp, log)
        # __load_closure semantics (prelude.js:76-88)
        if globals_json:
            g = decode_js(self.interp, globals_json)
            if isinstance(g, JSObject):
                for k, v in g.props.items():
                    self.interp.global_scope.declare(k, v, force=True)
        self.interp.global_scope.declare(
            "params",
            decode_js(self.interp, params_json) if params_json
            else JSObject(),
            force=True)
        try:
            self.fn = self.interp.compile_function(fn_src)
        except JSSyntaxError as e:
            raise RuntimeError_(f"invalid JavaScript function: {e}")

    def call_map(self, row: dict) -> List[Tuple[str, str]]:
        try:
            rval = self.interp.call(self.fn, [python_to_js(row)])
        except JSError as e:
            raise RuntimeError_(f"JavaScriptError: {e}")
        return enumerate_tuples(self.interp, rval)

    def call_reduce(self, key: str, values) -> List[Tuple[str, str]]:
        it = iter(values)
        state = {"peeked": None, "has": None}

        def has_next(i2, this, a):
            if state["has"] is None:
                try:
                    state["peeked"] = next(it)
                    state["has"] = True
                except StopIteration:
                    state["has"] = False
            return state["has"]

        def get_next(i2, this, a):
            if not has_next(i2, this, a):
                raise RuntimeError_("reduce iterator exhausted")
            state["has"] = None
            return python_to_js(state["peeked"])

        iter_obj = JSObject({
            "hasNext": _nf(has_next, "hasNext"),
            "next": _nf(get_next, "next"),
        })
        try:
            rval = self.interp.call(self.fn, [key, iter_obj])
        except JSError as e:
            raise RuntimeError_(
                f"JavaScriptError: {e} for input {key!r}")
        return enumerate_tuples(self.interp, rval)

    def call_serialize(self, key: str, value: str) -> str:
        try:
            rval = self.interp.call(self.fn, [key, value])
        except JSError as e:
            raise RuntimeError_(f"JavaScriptError: {e}")
        return to_string(rval)


def install_console(interp: Interpreter, log_fn: Callable[[str], None]):
    def _log(it, this, args):
        log_fn(", ".join(to_string(a) for a in args))
        return UNDEFINED

    console = JSObject({"log": _nf(_log, "log"),
                        "error": _nf(_log, "error")})
    interp.global_scope.declare("console", console, force=True)
    interp.global_scope.declare("evql_log", _nf(_log, "evql_log"),
                                force=True)


# -- program-side job context -------------------------------------------------

class JobContext:
    """Runs a MapReduce job program: a JS script that uses the EVQL/Z1
    driver API to declare tasks and trigger execution. The API surface
    and task-spec field names match prelude.js so reference job scripts
    run unmodified."""

    def __init__(
        self,
        execute_tasks: Callable[[List[dict], str], None],
        write_output: Callable[[str], None],
        log_fn: Optional[Callable[[str], None]] = None,
    ):
        self.interp = Interpreter()
        self._execute_tasks = execute_tasks
        self._write_output = write_output
        self._log = log_fn or (lambda msg: print(msg, file=sys.stderr))
        self._seq = 0
        self._jobs: Dict[str, dict] = {}
        self._bcast: Dict[str, object] = {}
        install_console(self.interp, self._log)
        self._install_api()

    def run(self, program: str):
        try:
            return self.interp.run(program)
        except JSSyntaxError as e:
            raise RuntimeError_(f"JavaScript syntax error: {e}")
        except JSError as e:
            raise RuntimeError_(f"JavaScriptError: {e}")

    # -- helpers ------------------------------------------------------
    def _mk_job_id(self) -> str:
        self._seq += 1
        return f"job-{self._seq}"

    def _auto_broadcast(self):
        # prelude.js autoBroadcast: every non-dunder global function
        for k, v in list(self.interp.global_scope.vars.items()):
            if k.startswith("__"):
                continue
            if isinstance(v, FUNCTION_TYPES) \
                    and not isinstance(v, NativeFunction):
                self._bcast[k] = v

    def _encode_bcast(self) -> str:
        return encode_js(self.interp, JSObject(dict(self._bcast)))

    def _execute_job(self, root_job: dict):
        # dependency closure, root first (prelude.js executeJob)
        deps = [root_job]
        seen = set()

        def find_deps(job):
            for djid in job.get("sources") or []:
                if djid in seen:
                    continue
                djob = self._jobs.get(djid)
                if djob is None:
                    raise JSError(f"invalid job id: {djid}")
                seen.add(djid)
                deps.append(djob)
                find_deps(djob)

        find_deps(root_job)
        self._execute_tasks(deps, root_job["id"])

    # -- the EVQL/Z1 api ------------------------------------------------
    def _install_api(self):
        api = JSObject()

        def api_log(it, this, args):
            self._log(", ".join(to_string(a) for a in args))
            return UNDEFINED

        api.props["log"] = _nf(api_log, "log")

        def api_broadcast(it, this, args):
            for a in args:
                if not isinstance(a, str):
                    raise JSError(
                        "arguments to EVQL.broadcast must be strings")
                if a == "params":
                    raise JSError("'params' is a reserved variable and "
                                  "cannot be broadcasted")
                if a not in self.interp.global_scope.vars:
                    raise JSError(
                        "no such variable in the global namespace: "
                        f"'{a}' -- all broadcast variables must be global")
                self._bcast[a] = self.interp.global_scope.vars[a]
            return UNDEFINED

        api.props["broadcast"] = _nf(api_broadcast, "broadcast")

        def opt(opts, *names):
            for n in names:
                v = opts.props.get(n, UNDEFINED)
                if v is not UNDEFINED and v is not None:
                    return v
            return UNDEFINED

        def api_map_table(it, this, args):
            opts = args[0] if args and isinstance(args[0], JSObject) \
                else JSObject()
            table = opt(opts, "table")
            if not to_boolean(table):
                raise JSError("missing parameter: table")
            self._auto_broadcast()
            jid = self._mk_job_id()
            begin = opt(opts, "begin", "from")
            limit = opt(opts, "end", "until")
            map_fn = opt(opts, "map_fn")
            req_cols = opt(opts, "required_columns")
            self._jobs[jid] = {
                "id": jid,
                "op": "map_table",
                "table_name": to_string(table),
                "keyrange_begin": to_string(begin)
                if to_boolean(begin) else None,
                "keyrange_limit": to_string(limit)
                if to_boolean(limit) else None,
                "map_fn": repr(map_fn)
                if isinstance(map_fn, FUNCTION_TYPES)
                else to_string(map_fn),
                "globals": self._encode_bcast(),
                "params": encode_js(
                    self.interp,
                    opt(opts, "params") if to_boolean(opt(opts, "params"))
                    else JSObject()),
                "required_columns": [
                    to_string(c) for c in req_cols.elements
                ] if isinstance(req_cols, JSArray) else [],
            }
            return jid

        api.props["mapTable"] = _nf(api_map_table, "mapTable")

        def api_reduce(it, this, args):
            opts = args[0] if args and isinstance(args[0], JSObject) \
                else JSObject()
            sources = opt(opts, "sources")
            if sources is UNDEFINED:
                raise JSError("missing parameter: sources")
            if not isinstance(sources, JSArray):
                raise JSError("sources must be an array")
            reduce_fn = opt(opts, "reduce_fn")
            if reduce_fn is UNDEFINED:
                raise JSError("missing parameter: reduce_fn")
            shards = opt(opts, "shards")
            if shards is UNDEFINED:
                raise JSError("missing parameter: shards")
            self._auto_broadcast()
            jid = self._mk_job_id()
            self._jobs[jid] = {
                "id": jid,
                "op": "reduce",
                "sources": [to_string(s) for s in sources.elements],
                "num_shards": int(float(to_string(shards))
                                  if isinstance(shards, str) else shards),
                "reduce_fn": repr(reduce_fn)
                if isinstance(reduce_fn, FUNCTION_TYPES)
                else to_string(reduce_fn),
                "globals": self._encode_bcast(),
                "params": encode_js(
                    self.interp,
                    opt(opts, "params") if to_boolean(opt(opts, "params"))
                    else JSObject()),
            }
            return jid

        api.props["reduce"] = _nf(api_reduce, "reduce")

        # join = reduce sugar merging JSON values per key, optionally
        # post-mapped via params.map_fn (prelude.js api.join)
        join_reduce_src = (
            "function(key, values) {\n"
            "  var joined = {};\n"
            "  while (values.hasNext()) {\n"
            "    var val = JSON.parse(values.next());\n"
            "    for (var k in val) { joined[k] = val[k]; }\n"
            "  }\n"
            "  if (params.map_fn) { return params.map_fn(joined); }\n"
            "  return [[key, joined]];\n"
            "}")

        def api_join(it, this, args):
            opts = args[0] if args and isinstance(args[0], JSObject) \
                else JSObject()
            params = opt(opts, "params")
            if not isinstance(params, JSObject):
                params = JSObject()
                opts.props["params"] = params
            map_fn = opt(opts, "map_fn")
            if map_fn is not UNDEFINED:
                params.props["map_fn"] = map_fn
            ropts = JSObject({
                "sources": opt(opts, "sources"),
                "shards": opt(opts, "shards"),
                "params": params,
                "reduce_fn": join_reduce_src,
            })
            return api_reduce(it, this, [ropts])

        api.props["join"] = _nf(api_join, "join")

        def api_download_results(it, this, args):
            sources = args[0] if args else UNDEFINED
            if not isinstance(sources, JSArray):
                raise JSError("sources must be an array")
            serialize_fn = args[1] if len(args) > 1 else UNDEFINED
            self._execute_job({
                "id": self._mk_job_id(),
                "op": "return_results",
                "sources": [to_string(s) for s in sources.elements],
                "serialize_fn": repr(serialize_fn)
                if isinstance(serialize_fn, FUNCTION_TYPES)
                else (to_string(serialize_fn)
                      if serialize_fn is not UNDEFINED else ""),
                "globals": self._encode_bcast(),
                "params": "{}",
            })
            return UNDEFINED

        api.props["downloadResults"] = _nf(
            api_download_results, "downloadResults")

        def api_save_to_table(it, this, args):
            opts = args[0] if args and isinstance(args[0], JSObject) \
                else JSObject()
            table = opt(opts, "table")
            if not to_boolean(table):
                raise JSError("missing parameter: table")
            sources = opt(opts, "sources")
            if sources is UNDEFINED:
                raise JSError("missing parameter: sources")
            if not isinstance(sources, JSArray):
                raise JSError("sources must be an array")
            self._execute_job({
                "id": self._mk_job_id(),
                "op": "save_to_table",
                "table_name": to_string(table),
                "sources": [to_string(s) for s in sources.elements],
            })
            return UNDEFINED

        api.props["saveToTable"] = _nf(api_save_to_table, "saveToTable")

        def api_write_to_output(it, this, args):
            if not args or not isinstance(args[0], str):
                raise JSError(
                    "argument to EVQL.writeToOutput must be a string")
            self._write_output(args[0])
            return UNDEFINED

        api.props["writeToOutput"] = _nf(
            api_write_to_output, "writeToOutput")

        self.interp.global_scope.declare("EVQL", api, force=True)
        self.interp.global_scope.declare("Z1", api, force=True)  # bc compat


# -- task-spec adaptation ----------------------------------------------------

def normalize_task_spec(task: dict) -> dict:
    """Map a prelude-shaped task dict onto the service's job-spec field
    names (service accepts both: table/table_name, shards/num_shards)."""
    out = dict(task)
    if "table_name" in out and "table" not in out:
        out["table"] = out["table_name"]
    if "num_shards" not in out and "shards" in out:
        out["num_shards"] = out["shards"]
    out["lang"] = "js"
    return out


_TLS = threading.local()


def js_map_adapter(fn_src: str, globals_json: str, params_json: str,
                   log_fn=None):
    """Build a per-thread map callable: dict row -> [(k, v)]. A fresh
    TaskContext per worker thread mirrors the reference's
    context-per-task model (and keeps the interpreter single-threaded)."""
    def call(row: dict):
        ctx = getattr(_TLS, "map_ctx", None)
        if ctx is None or ctx[0] != id(call):
            ctx = (id(call),
                   TaskContext(fn_src, globals_json, params_json, log_fn))
            _TLS.map_ctx = ctx
        return ctx[1].call_map(row)

    return call


def js_reduce_adapter(fn_src: str, globals_json: str, params_json: str,
                      log_fn=None):
    def call(key: str, values):
        ctx = getattr(_TLS, "reduce_ctx", None)
        if ctx is None or ctx[0] != id(call):
            ctx = (id(call),
                   TaskContext(fn_src, globals_json, params_json, log_fn))
            _TLS.reduce_ctx = ctx
        return ctx[1].call_reduce(key, values)

    return call
