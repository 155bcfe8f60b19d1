"""ES5-subset JavaScript interpreter.

Tree-walking evaluator over the tuple AST from parser.py. Covers the
language surface MapReduce jobs use (reference executes them on
SpiderMonkey: mapreduce/runtime/javascript/javascript_context.cc):
closures, objects/arrays, the full ES5 operator set with JS coercion
semantics, control flow incl. try/catch/switch, and the JSON / Math /
String / Array / Object / RegExp / Date builtins.

Numbers are IEEE doubles (Python floats); strings are Python strs.
"""

from __future__ import annotations

import json as _pyjson
import math
import random
import re
import time
from typing import Dict, List, Optional

from eventql_tpu_torch.mapreduce.js.lexer import JSSyntaxError
from eventql_tpu_torch.mapreduce.js.parser import parse, parse_function_expression


class _Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = _Undefined()


class JSError(Exception):
    """A JavaScript exception carrying the thrown JS value."""

    def __init__(self, value):
        self.value = value
        super().__init__(js_error_message(value))


def js_error_message(value) -> str:
    if isinstance(value, JSObject):
        name = value.props.get("name", "Error")
        msg = value.props.get("message", "")
        return f"{to_string(name)}: {to_string(msg)}"
    return to_string(value)


def throw(msg: str, name: str = "Error"):
    err = JSObject()
    err.props["name"] = name
    err.props["message"] = msg
    raise JSError(err)


class _Break(Exception):
    def __init__(self, label=None):
        self.label = label


class _Continue(Exception):
    def __init__(self, label=None):
        self.label = label


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class JSObject:
    __slots__ = ("props", "proto", "nonenum", "frozen", "sealed")

    def __init__(self, props: Optional[Dict] = None, proto=None,
                 nonenum=None):
        self.props = dict(props or {})
        # [[Prototype]] link (ES5 8.6.2): property GETs walk the chain,
        # SETs/DELETEs touch own props only
        self.proto = proto
        # names of own NON-ENUMERABLE properties (ES5 [[Enumerable]] =
        # false): skipped by for-in but visible to gets/hasOwnProperty.
        # Assignment does not flip the attribute (8.12.5 [[Put]] on an
        # existing own property updates the value only).
        self.nonenum = set(nonenum or ())
        # Object.freeze / Object.seal state (ES5 15.2.3.8/9): frozen
        # rejects writes+deletes+adds, sealed rejects adds+deletes
        # (silent no-ops in sloppy mode)
        self.frozen = False
        self.sealed = False


class JSAccessor:
    """ES5 accessor property ([[Get]]/[[Set]] pair, 8.6.1): stored as
    the property VALUE in props; get_member/set_member dispatch through
    it with the RECEIVER as `this` (SpiderMonkey semantics the
    reference's JS jobs see, javascript_context.cc)."""

    __slots__ = ("get", "set")

    def __init__(self, get=None, set=None):
        self.get = get
        self.set = set

    def __repr__(self):
        return js_repr(self)


class JSArray:
    __slots__ = ("elements", "frozen")

    def __init__(self, elements: Optional[List] = None):
        self.elements = list(elements or [])
        # Object.freeze applies to arrays too (ES5 15.2.3.9: elements
        # become non-writable, length non-configurable)
        self.frozen = False

    def __repr__(self):
        return js_repr(self)


class JSFunction:
    __slots__ = ("name", "params", "body", "scope", "src", "props",
                 "interp")

    def __init__(self, name, params, body, scope, src, interp):
        self.name = name
        self.params = params
        self.body = body
        self.scope = scope
        self.src = src
        self.props = {}
        self.interp = interp

    def __repr__(self):
        return self.src or f"function {self.name or ''}() {{ ... }}"


class NativeFunction:
    __slots__ = ("fn", "name", "props", "construct")

    def __init__(self, fn, name="native", construct=None):
        self.fn = fn
        self.name = name
        self.props = {}
        self.construct = construct

    def __repr__(self):
        return f"function {self.name}() {{ [native code] }}"


FUNCTION_TYPES = (JSFunction, NativeFunction)


class JSRegExp:
    __slots__ = ("source", "flags", "regex", "last_index", "props")

    def __init__(self, source: str, flags: str = ""):
        self.source = source
        self.flags = flags
        self.last_index = 0
        self.props = {}
        pyflags = 0
        if "i" in flags:
            pyflags |= re.IGNORECASE
        if "m" in flags:
            pyflags |= re.MULTILINE
        if "s" in flags:
            pyflags |= re.DOTALL
        try:
            self.regex = re.compile(_js_regex_to_python(source), pyflags)
        except re.error as e:
            throw(f"invalid regular expression: {e}", "SyntaxError")

    def __repr__(self):
        return f"/{self.source}/{self.flags}"


def _js_regex_to_python(src: str) -> str:
    """Translate the common JS regex constructs Python lacks/differs on."""
    out = []
    i, n = 0, len(src)
    in_class = False
    while i < n:
        c = src[i]
        if c == "\\" and i + 1 < n:
            nxt = src[i + 1]
            if nxt == "d" or nxt == "D" or nxt == "w" or nxt == "W" \
                    or nxt == "s" or nxt == "S" or nxt == "b" or nxt == "B":
                out.append(c + nxt)
            elif nxt == "/":
                out.append("/")
            else:
                out.append(c + nxt)
            i += 2
            continue
        if c == "[":
            in_class = True
        elif c == "]":
            in_class = False
        elif c == "$" and not in_class and i == n - 1:
            out.append(r"\Z")
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict = {}
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        throw(f"{name} is not defined", "ReferenceError")

    def has(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s.vars:
                return True
            s = s.parent
        return False

    def assign(self, name: str, value):
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            if s.parent is None:
                # sloppy-mode implicit global
                s.vars[name] = value
                return
            s = s.parent

    def declare(self, name: str, value=UNDEFINED, force=False):
        if force or name not in self.vars:
            self.vars[name] = value

    def delete(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s.vars:
                del s.vars[name]
                return True
            s = s.parent
        return True


# -- coercions -------------------------------------------------------------

def to_boolean(v) -> bool:
    if v is UNDEFINED or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return not (v == 0 or v != v)
    if isinstance(v, str):
        return len(v) > 0
    return True


def to_number(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if v is UNDEFINED:
        return float("nan")
    if v is None:
        return 0.0
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            if s.lower().startswith(("0x", "-0x", "+0x")):
                neg = s[0] == "-"
                h = s.lstrip("+-")
                return -float(int(h, 16)) if neg else float(int(h, 16))
            if s in ("Infinity", "+Infinity"):
                return float("inf")
            if s == "-Infinity":
                return float("-inf")
            return float(s)
        except ValueError:
            return float("nan")
    if isinstance(v, (JSObject, JSArray, JSRegExp)) \
            or isinstance(v, FUNCTION_TYPES):
        return to_number(to_primitive(v, "number"))
    return float("nan")



def to_integer(v) -> int:
    """JS ToInteger (ES5 9.4): NaN -> 0, +-Infinity clamps (callers
    range-check anyway), truncation toward zero — int(to_number(x))
    alone raises Python ValueError/OverflowError on NaN/Infinity."""
    n = to_number(v)
    if n != n:
        return 0
    if n == float("inf"):
        return 2**53
    if n == float("-inf"):
        return -(2**53)
    return int(n)

def to_primitive(v, hint: str = "default"):
    if isinstance(v, JSArray):
        return to_string(v)
    if isinstance(v, JSRegExp):
        return repr(v)
    if isinstance(v, FUNCTION_TYPES):
        return repr(v)
    if isinstance(v, JSObject):
        if hint == "number":
            return float("nan")  # valueOf not modeled; [object Object]→NaN
        return "[object Object]"
    return v


def js_num_str(n: float) -> str:
    if n != n:
        return "NaN"
    if n == float("inf"):
        return "Infinity"
    if n == float("-inf"):
        return "-Infinity"
    if n == int(n) and abs(n) < 1e21:
        i = int(n)
        if i == 0 and math.copysign(1.0, n) < 0:
            return "0"
        return str(i)
    return repr(n)


def to_string(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return js_num_str(v)
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return ",".join(
            "" if e is UNDEFINED or e is None else to_string(e)
            for e in v.elements
        )
    if isinstance(v, FUNCTION_TYPES):
        return repr(v)
    if isinstance(v, JSRegExp):
        return repr(v)
    if isinstance(v, JSObject):
        return "[object Object]"
    return str(v)


def to_int32(v) -> int:
    n = to_number(v)
    if n != n or n in (float("inf"), float("-inf")):
        return 0
    i = int(n) & 0xFFFFFFFF
    return i - (1 << 32) if i >= (1 << 31) else i


def to_uint32(v) -> int:
    n = to_number(v)
    if n != n or n in (float("inf"), float("-inf")):
        return 0
    return int(n) & 0xFFFFFFFF


def type_of(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, FUNCTION_TYPES):
        return "function"
    return "object"


def strict_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, float) and isinstance(b, float):
        return a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if a is UNDEFINED or b is UNDEFINED or a is None or b is None:
        return a is b
    return a is b


def loose_eq(a, b) -> bool:
    ta, tb = type_of(a), type_of(b)
    if a is None and b is UNDEFINED or a is UNDEFINED and b is None:
        return True
    if ta == tb or (ta in ("undefined",) and tb in ("undefined",)):
        return strict_eq(a, b)
    if a is None or b is None or a is UNDEFINED or b is UNDEFINED:
        return False
    if ta == "number" and tb == "string":
        return a == to_number(b)
    if ta == "string" and tb == "number":
        return to_number(a) == b
    if ta == "boolean":
        return loose_eq(to_number(a), b)
    if tb == "boolean":
        return loose_eq(a, to_number(b))
    if ta in ("number", "string") and tb in ("object", "function"):
        return loose_eq(a, to_primitive(b))
    if ta in ("object", "function") and tb in ("number", "string"):
        return loose_eq(to_primitive(a), b)
    return False


def js_repr(v, seen=None) -> str:
    """console.log-style rendering (used for debugging and String())."""
    if seen is None:
        seen = set()
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        if id(v) in seen:
            return "[Circular]"
        seen = seen | {id(v)}
        return "[" + ", ".join(_inner_repr(e, seen) for e in v.elements) + "]"
    if isinstance(v, JSObject):
        if id(v) in seen:
            return "[Circular]"
        seen = seen | {id(v)}
        parts = [
            f"{k}: {_inner_repr(val, seen)}" for k, val in v.props.items()
        ]
        return "{ " + ", ".join(parts) + " }" if parts else "{}"
    return to_string(v)


def _inner_repr(v, seen) -> str:
    if isinstance(v, str):
        return _pyjson.dumps(v)
    return js_repr(v, seen)


# -- python <-> js value bridges -------------------------------------------

def python_to_js(v):
    if v is None or isinstance(v, _Undefined):
        return v
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, (list, tuple)):
        return JSArray([python_to_js(e) for e in v])
    if isinstance(v, dict):
        return JSObject({str(k): python_to_js(val) for k, val in v.items()})
    if isinstance(v, (JSObject, JSArray, JSRegExp)) \
            or isinstance(v, FUNCTION_TYPES):
        return v
    if callable(v):
        return NativeFunction(
            lambda interp, this, args: python_to_js(
                v(*[js_to_python(a) for a in args])),
            getattr(v, "__name__", "native"))
    raise TypeError(f"cannot convert {type(v).__name__} to a JS value")


def js_to_python(v):
    if v is UNDEFINED:
        return None
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, float):
        if math.isfinite(v) and v == int(v) and abs(v) < 2**53:
            return int(v)
        return v
    if isinstance(v, JSArray):
        return [js_to_python(e) for e in v.elements]
    if isinstance(v, JSObject):
        return {k: js_to_python(val) for k, val in v.props.items()}
    if isinstance(v, FUNCTION_TYPES):
        return repr(v)
    return str(v)


# -- hoisting ---------------------------------------------------------------

def _hoist(stmts, scope: Scope, interp: "Interpreter"):
    """Pre-declare `var` names and bind function declarations, per ES5
    hoisting. Does not descend into nested functions."""
    for s in stmts:
        _hoist_stmt(s, scope, interp)


def _hoist_stmt(s, scope, interp):
    if s is None:
        return
    tag = s[0]
    if tag == "var":
        for name, _ in s[1]:
            scope.declare(name)
    elif tag == "fndecl":
        _, name, params, body, src = s
        scope.declare(
            name, JSFunction(name, params, body, scope, src, interp),
            force=True)
    elif tag == "block":
        _hoist(s[1], scope, interp)
    elif tag == "if":
        _hoist_stmt(s[2], scope, interp)
        _hoist_stmt(s[3], scope, interp)
    elif tag == "for":
        if s[1] is not None:
            _hoist_stmt(s[1], scope, interp)
        _hoist_stmt(s[4], scope, interp)
    elif tag == "forin":
        if s[1][0] == "var":
            scope.declare(s[1][1])
        _hoist_stmt(s[3], scope, interp)
    elif tag in ("while",):
        _hoist_stmt(s[2], scope, interp)
    elif tag == "label":
        _hoist_stmt(s[2], scope, interp)
    elif tag == "dowhile":
        _hoist_stmt(s[1], scope, interp)
    elif tag == "try":
        _hoist_stmt(s[1], scope, interp)
        if s[3] is not None:
            _hoist_stmt(s[3], scope, interp)
        if s[4] is not None:
            _hoist_stmt(s[4], scope, interp)
    elif tag == "switch":
        for _, case_stmts in s[2]:
            _hoist(case_stmts, scope, interp)


# -- the interpreter ---------------------------------------------------------

MAX_CALL_DEPTH = 500


class Interpreter:
    def __init__(self, bindings: Optional[Dict] = None):
        self.global_scope = Scope()
        self._depth = 0
        install_builtins(self)
        for k, v in (bindings or {}).items():
            self.global_scope.declare(k, python_to_js(v), force=True)

    # -- public API ----------------------------------------------------
    def run(self, src: str):
        """Execute a program in the global scope; returns the completion
        value (the value of the last expression statement)."""
        prog = parse(src)
        _hoist(prog, self.global_scope, self)
        result = UNDEFINED
        for stmt in prog:
            r = self.exec_stmt(stmt, self.global_scope)
            if r is not _NO_VALUE:
                result = r
        return result

    def get_global(self, name: str):
        return self.global_scope.vars.get(name, UNDEFINED)

    def set_global(self, name: str, value):
        self.global_scope.declare(name, python_to_js(value), force=True)

    def compile_function(self, src: str) -> JSFunction:
        """Compile a standalone `function (..) {..}` source string (the
        closure wire format) into a callable function object."""
        node = parse_function_expression(src.strip())
        _, name, params, body, text = node
        return JSFunction(name, params, body, self.global_scope, text, self)

    def call(self, fn, args, this=UNDEFINED):
        if isinstance(fn, NativeFunction):
            return fn.fn(self, this, list(args))
        if not isinstance(fn, JSFunction):
            throw(f"{to_string(fn)} is not a function", "TypeError")
        self._depth += 1
        if self._depth > MAX_CALL_DEPTH:
            self._depth -= 1
            throw("Maximum call stack size exceeded", "RangeError")
        try:
            scope = Scope(fn.scope)
            for i, p in enumerate(fn.params):
                scope.declare(
                    p, args[i] if i < len(args) else UNDEFINED, force=True)
            scope.declare("arguments", JSArray(list(args)), force=True)
            scope.declare("this", this, force=True)
            _hoist(fn.body, scope, self)
            try:
                for stmt in fn.body:
                    self.exec_stmt(stmt, scope)
            except _Return as r:
                return r.value
            return UNDEFINED
        finally:
            self._depth -= 1

    def construct(self, fn, args):
        if isinstance(fn, NativeFunction):
            if fn.construct is not None:
                return fn.construct(self, list(args))
            return fn.fn(self, UNDEFINED, list(args))
        proto = self.get_member(fn, "prototype") \
            if isinstance(fn, JSFunction) else None
        obj = JSObject(
            proto=proto if isinstance(proto, JSObject) else None)
        result = self.call(fn, args, this=obj)
        return result if isinstance(result, (JSObject, JSArray)) else obj

    # -- statements -------------------------------------------------------
    def exec_stmt(self, s, scope, labels=()):
        # `labels`: the label set naming the IMMEDIATE statement (a
        # labeled loop consumes matching labeled break/continue).
        # Value-producing statements return their ES5 completion value
        # (blocks/if/try/switch propagate the last one) so program
        # results match a real engine's evaluate().
        tag = s[0]
        if tag == "expr":
            return self.eval_expr(s[1], scope)
        if tag == "var":
            for name, init in s[1]:
                if init is not None:
                    scope.assign(name, self.eval_expr(init, scope))
            return _NO_VALUE
        if tag == "block":
            out = _NO_VALUE
            for st in s[1]:
                r = self.exec_stmt(st, scope)
                if r is not _NO_VALUE:
                    out = r
            return out
        if tag == "if":
            if to_boolean(self.eval_expr(s[1], scope)):
                return self.exec_stmt(s[2], scope)
            elif s[3] is not None:
                return self.exec_stmt(s[3], scope)
            return _NO_VALUE
        if tag == "label":
            _, name, body = s
            try:
                return self.exec_stmt(body, scope, labels=labels + (name,))
            except _Break as b:
                if b.label == name:
                    return _NO_VALUE
                raise
        if tag == "while":
            while to_boolean(self.eval_expr(s[1], scope)):
                try:
                    self.exec_stmt(s[2], scope)
                except _Break as b:
                    if b.label is None or b.label in labels:
                        break
                    raise
                except _Continue as c:
                    if c.label is None or c.label in labels:
                        continue
                    raise
            return _NO_VALUE
        if tag == "dowhile":
            while True:
                try:
                    self.exec_stmt(s[1], scope)
                except _Break as b:
                    if b.label is None or b.label in labels:
                        break
                    raise
                except _Continue as c:
                    if not (c.label is None or c.label in labels):
                        raise
                if not to_boolean(self.eval_expr(s[2], scope)):
                    break
            return _NO_VALUE
        if tag == "for":
            _, init, test, update, body = s
            if init is not None:
                self.exec_stmt(init, scope)
            while test is None or to_boolean(self.eval_expr(test, scope)):
                try:
                    self.exec_stmt(body, scope)
                except _Break as b:
                    if b.label is None or b.label in labels:
                        break
                    raise
                except _Continue as c:
                    if not (c.label is None or c.label in labels):
                        raise
                if update is not None:
                    self.eval_expr(update, scope)
            return _NO_VALUE
        if tag == "forin":
            _, target, obj_expr, body = s
            obj = self.eval_expr(obj_expr, scope)
            for key in self._enum_keys(obj):
                if target[0] == "var":
                    scope.assign(target[1], key)
                else:
                    self._assign_target(target[1], key, scope)
                try:
                    self.exec_stmt(body, scope)
                except _Break as b:
                    if b.label is None or b.label in labels:
                        break
                    raise
                except _Continue as c:
                    if c.label is None or c.label in labels:
                        continue
                    raise
            return _NO_VALUE
        if tag == "return":
            raise _Return(
                UNDEFINED if s[1] is None else self.eval_expr(s[1], scope))
        if tag == "break":
            raise _Break(s[1] if len(s) > 1 else None)
        if tag == "continue":
            raise _Continue(s[1] if len(s) > 1 else None)
        if tag == "throw":
            raise JSError(self.eval_expr(s[1], scope))
        if tag == "try":
            _, block, cparam, cblock, fblock = s
            out = _NO_VALUE
            try:
                try:
                    out = self.exec_stmt(block, scope)
                except JSError as e:
                    if cblock is None:
                        raise
                    cscope = Scope(scope)
                    cscope.declare(cparam, e.value, force=True)
                    out = self.exec_stmt(cblock, cscope)
            finally:
                if fblock is not None:
                    self.exec_stmt(fblock, scope)
            return out
        if tag == "switch":
            _, disc_e, cases = s
            disc = self.eval_expr(disc_e, scope)
            start = None
            for i, (test, _) in enumerate(cases):
                if test is not None and strict_eq(
                        disc, self.eval_expr(test, scope)):
                    start = i
                    break
            if start is None:
                for i, (test, _) in enumerate(cases):
                    if test is None:
                        start = i
                        break
            out = _NO_VALUE
            if start is not None:
                try:
                    for _, stmts in cases[start:]:
                        for st in stmts:
                            r = self.exec_stmt(st, scope)
                            if r is not _NO_VALUE:
                                out = r
                except _Break as b:
                    if not (b.label is None or b.label in labels):
                        raise
            return out
        if tag == "fndecl":
            return _NO_VALUE  # bound during hoisting
        if tag == "empty":
            return _NO_VALUE
        raise JSSyntaxError(f"unknown statement node {tag!r}")

    def _enum_keys(self, obj):
        if isinstance(obj, JSArray):
            return [js_num_str(float(i)) for i in range(len(obj.elements))]
        if isinstance(obj, JSObject):
            seen = []
            shadowed = set()
            o = obj
            while o is not None:
                for k in o.props:
                    if k in shadowed:
                        continue
                    shadowed.add(k)
                    if k not in o.nonenum:
                        seen.append(k)
                o = o.proto
            return seen
        if isinstance(obj, FUNCTION_TYPES):
            return list(obj.props.keys())
        if isinstance(obj, str):
            return [js_num_str(float(i)) for i in range(len(obj))]
        return []

    # -- expressions --------------------------------------------------
    def eval_expr(self, e, scope):
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "str":
            return e[1]
        if tag == "bool":
            return e[1]
        if tag == "null":
            return None
        if tag == "undef":
            return UNDEFINED
        if tag == "ident":
            return scope.lookup(e[1])
        if tag == "this":
            return scope.lookup("this") if scope.has("this") else UNDEFINED
        if tag == "func":
            _, name, params, body, src = e
            fscope = scope
            fn = JSFunction(name, params, body, fscope, src, self)
            if name:
                # named function expressions see themselves
                fscope = Scope(scope)
                fscope.declare(name, fn, force=True)
                fn.scope = fscope
            return fn
        if tag == "array":
            return JSArray([self.eval_expr(el, scope) for el in e[1]])
        if tag == "object":
            o = JSObject()
            for entry in e[1]:
                k, v = entry[0], entry[1]
                kind = entry[2] if len(entry) > 2 else "init"
                if kind == "init":
                    o.props[k] = self.eval_expr(v, scope)
                else:
                    fn = self.eval_expr(v, scope)
                    cur = o.props.get(k)
                    acc = cur if isinstance(cur, JSAccessor) \
                        else JSAccessor()
                    if kind == "get":
                        acc.get = fn
                    else:
                        acc.set = fn
                    o.props[k] = acc
            return o
        if tag == "regex":
            return JSRegExp(e[1], e[2])
        if tag == "seq":
            v = UNDEFINED
            for sub in e[1]:
                v = self.eval_expr(sub, scope)
            return v
        if tag == "member":
            return self.get_member(self.eval_expr(e[1], scope), e[2])
        if tag == "index":
            obj = self.eval_expr(e[1], scope)
            key = self.eval_expr(e[2], scope)
            return self.get_member(obj, self._prop_key(key))
        if tag == "call":
            return self._eval_call(e, scope)
        if tag == "new":
            fn = self.eval_expr(e[1], scope)
            args = [self.eval_expr(a, scope) for a in e[2]]
            return self.construct(fn, args)
        if tag == "assign":
            return self._eval_assign(e, scope)
        if tag == "update":
            return self._eval_update(e, scope)
        if tag == "cond":
            if to_boolean(self.eval_expr(e[1], scope)):
                return self.eval_expr(e[2], scope)
            return self.eval_expr(e[3], scope)
        if tag == "logic":
            left = self.eval_expr(e[2], scope)
            if e[1] == "&&":
                return self.eval_expr(e[3], scope) \
                    if to_boolean(left) else left
            return left if to_boolean(left) else self.eval_expr(e[3], scope)
        if tag == "bin":
            return self._eval_binop(
                e[1], self.eval_expr(e[2], scope),
                self.eval_expr(e[3], scope))
        if tag == "un":
            return self._eval_unop(e[1], e[2], scope)
        raise JSSyntaxError(f"unknown expression node {tag!r}")

    @staticmethod
    def _prop_key(key) -> str:
        if isinstance(key, float):
            return js_num_str(key)
        return to_string(key)

    def _eval_call(self, e, scope):
        _, callee, arg_exprs = e
        args = [self.eval_expr(a, scope) for a in arg_exprs]
        if callee[0] == "member":
            obj = self.eval_expr(callee[1], scope)
            fn = self.get_member(obj, callee[2])
            return self.call(fn, args, this=obj)
        if callee[0] == "index":
            obj = self.eval_expr(callee[1], scope)
            key = self._prop_key(self.eval_expr(callee[2], scope))
            fn = self.get_member(obj, key)
            return self.call(fn, args, this=obj)
        fn = self.eval_expr(callee, scope)
        return self.call(fn, args)

    def _resolve_target(self, target, scope):
        """Evaluate a member/index target's object and key ONCE (JS
        evaluates the reference a single time: 'f().n++' must not call
        f twice); returns a (get, set) pair of closures."""
        if target[0] == "ident":
            name = target[1]
            return (
                lambda: self.eval_expr(target, scope),
                lambda v: scope.assign(name, v),
            )
        if target[0] == "member":
            obj = self.eval_expr(target[1], scope)
            name = target[2]
            return (
                lambda: self.get_member(obj, name),
                lambda v: self.set_member(obj, name, v),
            )
        if target[0] == "index":
            obj = self.eval_expr(target[1], scope)
            key = self._prop_key(self.eval_expr(target[2], scope))
            return (
                lambda: self.get_member(obj, key),
                lambda v: self.set_member(obj, key, v),
            )
        throw("invalid assignment target", "SyntaxError")

    def _eval_assign(self, e, scope):
        _, op, target, value_expr = e
        get, setv = self._resolve_target(target, scope)
        if op == "=":
            value = self.eval_expr(value_expr, scope)
        else:
            value = self._eval_binop(
                op[:-1], get(), self.eval_expr(value_expr, scope))
        setv(value)
        return value

    def _assign_target(self, target, value, scope):
        _get, setv = self._resolve_target(target, scope)
        setv(value)

    def _eval_update(self, e, scope):
        _, op, target, prefix = e
        get, setv = self._resolve_target(target, scope)
        old = to_number(get())
        new = old + 1.0 if op == "++" else old - 1.0
        setv(new)
        return new if prefix else old

    def _eval_binop(self, op, left, right):
        if op == "+":
            lp, rp = to_primitive(left), to_primitive(right)
            if isinstance(lp, str) or isinstance(rp, str):
                return to_string(lp) + to_string(rp)
            return to_number(lp) + to_number(rp)
        if op == "-":
            return to_number(left) - to_number(right)
        if op == "*":
            return to_number(left) * to_number(right)
        if op == "/":
            ln, rn = to_number(left), to_number(right)
            if rn == 0:
                if ln != ln or ln == 0:
                    return float("nan")
                sign = math.copysign(1.0, ln) * math.copysign(1.0, rn)
                return float("inf") * sign
            return ln / rn
        if op == "%":
            ln, rn = to_number(left), to_number(right)
            if rn == 0 or ln != ln or rn != rn \
                    or ln in (float("inf"), float("-inf")):
                return float("nan")
            if rn in (float("inf"), float("-inf")):
                return ln
            return math.fmod(ln, rn)
        if op == "==":
            return loose_eq(left, right)
        if op == "!=":
            return not loose_eq(left, right)
        if op == "===":
            return strict_eq(left, right)
        if op == "!==":
            return not strict_eq(left, right)
        if op in ("<", ">", "<=", ">="):
            lp = to_primitive(left, "number")
            rp = to_primitive(right, "number")
            if isinstance(lp, str) and isinstance(rp, str):
                ln, rn = lp, rp
            else:
                ln, rn = to_number(lp), to_number(rp)
                if ln != ln or rn != rn:
                    return False
            if op == "<":
                return ln < rn
            if op == ">":
                return ln > rn
            if op == "<=":
                return ln <= rn
            return ln >= rn
        if op == "&":
            return float(_wrap_i32(to_int32(left) & to_int32(right)))
        if op == "|":
            return float(_wrap_i32(to_int32(left) | to_int32(right)))
        if op == "^":
            return float(_wrap_i32(to_int32(left) ^ to_int32(right)))
        if op == "<<":
            return float(_wrap_i32(to_int32(left) << (to_uint32(right) & 31)))
        if op == ">>":
            return float(to_int32(left) >> (to_uint32(right) & 31))
        if op == ">>>":
            return float(to_uint32(left) >> (to_uint32(right) & 31))
        if op == "in":
            key = self._prop_key(left)
            if isinstance(right, JSArray):
                try:
                    i = int(key)
                    return 0 <= i < len(right.elements)
                except ValueError:
                    return key == "length"
            if isinstance(right, JSObject):
                o = right
                while o is not None:
                    if key in o.props:
                        return True
                    o = o.proto
                return False
            if isinstance(right, FUNCTION_TYPES):
                return key in right.props
            throw("'in' requires an object", "TypeError")
        if op == "instanceof":
            if isinstance(right, NativeFunction):
                if right.name == "Array":
                    return isinstance(left, JSArray)
                if right.name == "Object":
                    return isinstance(left, (JSObject, JSArray))
                if right.name == "RegExp":
                    return isinstance(left, JSRegExp)
                if right.name == "Function":
                    return isinstance(left, FUNCTION_TYPES)
                if right.name == "Error":
                    return isinstance(left, JSObject) \
                        and "message" in left.props
            if isinstance(right, JSFunction):
                proto = right.props.get("prototype")
                o = left.proto if isinstance(left, JSObject) else None
                while o is not None:
                    if o is proto:
                        return True
                    o = o.proto
            return False
        raise JSSyntaxError(f"unknown binary operator {op!r}")

    def _eval_unop(self, op, operand_expr, scope):
        if op == "typeof":
            if operand_expr[0] == "ident" \
                    and not scope.has(operand_expr[1]):
                return "undefined"
            return type_of(self.eval_expr(operand_expr, scope))
        if op == "delete":
            if operand_expr[0] == "member":
                obj = self.eval_expr(operand_expr[1], scope)
                return self._delete_member(obj, operand_expr[2])
            if operand_expr[0] == "index":
                obj = self.eval_expr(operand_expr[1], scope)
                key = self._prop_key(
                    self.eval_expr(operand_expr[2], scope))
                return self._delete_member(obj, key)
            if operand_expr[0] == "ident":
                return scope.delete(operand_expr[1])
            return True
        v = self.eval_expr(operand_expr, scope)
        if op == "!":
            return not to_boolean(v)
        if op == "-":
            return -to_number(v)
        if op == "+":
            return to_number(v)
        if op == "~":
            return float(_wrap_i32(~to_int32(v)))
        if op == "void":
            return UNDEFINED
        raise JSSyntaxError(f"unknown unary operator {op!r}")

    @staticmethod
    def _delete_member(obj, key) -> bool:
        if isinstance(obj, JSObject):
            if obj.frozen or obj.sealed:
                # ES5 8.12.7: deleting a MISSING property returns true
                # even on sealed/frozen objects; only existing
                # (non-configurable) properties refuse
                return key not in obj.props
            obj.props.pop(key, None)
            obj.nonenum.discard(key)
            return True
        if isinstance(obj, FUNCTION_TYPES):
            obj.props.pop(key, None)
            return True
        if isinstance(obj, JSArray):
            try:
                i = int(key)
                if 0 <= i < len(obj.elements):
                    obj.elements[i] = UNDEFINED
            except ValueError:
                pass
            return True
        return True

    # -- property access ------------------------------------------------
    def get_member(self, obj, name: str):
        if obj is UNDEFINED or obj is None:
            throw(f"Cannot read property '{name}' of {to_string(obj)}",
                  "TypeError")
        if isinstance(obj, str):
            return _string_member(self, obj, name)
        if isinstance(obj, JSArray):
            return _array_member(self, obj, name)
        if isinstance(obj, bool):
            return UNDEFINED
        if isinstance(obj, float):
            return _number_member(self, obj, name)
        if isinstance(obj, JSRegExp):
            return _regex_member(self, obj, name)
        if isinstance(obj, FUNCTION_TYPES):
            if name in obj.props:
                return obj.props[name]
            if name == "prototype" and isinstance(obj, JSFunction):
                # auto-created on first access (ES5 13.2): the object
                # `new` instances will link to; its constructor
                # back-link is non-enumerable per the spec
                proto = JSObject(
                    {"constructor": obj}, nonenum=("constructor",)
                )
                obj.props["prototype"] = proto
                return proto
            return _function_member(self, obj, name)
        if isinstance(obj, JSObject):
            o = obj
            while o is not None:
                if name in o.props:
                    v = o.props[name]
                    if isinstance(v, JSAccessor):
                        if v.get is None:
                            return UNDEFINED
                        return self.call(v.get, [], this=obj)
                    return v
                o = o.proto
            return _object_member(self, obj, name)
        return UNDEFINED

    def set_member(self, obj, name: str, value):
        if isinstance(obj, JSObject):
            # accessor setters fire through the prototype chain
            # (ES5 8.12.5 [[Put]])
            o = obj
            while o is not None:
                if name in o.props:
                    v = o.props[name]
                    if isinstance(v, JSAccessor):
                        if v.set is not None:
                            self.call(v.set, [value], this=obj)
                        return  # no setter: silent no-op (sloppy)
                    break
                o = o.proto
            if obj.frozen:
                return  # frozen: writes are silent no-ops (sloppy)
            if obj.sealed and name not in obj.props:
                return  # sealed: no new properties
            obj.props[name] = value
            return
        if isinstance(obj, FUNCTION_TYPES):
            obj.props[name] = value
            return
        if isinstance(obj, JSArray):
            if obj.frozen:
                return  # frozen array: writes are silent no-ops (sloppy)
            if name == "length":
                n = to_integer(value)
                cur = len(obj.elements)
                if n < cur:
                    del obj.elements[n:]
                else:
                    obj.elements.extend([UNDEFINED] * (n - cur))
                return
            try:
                i = int(name)
            except ValueError:
                return  # named props on arrays not modeled
            if i < 0:
                return
            if i >= len(obj.elements):
                obj.elements.extend(
                    [UNDEFINED] * (i + 1 - len(obj.elements)))
            obj.elements[i] = value
            return
        if isinstance(obj, JSRegExp):
            if name == "lastIndex":
                obj.last_index = to_integer(value)
            else:
                obj.props[name] = value
            return
        if obj is UNDEFINED or obj is None:
            throw(f"Cannot set property '{name}' of {to_string(obj)}",
                  "TypeError")
        # setting props on primitives is a silent no-op in sloppy mode


def _wrap_i32(i: int) -> int:
    i &= 0xFFFFFFFF
    return i - (1 << 32) if i >= (1 << 31) else i


_NO_VALUE = object()


# -- builtin member tables ----------------------------------------------

def _nf(fn, name):
    return NativeFunction(fn, name)


def _string_member(interp, s: str, name: str):
    if name == "length":
        return float(len(s))
    try:
        i = int(name)
        if 0 <= i < len(s):
            return s[i]
    except ValueError:
        pass

    def m(fn):
        return _nf(fn, name)

    if name == "charAt":
        return m(lambda it, this, a: s[to_integer(a[0] if a else 0)]
                 if 0 <= to_integer(a[0] if a else 0) < len(s) else "")
    if name == "charCodeAt":
        def char_code_at(it, this, a):
            i = to_integer(a[0]) if a else 0
            return float(ord(s[i])) if 0 <= i < len(s) else float("nan")
        return m(char_code_at)
    if name == "indexOf":
        return m(lambda it, this, a: float(
            s.find(to_string(a[0]) if a else "undefined",
                   to_integer(a[1]) if len(a) > 1 else 0)))
    if name == "lastIndexOf":
        return m(lambda it, this, a: float(
            s.rfind(to_string(a[0]) if a else "undefined")))
    if name == "slice":
        def str_slice(it, this, a):
            start = _slice_index(a[0] if a else UNDEFINED, len(s), 0)
            end = _slice_index(
                a[1] if len(a) > 1 else UNDEFINED, len(s), len(s))
            return s[start:max(start, end)]
        return m(str_slice)
    if name == "substring":
        def substring(it, this, a):
            start = _clamp_index(a[0] if a else UNDEFINED, len(s), 0)
            end = _clamp_index(
                a[1] if len(a) > 1 else UNDEFINED, len(s), len(s))
            if start > end:
                start, end = end, start
            return s[start:end]
        return m(substring)
    if name == "substr":
        def substr(it, this, a):
            start = to_integer(a[0]) if a else 0
            if start < 0:
                start = max(0, len(s) + start)
            length = to_integer(a[1]) if len(a) > 1 \
                and a[1] is not UNDEFINED else len(s) - start
            return s[start:start + max(0, length)]
        return m(substr)
    if name == "split":
        def split(it, this, a):
            if not a or a[0] is UNDEFINED:
                return JSArray([s])
            limit = to_integer(a[1]) if len(a) > 1 \
                and a[1] is not UNDEFINED else -1
            if isinstance(a[0], JSRegExp):
                parts = a[0].regex.split(s)
            else:
                sep = to_string(a[0])
                parts = list(s) if sep == "" else s.split(sep)
            if limit >= 0:
                parts = parts[:limit]
            return JSArray(parts)
        return m(split)
    if name == "toUpperCase":
        return m(lambda it, this, a: s.upper())
    if name == "toLowerCase":
        return m(lambda it, this, a: s.lower())
    if name == "trim":
        return m(lambda it, this, a: s.strip())
    if name == "concat":
        return m(lambda it, this, a: s + "".join(to_string(x) for x in a))
    if name == "replace":
        def replace(it, this, a):
            pat = a[0] if a else UNDEFINED
            rep = a[1] if len(a) > 1 else UNDEFINED
            if isinstance(rep, FUNCTION_TYPES):
                def repl_fn(match):
                    args = [match.group(0)]
                    args += [g if g is not None else UNDEFINED
                             for g in match.groups()]
                    args.append(float(match.start()))
                    args.append(s)
                    return to_string(it.call(rep, args))
            else:
                rep_str = to_string(rep)

                def repl_fn(match):
                    out, i = [], 0
                    while i < len(rep_str):
                        if rep_str[i] == "$" and i + 1 < len(rep_str):
                            c = rep_str[i + 1]
                            if c == "$":
                                out.append("$")
                                i += 2
                                continue
                            if c == "&":
                                out.append(match.group(0))
                                i += 2
                                continue
                            if c.isdigit():
                                gi = int(c)
                                if gi <= len(match.groups()):
                                    out.append(match.group(gi) or "")
                                    i += 2
                                    continue
                        out.append(rep_str[i])
                        i += 1
                    return "".join(out)
            if isinstance(pat, JSRegExp):
                count = 0 if "g" in pat.flags else 1
                return pat.regex.sub(repl_fn, s, count=count)
            pat_str = to_string(pat)
            idx = s.find(pat_str)
            if idx < 0:
                return s
            fake = re.match(re.escape(pat_str), s[idx:])
            return s[:idx] + repl_fn(fake) + s[idx + len(pat_str):]
        return m(replace)
    if name == "match":
        def match_fn(it, this, a):
            pat = a[0] if a else UNDEFINED
            rx = pat if isinstance(pat, JSRegExp) \
                else JSRegExp(to_string(pat))
            if "g" in rx.flags:
                found = rx.regex.findall(s)
                if not found:
                    return None
                out = [f if isinstance(f, str) else f[0] for f in found]
                return JSArray(out)
            mm = rx.regex.search(s)
            if mm is None:
                return None
            arr = JSArray([mm.group(0)]
                          + [g if g is not None else UNDEFINED
                             for g in mm.groups()])
            return arr
        return m(match_fn)
    if name == "search":
        def search_fn(it, this, a):
            pat = a[0] if a else UNDEFINED
            rx = pat if isinstance(pat, JSRegExp) \
                else JSRegExp(to_string(pat))
            mm = rx.regex.search(s)
            return float(mm.start()) if mm else -1.0
        return m(search_fn)
    if name == "startsWith":
        return m(lambda it, this, a: s.startswith(to_string(a[0]) if a
                                                  else "undefined"))
    if name == "endsWith":
        return m(lambda it, this, a: s.endswith(to_string(a[0]) if a
                                                else "undefined"))
    if name == "toString":
        return m(lambda it, this, a: s)
    return UNDEFINED


def _slice_index(v, length, default):
    if v is UNDEFINED:
        return default
    i = to_integer(v)
    if i < 0:
        i += length
    return max(0, min(i, length))


def _clamp_index(v, length, default):
    if v is UNDEFINED:
        return default
    n = to_number(v)
    if n != n:
        return 0
    return max(0, min(int(n), length))


def _array_member(interp, arr: JSArray, name: str):
    els = arr.elements
    if name == "length":
        return float(len(els))
    try:
        i = int(name)
        return els[i] if 0 <= i < len(els) else UNDEFINED
    except ValueError:
        pass

    def m(fn):
        return _nf(fn, name)

    if name in (
        "push", "pop", "shift", "unshift", "splice", "reverse", "sort",
    ) and arr.frozen:
        # frozen array: mutators are silent no-ops in sloppy mode
        if name == "push":
            return m(lambda it, this, a: float(len(els)))
        if name in ("pop", "shift"):
            return m(lambda it, this, a: UNDEFINED)
        if name == "unshift":
            return m(lambda it, this, a: float(len(els)))
        if name == "splice":
            return m(lambda it, this, a: JSArray([]))
        return m(lambda it, this, a: arr)  # reverse/sort return this

    if name == "push":
        def push(it, this, a):
            els.extend(a)
            return float(len(els))
        return m(push)
    if name == "pop":
        return m(lambda it, this, a: els.pop() if els else UNDEFINED)
    if name == "shift":
        return m(lambda it, this, a: els.pop(0) if els else UNDEFINED)
    if name == "unshift":
        def unshift(it, this, a):
            els[0:0] = a
            return float(len(els))
        return m(unshift)
    if name == "slice":
        def arr_slice(it, this, a):
            start = _slice_index(a[0] if a else UNDEFINED, len(els), 0)
            end = _slice_index(
                a[1] if len(a) > 1 else UNDEFINED, len(els), len(els))
            return JSArray(els[start:max(start, end)])
        return m(arr_slice)
    if name == "splice":
        def splice(it, this, a):
            start = _slice_index(a[0] if a else UNDEFINED, len(els), 0)
            dc = len(els) - start if len(a) < 2 \
                else max(0, to_integer(a[1]))
            removed = els[start:start + dc]
            els[start:start + dc] = list(a[2:])
            return JSArray(removed)
        return m(splice)
    if name == "concat":
        def concat(it, this, a):
            out = list(els)
            for x in a:
                if isinstance(x, JSArray):
                    out.extend(x.elements)
                else:
                    out.append(x)
            return JSArray(out)
        return m(concat)
    if name == "join":
        def join(it, this, a):
            sep = to_string(a[0]) if a and a[0] is not UNDEFINED else ","
            return sep.join(
                "" if e is UNDEFINED or e is None else to_string(e)
                for e in els)
        return m(join)
    if name == "indexOf":
        def index_of(it, this, a):
            target = a[0] if a else UNDEFINED
            for i, e in enumerate(els):
                if strict_eq(e, target):
                    return float(i)
            return -1.0
        return m(index_of)
    if name == "lastIndexOf":
        def last_index_of(it, this, a):
            target = a[0] if a else UNDEFINED
            for i in range(len(els) - 1, -1, -1):
                if strict_eq(els[i], target):
                    return float(i)
            return -1.0
        return m(last_index_of)
    if name == "reverse":
        def rev(it, this, a):
            els.reverse()
            return arr
        return m(rev)
    if name == "sort":
        def sort(it, this, a):
            cmp = a[0] if a and isinstance(a[0], FUNCTION_TYPES) else None
            import functools
            if cmp is not None:
                def pycmp(x, y):
                    r = to_number(it.call(cmp, [x, y]))
                    return -1 if r < 0 else (1 if r > 0 else 0)
                els.sort(key=functools.cmp_to_key(pycmp))
            else:
                undef = [e for e in els if e is UNDEFINED]
                rest = [e for e in els if e is not UNDEFINED]
                rest.sort(key=to_string)
                els[:] = rest + undef
            return arr
        return m(sort)
    if name == "map":
        def map_fn(it, this, a):
            fn = a[0]
            return JSArray([
                it.call(fn, [e, float(i), arr])
                for i, e in enumerate(list(els))])
        return m(map_fn)
    if name == "filter":
        def filter_fn(it, this, a):
            fn = a[0]
            return JSArray([
                e for i, e in enumerate(list(els))
                if to_boolean(it.call(fn, [e, float(i), arr]))])
        return m(filter_fn)
    if name == "forEach":
        def foreach(it, this, a):
            fn = a[0]
            for i, e in enumerate(list(els)):
                it.call(fn, [e, float(i), arr])
            return UNDEFINED
        return m(foreach)
    if name == "reduce":
        def reduce_fn(it, this, a):
            fn = a[0]
            items = list(els)
            if len(a) > 1:
                acc = a[1]
                start = 0
            else:
                if not items:
                    throw("Reduce of empty array with no initial value",
                          "TypeError")
                acc = items[0]
                start = 1
            for i in range(start, len(items)):
                acc = it.call(fn, [acc, items[i], float(i), arr])
            return acc
        return m(reduce_fn)
    if name == "some":
        def some(it, this, a):
            fn = a[0]
            return any(
                to_boolean(it.call(fn, [e, float(i), arr]))
                for i, e in enumerate(list(els)))
        return m(some)
    if name == "every":
        def every(it, this, a):
            fn = a[0]
            return all(
                to_boolean(it.call(fn, [e, float(i), arr]))
                for i, e in enumerate(list(els)))
        return m(every)
    if name == "toString":
        return m(lambda it, this, a: to_string(arr))
    if name == "hasOwnProperty":
        def has_own(it, this, a):
            key = Interpreter._prop_key(a[0]) if a else "undefined"
            try:
                return 0 <= int(key) < len(els)
            except ValueError:
                return key == "length"
        return m(has_own)
    return UNDEFINED


def _number_member(interp, n: float, name: str):
    def m(fn):
        return _nf(fn, name)

    if name == "toFixed":
        def to_fixed(it, this, a):
            digits = to_integer(a[0]) if a and a[0] is not UNDEFINED \
                else 0
            return f"{n:.{digits}f}"
        return m(to_fixed)
    if name == "toString":
        def num_to_string(it, this, a):
            if a and a[0] is not UNDEFINED:
                radix = to_integer(a[0])
                if radix == 10:
                    return js_num_str(n)
                i = int(n)
                if i == 0:
                    return "0"
                digits = "0123456789abcdefghijklmnopqrstuvwxyz"
                neg, i = i < 0, abs(i)
                out = []
                while i:
                    out.append(digits[i % radix])
                    i //= radix
                return ("-" if neg else "") + "".join(reversed(out))
            return js_num_str(n)
        return m(num_to_string)
    if name == "valueOf":
        return m(lambda it, this, a: n)
    return UNDEFINED


def _regex_member(interp, rx: JSRegExp, name: str):
    if name == "source":
        return rx.source
    if name == "flags":
        return rx.flags
    if name == "global":
        return "g" in rx.flags
    if name == "lastIndex":
        return float(rx.last_index)

    def m(fn):
        return _nf(fn, name)

    if name == "test":
        return m(lambda it, this, a: rx.regex.search(
            to_string(a[0]) if a else "undefined") is not None)
    if name == "exec":
        def exec_fn(it, this, a):
            s = to_string(a[0]) if a else "undefined"
            start = rx.last_index if "g" in rx.flags else 0
            mm = rx.regex.search(s, start)
            if mm is None:
                rx.last_index = 0
                return None
            if "g" in rx.flags:
                rx.last_index = mm.end()
            out = JSArray([mm.group(0)]
                          + [g if g is not None else UNDEFINED
                             for g in mm.groups()])
            return out
        return m(exec_fn)
    if name == "toString":
        return m(lambda it, this, a: repr(rx))
    return rx.props.get(name, UNDEFINED)


def _object_member(interp, obj: JSObject, name: str):
    def m(fn):
        return _nf(fn, name)

    if name == "hasOwnProperty":
        return m(lambda it, this, a: (
            Interpreter._prop_key(a[0]) if a else "undefined")
            in obj.props)
    if name == "toString":
        return m(lambda it, this, a: to_string(obj))
    return UNDEFINED


def _function_member(interp, fn, name: str):
    def m(f):
        return _nf(f, name)

    if name == "call":
        return m(lambda it, this, a: it.call(
            fn, a[1:], this=a[0] if a else UNDEFINED))
    if name == "apply":
        def apply_fn(it, this, a):
            args = []
            if len(a) > 1 and isinstance(a[1], JSArray):
                args = list(a[1].elements)
            return it.call(fn, args, this=a[0] if a else UNDEFINED)
        return m(apply_fn)
    if name == "bind":
        def bind_fn(it, this, a):
            bound_this = a[0] if a else UNDEFINED
            bound_args = list(a[1:])
            return NativeFunction(
                lambda it2, this2, a2: it2.call(
                    fn, bound_args + list(a2), this=bound_this),
                f"bound {getattr(fn, 'name', '')}")
        return m(bind_fn)
    if name == "name":
        return fn.name or ""
    if name == "toString":
        return m(lambda it, this, a: repr(fn))
    if name == "length":
        return float(len(fn.params)) if isinstance(fn, JSFunction) else 0.0
    return UNDEFINED


# -- JSON ------------------------------------------------------------------

def json_stringify(interp, value, replacer=None, indent_arg=UNDEFINED):
    indent = None
    if isinstance(indent_arg, float):
        indent = " " * min(10, max(0, int(indent_arg)))
    elif isinstance(indent_arg, str):
        indent = indent_arg[:10]

    def apply_replacer(holder, key, val):
        if isinstance(replacer, FUNCTION_TYPES):
            return interp.call(replacer, [key, val], this=holder)
        return val

    def ser(val, depth, holder, key):
        val = apply_replacer(holder, key, val)
        if val is None:
            return "null"
        if isinstance(val, bool):
            return "true" if val else "false"
        if isinstance(val, float):
            if val != val or val in (float("inf"), float("-inf")):
                return "null"
            return js_num_str(val)
        if isinstance(val, str):
            return _pyjson.dumps(val, ensure_ascii=False)
        if isinstance(val, JSArray):
            if not val.elements:
                return "[]"
            parts = []
            for i, e in enumerate(val.elements):
                p = ser(e, depth + 1, val, js_num_str(float(i)))
                parts.append("null" if p is None else p)
            return _join_parts(parts, "[", "]", indent, depth)
        if isinstance(val, JSObject):
            parts = []
            for k, v in val.props.items():
                if k in val.nonenum:
                    continue
                if isinstance(v, JSAccessor):
                    v = interp.call(v.get, [], this=val) \
                        if v.get is not None else UNDEFINED
                p = ser(v, depth + 1, val, k)
                if p is None:
                    continue
                kstr = _pyjson.dumps(k, ensure_ascii=False)
                sep = ": " if indent else ":"
                parts.append(f"{kstr}{sep}{p}")
            if not parts:
                return "{}"
            return _join_parts(parts, "{", "}", indent, depth)
        return None  # undefined / function / regex drop out

    root = JSObject({"": value})
    out = ser(value, 0, root, "")
    return UNDEFINED if out is None else out


def _join_parts(parts, open_c, close_c, indent, depth):
    if not indent:
        return open_c + ",".join(parts) + close_c
    pad = indent * (depth + 1)
    pad_close = indent * depth
    inner = (",\n" + pad).join(parts)
    return f"{open_c}\n{pad}{inner}\n{pad_close}{close_c}"


def json_parse(interp, text, reviver=None):
    try:
        data = _pyjson.loads(text)
    except Exception as e:
        throw(f"JSON.parse: {e}", "SyntaxError")
    value = python_to_js(data)
    if not isinstance(reviver, FUNCTION_TYPES):
        return value

    def walk(holder, key):
        val = interp.get_member(holder, key)
        if isinstance(val, JSArray):
            for i in range(len(val.elements)):
                new = walk(val, js_num_str(float(i)))
                if new is UNDEFINED:
                    val.elements[i] = UNDEFINED
                else:
                    val.elements[i] = new
        elif isinstance(val, JSObject):
            for k in list(val.props.keys()):
                new = walk(val, k)
                if new is UNDEFINED:
                    del val.props[k]
                else:
                    val.props[k] = new
        return interp.call(reviver, [key, val], this=holder)

    root = JSObject({"": value})
    return walk(root, "")


# -- global builtins ----------------------------------------------------

def install_builtins(interp: Interpreter):
    g = interp.global_scope

    g.declare("undefined", UNDEFINED)
    g.declare("NaN", float("nan"))
    g.declare("Infinity", float("inf"))
    global_proxy = _make_global_proxy(interp)
    g.declare("this", global_proxy)  # top-level `this` is the global obj
    g.declare("globalThis", global_proxy)

    # JSON
    json_obj = JSObject()
    json_obj.props["stringify"] = _nf(
        lambda it, this, a: json_stringify(
            it, a[0] if a else UNDEFINED,
            a[1] if len(a) > 1 else None,
            a[2] if len(a) > 2 else UNDEFINED),
        "stringify")
    json_obj.props["parse"] = _nf(
        lambda it, this, a: json_parse(
            it, to_string(a[0]) if a else "undefined",
            a[1] if len(a) > 1 else None),
        "parse")
    g.declare("JSON", json_obj)

    # Math
    math_obj = JSObject()
    _m1 = {
        "floor": math.floor, "ceil": math.ceil,
        "sqrt": math.sqrt, "sin": math.sin, "cos": math.cos,
        "tan": math.tan, "atan": math.atan, "asin": math.asin,
        "acos": math.acos, "exp": math.exp,
    }

    def _math1(fn, nm):
        def wrapped(it, this, a):
            x = to_number(a[0]) if a else float("nan")
            if x != x:
                return float("nan")
            try:
                return float(fn(x))
            except (ValueError, OverflowError):
                return float("nan")
        return _nf(wrapped, nm)

    for nm, fn in _m1.items():
        math_obj.props[nm] = _math1(fn, nm)

    def _math_abs(it, this, a):
        return abs(to_number(a[0])) if a else float("nan")

    def _math_round(it, this, a):
        x = to_number(a[0]) if a else float("nan")
        if x != x or x in (float("inf"), float("-inf")):
            return x
        return float(math.floor(x + 0.5))  # JS rounds .5 up

    def _math_log(it, this, a):
        x = to_number(a[0]) if a else float("nan")
        if x != x or x < 0:
            return float("nan")
        if x == 0:
            return float("-inf")
        return math.log(x)

    def _math_pow(it, this, a):
        try:
            return float(math.pow(to_number(a[0]), to_number(a[1])))
        except (ValueError, OverflowError, IndexError):
            return float("nan")

    def _math_min(it, this, a):
        vals = [to_number(x) for x in a]
        if any(v != v for v in vals):
            return float("nan")
        return min(vals) if vals else float("inf")

    def _math_max(it, this, a):
        vals = [to_number(x) for x in a]
        if any(v != v for v in vals):
            return float("nan")
        return max(vals) if vals else float("-inf")

    def _math_atan2(it, this, a):
        try:
            return math.atan2(to_number(a[0]), to_number(a[1]))
        except IndexError:
            return float("nan")

    math_obj.props["abs"] = _nf(_math_abs, "abs")
    math_obj.props["round"] = _nf(_math_round, "round")
    math_obj.props["log"] = _nf(_math_log, "log")
    math_obj.props["pow"] = _nf(_math_pow, "pow")
    math_obj.props["min"] = _nf(_math_min, "min")
    math_obj.props["max"] = _nf(_math_max, "max")
    math_obj.props["atan2"] = _nf(_math_atan2, "atan2")
    math_obj.props["random"] = _nf(
        lambda it, this, a: random.random(), "random")
    math_obj.props["PI"] = math.pi
    math_obj.props["E"] = math.e
    g.declare("Math", math_obj)

    # global functions
    def _parse_int(it, this, a):
        s = to_string(a[0]).strip() if a else "undefined"
        radix = to_integer(a[1]) if len(a) > 1 \
            and a[1] is not UNDEFINED and to_number(a[1]) == to_number(a[1]) \
            else 10
        if radix == 0:
            radix = 10
        if radix < 2 or radix > 36:
            return float("nan")  # ES5 15.1.2.2 step 8
        neg = False
        if s[:1] in "+-":
            neg = s[0] == "-"
            s = s[1:]
        if radix == 16 and s[:2].lower() == "0x":
            s = s[2:]
        elif radix == 10 and s[:2].lower() == "0x":
            radix = 16
            s = s[2:]
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:radix]
        i = 0
        while i < len(s) and s[i].lower() in digits:
            i += 1
        if i == 0:
            return float("nan")
        v = float(int(s[:i], radix))
        return -v if neg else v

    def _parse_float(it, this, a):
        s = to_string(a[0]).strip() if a else "undefined"
        mm = re.match(
            r"[+-]?(Infinity|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)",
            s)
        if not mm:
            return float("nan")
        t = mm.group(0)
        if t.endswith("Infinity"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float(t)

    g.declare("parseInt", _nf(_parse_int, "parseInt"))
    g.declare("parseFloat", _nf(_parse_float, "parseFloat"))
    g.declare("isNaN", _nf(
        lambda it, this, a: to_number(a[0] if a else UNDEFINED)
        != to_number(a[0] if a else UNDEFINED), "isNaN"))
    g.declare("isFinite", _nf(
        lambda it, this, a: math.isfinite(to_number(a[0]))
        if a and to_number(a[0]) == to_number(a[0]) else False, "isFinite"))

    # constructors / namespaces
    def _string_ctor(it, this, a):
        return to_string(a[0]) if a else ""

    string_fn = NativeFunction(_string_ctor, "String")
    string_fn.props["fromCharCode"] = _nf(
        lambda it, this, a: "".join(chr(to_integer(x) & 0xFFFF) for x in a),
        "fromCharCode")
    g.declare("String", string_fn)

    def _number_ctor(it, this, a):
        return to_number(a[0]) if a else 0.0

    number_fn = NativeFunction(_number_ctor, "Number")
    number_fn.props["MAX_VALUE"] = 1.7976931348623157e308
    number_fn.props["MIN_VALUE"] = 5e-324
    number_fn.props["MAX_SAFE_INTEGER"] = float(2**53 - 1)
    number_fn.props["isInteger"] = _nf(
        lambda it, this, a: isinstance(a[0], float) and a[0] == int(a[0])
        if a else False, "isInteger")
    g.declare("Number", number_fn)

    g.declare("Boolean", NativeFunction(
        lambda it, this, a: to_boolean(a[0]) if a else False, "Boolean"))

    def _array_ctor(it, args):
        if len(args) == 1 and isinstance(args[0], float):
            return JSArray([UNDEFINED] * int(args[0]))
        return JSArray(list(args))

    array_fn = NativeFunction(
        lambda it, this, a: _array_ctor(it, a), "Array",
        construct=_array_ctor)
    array_fn.props["isArray"] = _nf(
        lambda it, this, a: isinstance(a[0], JSArray) if a else False,
        "isArray")
    g.declare("Array", array_fn)

    def _object_keys(it, this, a):
        o = a[0] if a else UNDEFINED
        if isinstance(o, JSObject):
            return JSArray(
                [k for k in o.props if k not in o.nonenum]
            )
        if isinstance(o, JSArray):
            return JSArray(
                [js_num_str(float(i)) for i in range(len(o.elements))])
        if isinstance(o, FUNCTION_TYPES):
            return JSArray(list(o.props.keys()))
        return JSArray([])

    def _object_values(it, this, a):
        o = a[0] if a else UNDEFINED
        if isinstance(o, JSObject):
            return JSArray(
                [it.get_member(o, k) for k in o.props
                 if k not in o.nonenum]
            )
        if isinstance(o, JSArray):
            return JSArray(list(o.elements))
        return JSArray([])

    object_fn = NativeFunction(
        lambda it, this, a: a[0] if a and isinstance(
            a[0], (JSObject, JSArray)) else JSObject(), "Object",
        construct=lambda it, a: JSObject())
    def _need_obj(a, i=0):
        o = a[i] if len(a) > i else UNDEFINED
        if not isinstance(o, JSObject):
            throw("Object.* called on non-object", "TypeError")
        return o

    def _apply_descriptor(it, o, name, desc):
        if not isinstance(desc, JSObject):
            throw("Property description must be an object", "TypeError")
        getter = desc.props.get("get")
        setter = desc.props.get("set")
        if getter is not None or setter is not None:
            acc = JSAccessor(
                getter if isinstance(getter, FUNCTION_TYPES) else None,
                setter if isinstance(setter, FUNCTION_TYPES) else None,
            )
            o.props[name] = acc
        elif "value" in desc.props:
            o.props[name] = desc.props["value"]
        elif name not in o.props:
            o.props[name] = UNDEFINED
        if "enumerable" in desc.props:
            if to_boolean(desc.props["enumerable"]):
                o.nonenum.discard(name)
            else:
                o.nonenum.add(name)
        elif getter is not None or setter is not None or \
                "value" in desc.props:
            # defineProperty defaults [[Enumerable]] to FALSE
            # (ES5 8.12.9/15.2.3.6) — unlike plain assignment
            o.nonenum.add(name)

    def _define_property(it, this, a):
        o = _need_obj(a)
        name = to_string(a[1]) if len(a) > 1 else "undefined"
        _apply_descriptor(it, o, name, a[2] if len(a) > 2 else UNDEFINED)
        return o

    def _define_properties(it, this, a):
        o = _need_obj(a)
        descs = a[1] if len(a) > 1 else UNDEFINED
        if isinstance(descs, JSObject):
            for k, d in list(descs.props.items()):
                _apply_descriptor(it, o, k, d)
        return o

    def _object_create(it, this, a):
        proto = a[0] if a else UNDEFINED
        o = JSObject(proto=proto if isinstance(proto, JSObject) else None)
        if len(a) > 1 and isinstance(a[1], JSObject):
            for k, d in list(a[1].props.items()):
                _apply_descriptor(it, o, k, d)
        return o

    def _get_own_descriptor(it, this, a):
        o = _need_obj(a)
        name = to_string(a[1]) if len(a) > 1 else ""
        if name not in o.props:
            return UNDEFINED
        v = o.props[name]
        d = JSObject()
        if isinstance(v, JSAccessor):
            d.props["get"] = v.get if v.get is not None else UNDEFINED
            d.props["set"] = v.set if v.set is not None else UNDEFINED
        else:
            d.props["value"] = v
            d.props["writable"] = not o.frozen
        d.props["enumerable"] = name not in o.nonenum
        d.props["configurable"] = not (o.frozen or o.sealed)
        return d

    def _freeze(it, this, a):
        o = a[0] if a else UNDEFINED
        if isinstance(o, JSObject):
            o.frozen = True
            o.sealed = True
        elif isinstance(o, JSArray):
            o.frozen = True
        return o

    def _seal(it, this, a):
        o = a[0] if a else UNDEFINED
        if isinstance(o, JSObject):
            o.sealed = True
        elif isinstance(o, JSArray):
            # sealed array: no adds/deletes; element writes stay legal.
            # Arrays model that as frozen-length only; full seal
            # semantics need per-element attributes we approximate by
            # the frozen flag for freeze. Sealing is rare on arrays in
            # prelude-shaped jobs; keep writes allowed (spec) by NOT
            # setting frozen here.
            pass
        return o

    object_fn.props["keys"] = _nf(_object_keys, "keys")
    object_fn.props["values"] = _nf(_object_values, "values")
    object_fn.props["create"] = _nf(_object_create, "create")
    object_fn.props["defineProperty"] = _nf(
        _define_property, "defineProperty")
    object_fn.props["defineProperties"] = _nf(
        _define_properties, "defineProperties")
    object_fn.props["getOwnPropertyDescriptor"] = _nf(
        _get_own_descriptor, "getOwnPropertyDescriptor")
    object_fn.props["getOwnPropertyNames"] = _nf(
        lambda it, this, a: JSArray(list(_need_obj(a).props.keys())),
        "getOwnPropertyNames")
    object_fn.props["getPrototypeOf"] = _nf(
        lambda it, this, a: (
            _need_obj(a).proto if _need_obj(a).proto is not None
            else None
        ),
        "getPrototypeOf")
    object_fn.props["freeze"] = _nf(_freeze, "freeze")
    object_fn.props["isFrozen"] = _nf(
        lambda it, this, a: bool(
            (isinstance(a[0], JSObject) and a[0].frozen)
            or (isinstance(a[0], JSArray) and a[0].frozen)
        ) if a else False,
        "isFrozen")
    object_fn.props["seal"] = _nf(_seal, "seal")
    object_fn.props["isSealed"] = _nf(
        lambda it, this, a: bool(
            isinstance(a[0], JSObject) and (a[0].sealed or a[0].frozen)
        ) if a else False,
        "isSealed")
    object_fn.props["preventExtensions"] = _nf(_seal, "preventExtensions")
    object_fn.props["isExtensible"] = _nf(
        lambda it, this, a: bool(
            isinstance(a[0], JSObject)
            and not (a[0].sealed or a[0].frozen)
        ) if a else False,
        "isExtensible")
    g.declare("Object", object_fn)

    def _regexp_ctor(it, args):
        src = to_string(args[0]) if args else ""
        if args and isinstance(args[0], JSRegExp):
            src = args[0].source
        flags = to_string(args[1]) if len(args) > 1 \
            and args[1] is not UNDEFINED else ""
        return JSRegExp(src, flags)

    g.declare("RegExp", NativeFunction(
        lambda it, this, a: _regexp_ctor(it, a), "RegExp",
        construct=_regexp_ctor))

    def _error_ctor(nm):
        def ctor(it, args):
            err = JSObject()
            err.props["name"] = nm
            err.props["message"] = to_string(args[0]) if args else ""
            return err
        return NativeFunction(
            lambda it, this, a: ctor(it, a), nm, construct=ctor)

    for nm in ("Error", "TypeError", "RangeError", "SyntaxError",
               "ReferenceError"):
        g.declare(nm, _error_ctor(nm))

    # Date (minimal: construction from now/ms, getTime, toISOString)
    def _date_ctor(it, args):
        d = JSObject()
        ms = time.time() * 1000.0 if not args else to_number(args[0])
        d.props["__ms__"] = ms
        d.props["getTime"] = _nf(lambda i2, t2, a2: ms, "getTime")
        d.props["valueOf"] = _nf(lambda i2, t2, a2: ms, "valueOf")

        def iso(i2, t2, a2):
            t = time.gmtime(ms / 1000.0)
            frac = int(ms % 1000)
            return time.strftime("%Y-%m-%dT%H:%M:%S", t) + f".{frac:03d}Z"
        d.props["toISOString"] = _nf(iso, "toISOString")
        return d

    date_fn = NativeFunction(
        lambda it, this, a: _date_ctor(it, a), "Date",
        construct=_date_ctor)
    date_fn.props["now"] = _nf(
        lambda it, this, a: float(int(time.time() * 1000)), "now")
    g.declare("Date", date_fn)

    # eval (global-scope; the closure wire format round-trips through it)
    def _eval(it, this, a):
        if not a or not isinstance(a[0], str):
            return a[0] if a else UNDEFINED
        try:
            return it.run(a[0])
        except JSSyntaxError as e:
            throw(str(e), "SyntaxError")

    g.declare("eval", _nf(_eval, "eval"))


def _make_global_proxy(interp):
    """`this`/globalThis at top level: a live view over the global scope."""
    class _GlobalProxy(JSObject):
        __slots__ = ()

        @property
        def props(self):  # type: ignore[override]
            return interp.global_scope.vars

    proxy = _GlobalProxy.__new__(_GlobalProxy)
    return proxy
