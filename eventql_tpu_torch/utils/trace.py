"""Query-scoped spans: where the host spends a query, from plan to emit.

A span records its name, the query it belongs to, its own id and its
parent's, its start and end in ``time.time_ns()`` and a few attributes.
The parent is the innermost span open on the same thread; a span opened
with none open is a root, and has no query unless it is given one. A
child takes its parent's query.

``time.time_ns()`` is the Unix clock, which is also the clock of the
Chrome trace that ``torch.profiler`` exports (``baseTimeNanoseconds`` +
``ts`` x 1000), so the spans can be laid on the device's timeline after
the fact, and no profiler call is made on the hot path (an annotation
costs about a hundred times a flag check).

The tracer is off by default, and then ``span`` returns one shared
no-op context after a single flag check; call sites build no name and
no attribute when it is off. It is on in two ways:

- ``enable()`` switches it on for the process until ``disable()``.
  Every finished span is kept in memory, the newest ``CAPACITY`` of
  them; ``DROPPED`` counts the older ones a full buffer let go.
  ``drain()`` takes them all out; nothing is written anywhere.
- A traced transaction (``Transaction(trace=[])``, or every one under
  ``EVENTQL_TRACE=1``; exec/runtime.py) opens its plan, execute and
  emit stages with ``stage(..., sink=<its list>)``. The tracer is on
  while such a stage is open, and each span of that query lands in the
  transaction's list; the buffer keeps them only under ``enable()``.

Span names are short and fixed; each belongs to one layer of the
port: ``query.plan``, ``query.execute`` (entry and planner),
``op.<PlanNode>``, ``readback``, ``query.emit`` (host engine and emit),
``route.<name>`` (routes), ``upload`` (column cache), ``expr``
(expressions), ``kernel.<wrapper>``, ``build`` (kernels).
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import List, Optional

# spans are recorded: enable() was called, or a traced stage is open
ON = False
CAPACITY = 1 << 18
# finished spans a full buffer let go, since import
DROPPED = 0

_ENABLED = False
_BUFFER = collections.deque(maxlen=CAPACITY)
# query id -> [the traced transaction's list, its stages open now]
_SINKS = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()
_SPAN_IDS = itertools.count(1)
_QUERY_IDS = itertools.count(1)


class Span:
    """One timed interval of host work; ``set`` adds an attribute."""

    __slots__ = ("name", "query", "id", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, query: Optional[int] = None, role: Optional[str] = None):
        self.name = name
        self.query = query
        self.attrs = {} if role is None else {"role": role}
        self.id = self.parent = self.start_ns = self.end_ns = None

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.query is None:
                self.query = top.query
        self.id = next(_SPAN_IDS)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        _stack().pop()
        global DROPPED
        with _LOCK:
            sink = _SINKS.get(self.query)
            if sink is not None:
                sink[0].append(self)
            if _ENABLED:
                if len(_BUFFER) == _BUFFER.maxlen:
                    DROPPED += 1
                _BUFFER.append(self)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self) -> str:
        return f"Span({self.name!r}, query={self.query}, id={self.id}, parent={self.parent})"


class _Stage(Span):
    """A stage of a traced transaction's query: the tracer is on while it
    is open, and the query's spans land in ``sink``."""

    __slots__ = ("sink",)

    def __init__(self, name: str, query: int, sink: list):
        super().__init__(name, query)
        self.sink = sink

    def __enter__(self) -> "Span":
        global ON
        with _LOCK:
            _SINKS.setdefault(self.query, [self.sink, 0])[1] += 1
            ON = True
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        global ON
        try:
            super().__exit__(*exc)
        finally:
            with _LOCK:
                entry = _SINKS[self.query]
                entry[1] -= 1
                if not entry[1]:
                    del _SINKS[self.query]
                ON = _ENABLED or bool(_SINKS)


class _NoSpan:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def set(self, key, value) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, query: Optional[int] = None, role: Optional[str] = None):
    """A context that times ``name`` as a child of the innermost open
    span; ``query`` names the query of a root span, ``role`` what an
    ``expr`` span computes. NO_SPAN while the tracer is off."""
    if not ON:
        return NO_SPAN
    return Span(name, query, role)


def stage(name: str, query: int, sink: Optional[list] = None):
    """The span of a query's stage (``query.plan``, ``query.execute``,
    ``query.emit``, or an operator run outside ``query.execute``);
    ``sink`` is the list of a traced transaction, which the query's spans
    join while the stage is open."""
    if sink is not None:
        return _Stage(name, query, sink)
    return span(name, query)


def spanned(name: str):
    """Decorate a function so that each call runs inside a ``name`` span."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)

        return traced

    return wrap


def note(key: str, value, span: Optional[str] = None) -> None:
    """Set an attribute of the innermost span open on this thread, if any
    (and if it is named ``span``, where that is given)."""
    if not ON:
        return
    stack = getattr(_LOCAL, "stack", None)
    if stack and (span is None or stack[-1].name == span):
        stack[-1].attrs[key] = value


def next_query_id() -> int:
    return next(_QUERY_IDS)


def enable() -> None:
    global ON, _ENABLED
    with _LOCK:
        _ENABLED = ON = True


def disable() -> None:
    global ON, _ENABLED
    with _LOCK:
        _ENABLED = False
        ON = bool(_SINKS)


def drain() -> List[Span]:
    """Every finished span in the buffer, in the order they ended; the
    buffer is left empty."""
    with _LOCK:
        out = list(_BUFFER)
        _BUFFER.clear()
    return out


def report(items: List[Span]) -> str:
    """The spans as a tree, in pre-order: children under their parent in
    start order, a line each with its milliseconds and attributes (the
    rows an operator returned as "<n> rows")."""
    ids = {s.id for s in items}
    children = collections.defaultdict(list)
    for s in sorted(items, key=lambda s: (s.start_ns, s.id)):
        children[s.parent if s.parent in ids else None].append(s)
    out = []
    todo = [(s, 0) for s in reversed(children[None])]
    while todo:
        s, depth = todo.pop()
        parts = [f"{s.ms:.3f} ms"]
        parts += [f"{v} rows" if k == "rows" else f"{k}={v}" for k, v in s.attrs.items()]
        name = s.name[3:] if s.name.startswith("op.") else s.name
        out.append(f"{'  ' * depth}{name}: {', '.join(parts)}")
        todo.extend((c, depth + 1) for c in reversed(children[s.id]))
    return "\n".join(out)
