"""Host-clock spans of the LM step, off by default.

A span site tests the module flag ``on`` at each of its two ends, and does
nothing more while the recorder is off: no clock read, no allocation, no
context manager built::

    if spans.on:
        spans.begin("attn_in")
    ...
    if spans.on:
        spans.end()

While it is on (``enable()``), ``begin`` opens a span inside the innermost
open one and ``end`` closes the innermost.  Each span holds its name, its
start and end from ``time.perf_counter_ns()``, the index of its parent
(-1 for none), the request id of its root (``root``), which every span
below the root shares, and one small integer attribute (the layer of a
``block``).  Spans stay in memory until ``collect()`` takes them.  The
recorder serves one thread: the LM step runs on the caller's thread.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

on = False
# the spans so far, one list a field (no object a span, so that recording
# leaves the collector of cycles nothing to count): name, start and end
# ns, parent, request id, attribute
_name: list = []
_start: list = []
_end: list = []
_parent: list = []
_rid: list = []
_attr: list = []
_open: list = []  # indices of the open spans, the innermost last


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index in the collected list, -1 for a root
    request_id: Optional[int]
    attr: Optional[int]


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def begin(name: str, attr: Optional[int] = None) -> None:
    """Open ``name`` inside the innermost open span."""
    if _open:
        parent = _open[-1]
        _rid.append(_rid[parent])
    else:
        parent = -1
        _rid.append(None)
    _open.append(len(_name))
    _name.append(name)
    _parent.append(parent)
    _attr.append(attr)
    _end.append(0)
    _start.append(time.perf_counter_ns())


def end() -> None:
    """Close the innermost open span."""
    _end[_open.pop()] = time.perf_counter_ns()


@contextlib.contextmanager
def root(name: str, request_id: int):
    """A span that opens a request: every span opened inside it carries
    ``request_id``.  Records nothing while the recorder is off."""
    if not on:
        yield
        return
    begin(name)
    _rid[-1] = request_id
    try:
        yield
    finally:
        end()


def collect() -> list[Span]:
    """The recorded spans, in the order they opened, and an empty
    recorder."""
    fields = (_name, _start, _end, _parent, _rid, _attr)
    out = [Span(*f) for f in zip(*fields)]
    for f in (*fields, _open):
        f.clear()
    return out
