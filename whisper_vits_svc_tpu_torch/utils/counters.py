"""Counters that modules keep as module attributes: kernel launches,
windows run, forwards replayed. A module sets each of its counters to 0,
adds to it where the event happens, and declares the names once here; the
registry then reads them (`counts`) and adds to them (`add_counts`) by
name. A CUDA graph's replay runs no Python, so infer/stream.py takes back
what a capture counted and adds it again at each replay, over the whole
registry: a kernel that a captured forward launches is counted without the
stream runtime naming its module.
"""

from __future__ import annotations

import sys

_declared: dict[str, tuple[str, ...]] = {}  # module name -> its counters' names


def declare(module: str, *names: str):
    """Register the counters `names` of the module named `module` (its
    `__name__`). Returns that module's own (counts, add_counts): a reader
    of its counters by name, and an adder of such a dict."""
    _declared[module] = names
    return (lambda: counts()[module]), (lambda delta: add_counts({module: delta}))


def counts() -> dict[str, dict[str, int]]:
    """Every declared counter: {module name: {counter name: value}}."""
    return {module: {name: getattr(sys.modules[module], name) for name in names}
            for module, names in _declared.items()}


def add_counts(delta: dict[str, dict[str, int]], sign: int = 1) -> None:
    """Add `sign` times `delta` (shaped as `counts` gives it) to the
    counters."""
    for module, named in delta.items():
        mod = sys.modules[module]
        for name, n in named.items():
            setattr(mod, name, getattr(mod, name) + sign * n)


def since(before: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    """The counters that moved since `before` (as `counts` gave it), by what
    they gained, shaped as `counts`; a module declared since then counts
    from 0."""
    moved = {}
    for module, named in counts().items():
        was = before.get(module, {})
        gained = {name: n - was.get(name, 0) for name, n in named.items() if n != was.get(name, 0)}
        if gained:
            moved[module] = gained
    return moved
