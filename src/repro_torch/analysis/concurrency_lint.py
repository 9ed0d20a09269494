"""Lock-discipline declarations (counterpart of
``repro.analysis.concurrency_lint``).  The port has the ``guarded_by``
marker its serving layer uses; the reference's static linter that
checks it is not ported yet."""
from __future__ import annotations


def guarded_by(lock_attr: str):
    """Declare that callers of the decorated method must hold
    ``self.<lock_attr>``.  No-op at run time."""

    def mark(fn):
        fn.__guarded_by__ = lock_attr
        return fn

    return mark
