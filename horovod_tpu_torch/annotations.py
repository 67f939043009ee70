"""Code annotations the `horovod_tpu_torch.analysis` linter keys on.

Pure-metadata decorators with zero runtime behavior: importing this
module pulls in nothing (no jax), and the decorators return their
function unchanged, so they are free to stack above `jax.jit` /
`functools.partial(jax.jit, ...)` wrappers.
"""

from __future__ import annotations

__all__ = ["hot_path", "thread_entry"]


def hot_path(fn):
    """Mark ``fn`` as a serving/decode hot-path entry point.

    `hvdlint`'s HVD001 (host-sync-in-hot-path) treats every function
    reachable from a ``@hot_path`` entry as latency-critical: a stray
    ``.item()`` / ``np.asarray`` / ``block_until_ready`` there
    re-serializes the pipelined tick ring (docs/analysis.md). The
    marker is matched *syntactically* by the analyzer, so it works on
    any callable; the attribute below is best-effort runtime
    introspection only (some callables, e.g. jit wrappers, reject
    attribute writes).
    """
    try:
        fn.__hvd_hot_path__ = True
    except (AttributeError, TypeError):
        pass
    return fn


def thread_entry(fn):
    """Mark ``fn`` as a thread entry point the analyzer cannot see.

    `hvdlint`'s HVD008 (cross-thread-race) discovers thread roots from
    ``threading.Thread(target=...)`` sites it can resolve statically;
    a target passed through a callback table, a partial, or an
    executor is invisible. Decorating the function declares "this body
    runs on its own thread" so its reachable attribute accesses join
    the cross-thread analysis. Matched syntactically, like
    `hot_path`.
    """
    try:
        fn.__hvd_thread_entry__ = True
    except (AttributeError, TypeError):
        pass
    return fn
