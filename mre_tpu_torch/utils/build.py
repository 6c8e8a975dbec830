"""Build a file once, safely under concurrent first use.

The port compiles its native code at first use into ``mre_tpu_torch/_build/``
(``ops/attention.py``: nvcc; ``openke/native.py``: g++). Several processes
may find the directory empty at once: the ranks of a process mesh, or
parallel test workers. ``build_once`` lets one of them build while the others
wait on an exclusive ``flock`` of the build directory (released by the
kernel if its holder dies, and it leaves no lock file behind), then find the
file built. The product is written under a temporary name and renamed into place,
so no process ever loads a half-written file.
"""

from __future__ import annotations

import fcntl
import os
from pathlib import Path
from typing import Callable


def build_once(target: str | os.PathLike, produce: Callable[[Path], None],
               stale: Callable[[Path], bool] | None = None) -> Path:
    """``target``, made by ``produce(tmp)`` (which writes the file ``tmp``)
    when it is missing or ``stale(target)``. ``produce``'s exception
    propagates and leaves neither ``target`` nor ``tmp`` behind."""
    target = Path(target)

    def needed() -> bool:
        return not target.exists() or (stale is not None and stale(target))

    if not needed():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    lock = os.open(target.parent, os.O_RDONLY)
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if needed():                 # another process may have built it meanwhile
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            try:
                produce(tmp)
                os.replace(tmp, target)
            finally:
                if tmp.exists():
                    tmp.unlink()
    finally:
        os.close(lock)               # closing the descriptor releases the lock
    return target
