"""Build the port's native code once, safely under concurrent first use.

The port compiles its native code at first use into ``mre_tpu_torch/_build/``:
the CUDA kernels of ``csrc/`` with nvcc (``build_cuda``, for
``ops/attention.py`` and ``ops/linear.py``) and the KGE sampler with g++
(``openke/native.py``). Several processes may find the directory empty at
once: the ranks of a process mesh, or parallel test workers. ``build_once``
lets one of them build while the others wait on an exclusive ``flock`` of
the build directory (released by the kernel if its holder dies, and it
leaves no lock file behind), then find the file built. The product is
written under a temporary name and renamed into place, so no process ever
loads a half-written file.

A CUDA build leaves ptxas's ``-v`` report beside its library;
``build_report`` reads it with the library's SASS (``cuobjdump``): each
kernel's registers, spills and tensor-core and TMA instruction counts, each
kernel named by the caller's ``key`` of its mangled symbol.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
# the kernels' sources, and the headers they share (csrc/*.cuh)
CSRC = _PKG / "csrc"


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


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return found


def nvcc_command(source: Path, out: Path, defines: tuple[str, ...] = (),
                 report: bool = False) -> list[str]:
    """nvcc's command for a shared library of ``source`` for sm_90a, with
    ``csrc/`` on the include path (a copy of a source built elsewhere still
    finds the shared headers); ``report``: ptxas's ``-v`` report on stderr."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
            *(("-Xptxas", "-v") if report else ()),
            *(f"-D{d}" for d in defines), "-o", str(out), str(source)]


def build_cuda(source: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` for sm_90a, once per hash of the source, the
    shared headers and ``defines`` (e.g. ``("ATTN_BLOCK_K=32",)`` for a tile
    sweep), into ``lib<stem>-<hash>.so``. ptxas's report goes beside the
    library, in place before the library is."""
    key = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))) + "\0".join(defines).encode()
    name = f"lib{source.stem}-{hashlib.sha256(key).hexdigest()[:12]}"
    report = BUILD_DIR / f"{name}.ptxas.txt"

    def compile_to(tmp: Path) -> None:
        proc = subprocess.run(nvcc_command(source, tmp, defines, report=True),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
        tmp_report.write_text(proc.stderr)
        os.replace(tmp_report, report)

    # one process compiles, concurrent first users wait for it
    return build_once(BUILD_DIR / f"{name}.so", compile_to)


def ptxas_report(text: str, key: Callable) -> dict:
    """Registers and spill bytes of each kernel, from the ``-Xptxas -v``
    report: ``{key(symbol): {"registers", "spill_stores", "spill_loads"}}``
    for each kernel whose mangled symbol ``key`` names (None: left out)."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = key(line)
            if cur is not None:
                out[cur] = {}
        elif cur is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[cur]["registers"] = int(m.group(1))
    return out


SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_counts(sass: str, key: Callable) -> dict:
    """The tensor-core and TMA instructions of each kernel in a
    ``cuobjdump -sass`` listing: ``{key(symbol): {"HMMA": n, "HGMMA": n,
    "UTMALDG": n}}`` (``mma.sync``, ``wgmma`` and TMA tile loads), kernels
    named as in ``ptxas_report``."""
    out, cur = {}, None
    ops = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in sass.splitlines():
        if "Function :" in line:
            cur = key(line)
            if cur is not None:
                out[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None and (m := ops.search(line)):
            out[cur][m.group(1)] += 1
    return out


def build_report(lib: Path, key: Callable) -> dict:
    """ptxas registers and spills of every kernel of a built library, with
    its SASS counts of ``HMMA``, ``HGMMA`` and ``UTMALDG`` (lower-case keys)
    where the toolkit has ``cuobjdump`` (else each is None), and
    ``wgmma_serialized``: whether ptxas warned that it serialised some
    kernel's ``wgmma``s; kernels named as in ``ptxas_report``."""
    text = lib.with_suffix(".ptxas.txt").read_text()
    report = ptxas_report(text, key)
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    counts = {}
    if cuobjdump.exists():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True)
        counts = sass_counts(proc.stdout, key)
    serialized = "wgmma.mma_async instructions are serialized" in text
    for name, rec in report.items():
        for op in SASS_OPS:
            rec[op.lower()] = counts[name][op] if name in counts else None
        rec["wgmma_serialized"] = serialized
    return report
