"""The native builds under concurrent first use (``utils/build.py``), on the
CPU with no nvcc: several processes or threads that find ``_build/`` empty
build once, and none sees a half-written file."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from mre_tpu_torch.ops import attention
from mre_tpu_torch.utils import build
from mre_tpu_torch.utils.build import build_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a product written in two halves with a pause between: a reader of a
# half-written file would see "half"
WRITER = r"""
import os, sys, time
from pathlib import Path
from mre_tpu_torch.utils.build import build_once

target, log = Path(sys.argv[1]), sys.argv[2]

def produce(tmp):
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(tmp, "w") as f:
        f.write("half")
        f.flush()
        time.sleep(0.5)
        f.write("-whole")

print(build_once(target, produce).read_text())
"""


def test_concurrent_processes_build_once(tmp_path):
    target, log = tmp_path / "build" / "lib.so", tmp_path / "log"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, str(target), str(log)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert [o.strip() for o, _ in outs] == ["half-whole"] * 6
    assert len(log.read_text().split()) == 1            # one process built
    assert os.listdir(target.parent) == ["lib.so"]      # no temporary, no lock file


def test_a_failed_build_leaves_nothing_and_a_stale_file_is_rebuilt(tmp_path):
    target = tmp_path / "lib.so"

    def broken(tmp):
        tmp.write_text("partial")
        raise RuntimeError("compiler failed")

    with pytest.raises(RuntimeError, match="compiler failed"):
        build_once(target, broken)
    assert os.listdir(tmp_path) == []
    build_once(target, lambda tmp: tmp.write_text("v1"))
    build_once(target, lambda tmp: tmp.write_text("v2"))          # present: kept
    assert target.read_text() == "v1"
    build_once(target, lambda tmp: tmp.write_text("v3"), stale=lambda t: True)
    assert target.read_text() == "v3"


def test_attention_build_compiles_once_under_threads(tmp_path, monkeypatch):
    """``attention.build`` through a stand-in nvcc that is slow and counts
    its runs: four threads that find the build directory empty get one
    compile, the library and its ptxas report."""
    runs = tmp_path / "runs"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo run >> {runs}\n"
                    "sleep 0.5\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "echo library > \"$2\"\n"
                    "echo 'ptxas info    : Used 40 registers' >&2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    libs, errors = [], []

    def first_use():
        try:
            libs.append(attention.build())
        except Exception as e:           # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(libs)) == 1 and libs[0].read_text() == "library\n"
    assert runs.read_text().split() == ["run"]
    report = Path(str(libs[0]).replace(".so", ".ptxas.txt"))
    assert "Used 40 registers" in report.read_text()
    assert sorted(os.listdir(tmp_path / "build")) == sorted([libs[0].name, report.name])
