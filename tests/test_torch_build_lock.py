"""The kernel build from several threads (``repro_torch.kernels._build``).

The serving tier launches kernels from its dispatcher threads, one per
``BatchingServer`` (one per replica of a ``ReplicaPool``), so the first
launches of two replicas can reach ``_build.load`` together.  ``load``
must build and load each library once, whichever thread asks first, and
``build_all``'s temporary files must not be shared between calls.  The
compiler and the loader are replaced here by fakes (this host has no
``nvcc``): the build sleeps, so every thread reaches ``load`` while the
first is inside it.
"""
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_load_from_eight_threads_builds_and_loads_once(monkeypatch):
    builds, loads = [], []

    def slow_build_all():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return {"maxsim": Path("/nonexistent/libmaxsim.so")}

    class FakeCDLL:
        def __init__(self, path):
            loads.append(path)

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", slow_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    start = threading.Barrier(8)
    got, errors = [], []

    def worker():
        try:
            start.wait(timeout=10)
            got.append(_build.load("maxsim"))
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "a load() hung"
    assert errors == []
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert _build.load("maxsim") is got[0]  # later calls take the fast path


def test_build_all_temporaries_are_unique_per_call(monkeypatch, tmp_path):
    """Two ``build_all`` calls of one process (two threads) never write the
    same temporary file: each ``nvcc`` gets an output name of its own."""
    outputs = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            outputs.append(out)
            out.write_bytes(b"lib")
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakePopen)
    for _ in range(2):
        libs = _build.build_all()
        for lib in libs.values():
            lib.unlink()  # force a rebuild on the next call
    n = len(_build.sources())
    assert n >= 1 and len(outputs) == 2 * n
    assert len(set(outputs)) == len(outputs)
    assert all(o.suffix == ".tmp" and not o.exists() for o in outputs)
