"""The kernel layer under two threads (the async engine's serving and
mutation threads), on the CPU: ``kernels.build.load`` builds and loads each
library once however many threads reach it first, concurrent builds write
temporary files of their own, and the launch counters lose no update."""
import sys
import threading
import time
import types
from collections import Counter

import pytest

from repro_torch.kernels import build, counters

THREADS = 8


@pytest.fixture
def fast_switching():
    """Switch threads as often as the interpreter allows, to surface races."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(fn, n=THREADS):
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:  # noqa: BLE001 (re-raised below, in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]


def test_load_builds_and_loads_each_source_once(monkeypatch, tmp_path, fast_switching):
    built, opened = Counter(), Counter()
    lock = threading.Lock()

    def fake_build(names):
        for name in names:
            with lock:
                built[name] += 1
            time.sleep(0.02)          # a build takes a while: widen the window
            (tmp_path / f"{name}.so").write_bytes(b"")
        return {}

    class FakeLibrary:
        def __init__(self, path):
            with lock:
                opened[path] += 1

        def __getattr__(self, symbol):
            return types.SimpleNamespace(symbol=symbol)

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "library_path", lambda source: tmp_path / f"{source}.so")
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLibrary)
    loaded = [dict() for _ in range(THREADS)]

    def worker(i):
        for name in build.KERNELS:
            loaded[i][name] = build.load(name)

    _run_threads(worker)
    assert built == Counter({source: 1 for source in build.SOURCES})
    assert sum(opened.values()) == len(build.KERNELS)
    for name in build.KERNELS:     # every thread got the one loaded function
        assert len({id(d[name]) for d in loaded}) == 1
        assert loaded[0][name].argtypes == build.SIGNATURES[name][2]


def test_concurrent_builds_write_their_own_temporary_files(monkeypatch, tmp_path):
    outputs = []
    lock = threading.Lock()
    all_started = threading.Barrier(4)    # no nvcc ends before all four began

    class FakeProcess:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            with lock:
                outputs.append(out)
            open(out, "wb").close()

        def communicate(self):
            all_started.wait(timeout=30)
            return "", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path", lambda source: tmp_path / f"{source}-0.so")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProcess)
    _run_threads(lambda i: build.build(["sketch_fill"]), n=4)
    assert len(outputs) == 4 and len(set(outputs)) == 4
    assert (tmp_path / "sketch_fill-0.so").exists()
    assert not list(tmp_path.glob("*.tmp.so"))


def test_counters_count_exactly_under_concurrent_adds(fast_switching):
    counters.reset()
    per_thread = 3000

    def worker(i):
        for _ in range(per_thread):
            counters.launched("sketch_cardinality")
            counters.plain_called("sketch_fill")

    try:
        _run_threads(worker, n=16)
        assert counters.LAUNCHES["sketch_cardinality"] == 16 * per_thread
        assert counters.PLAIN_CALLS["sketch_fill"] == 16 * per_thread
    finally:
        counters.reset()
