"""The kernel builder's load-or-build under threads
(``cruise_control_tpu_torch/kernels/build.py``): the server's handler
threads, the pipeline's stage threads and the fleet's precompute thread can
reach a kernel's first launch together. One process-wide lock makes the
load-or-build happen once, and every build writes a temporary file named by
process and thread. No ``nvcc`` runs here: the build and the loader are
stand-ins that record their calls."""
import sys
import threading
import time
import types

from cruise_control_tpu_torch.kernels import build as B


def test_library_builds_and_loads_once_across_threads(monkeypatch, tmp_path):
    target = tmp_path / "libfake.so"
    built, loaded = [], []

    def fake_build_all(names):
        built.append(tuple(names))
        time.sleep(0.05)               # a build takes a while
        target.write_bytes(b"\0")

    class FakeLib:
        def __getattr__(self, fn):
            ns = types.SimpleNamespace(argtypes=None, restype=None)
            object.__setattr__(self, fn, ns)
            return ns

    def fake_cdll(path):
        loaded.append(path)
        time.sleep(0.01)
        return FakeLib()

    monkeypatch.setattr(B, "_loaded", {})
    monkeypatch.setattr(B, "_target", lambda name: target)
    monkeypatch.setattr(B, "build_all", fake_build_all)
    monkeypatch.setattr(B.ctypes, "CDLL", fake_cdll)
    out = [None] * 16
    start = threading.Barrier(len(out))

    def first_launch(i):
        start.wait(10)
        out[i] = B.library("fake", {"cc_fake": [B.P]})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=first_launch, args=(i,)) for i in range(len(out))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert built == [("fake",)] and len(loaded) == 1
    assert all(lib is out[0] for lib in out)
    assert out[0].cc_fake.argtypes == [B.P] and out[0].cc_fake.restype is B.I


def test_build_temporary_file_is_named_by_process_and_thread(monkeypatch, tmp_path):
    cmds = []

    class FakeProc:
        def __init__(self, cmd, **_kw):
            cmds.append(cmd)

    monkeypatch.setattr(B, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(B, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(B.subprocess, "Popen", FakeProc)
    tmps = {}
    # both threads stay alive until both have named their file: a thread
    # that ended may hand its identity to the next one
    both = threading.Barrier(2)

    def start(i):
        _proc, tmp, _out = B._start("segment_sum")
        tmps[i] = (tmp, threading.get_ident())
        both.wait(10)

    threads = [threading.Thread(target=start, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    (a, ta), (b, tb) = tmps[0], tmps[1]
    assert a != b
    import os
    assert f".{os.getpid()}.{ta}.tmp" in a.name and f".{os.getpid()}.{tb}.tmp" in b.name
    assert {a, b} == {type(a)(c[c.index("-o") + 1]) for c in cmds}


def test_lane_index_is_copied_once_and_lane_operand_keeps_one_lane():
    """A lane launch's index list reaches the device once per lane set (the
    pass loop reuses it), and a one-lane launch takes its operands as they
    are while several lanes' stack."""
    import torch
    a = B.lane_index([3, 1, 4], "cpu")
    assert a.dtype == torch.int64 and a.tolist() == [3, 1, 4]
    assert B.lane_index((3, 1, 4), torch.device("cpu")) is a
    assert B.lane_index([3, 1], "cpu") is not a
    x, y = torch.arange(4), torch.arange(4, 8)
    assert B.lane_operand([x], "t") is x
    assert torch.equal(B.lane_operand([x, y], "t"), torch.stack([x, y]))
    assert B.lane_operand([None, None], "t") is None
