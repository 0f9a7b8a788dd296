"""The trace reader on a canned Chrome trace: nested ranges, a backward
launched from another thread, the priming left out, an idle gap."""

import json

import pytest

from benchmark import tracing


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


EVENTS = [
    _x("user_annotation", "bench.prime", 0, 50),
    _launch(10, 1), _x("kernel", "prime_add", 20, 5, tid=100, corr=1),
    _x("user_annotation", "bench.round", 1000, 1000),
    _x("user_annotation", "hefl.sgd_core", 1000, 500),
    _x("user_annotation", "hefl.augment", 1100, 100),
    _launch(1150, 2), _x("kernel", "warp", 1160, 30, tid=100, corr=2),
    _launch(1300, 3), _x("kernel", "conv_fwd", 1310, 100, tid=100, corr=3),
    # the backward, launched by the autograd thread while tid 1 waits in sgd_core
    _launch(1400, 4, tid=2), _x("kernel", "conv_bwd", 1405, 50, tid=100, corr=4),
    _x("user_annotation", "hefl.encrypt", 1600, 100),
    _launch(1650, 5), _x("kernel", "encrypt_fused", 1655, 20, tid=100, corr=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 1660, 2, 1, 6), _x("gpu_memcpy", "Memcpy DtoH", 1680, 10, tid=100, corr=6),
    # a launch whose kernel event the profiler lost
    _launch(1700, 7),
]


@pytest.fixture
def rt(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.read_round_trace(str(path))


def test_phases_and_priming(rt):
    phases = {op[0]: op[4] for op in rt.ops}
    assert "prime_add" not in phases
    assert phases == {"warp": "hefl.augment", "conv_fwd": "hefl.sgd_core",
                      "conv_bwd": "hefl.sgd_core", "encrypt_fused": "hefl.encrypt",
                      "Memcpy DtoH": "hefl.encrypt"}
    assert rt.window == (1000.0, 2000.0)
    assert rt.dropped == 1 and rt.unlinked == 0


def test_busy_counts_and_breakdown(rt):
    train = ("hefl.sgd_core", "hefl.augment", "hefl.val")
    assert rt.busy_us(train) == 30 + 100 + 50 - 5       # conv_fwd and conv_bwd overlap by 5
    assert rt.kernels(train) == 3
    assert rt.busy_us(("hefl.encrypt",)) == 20 + 10
    assert rt.busy_us() == 175 + 30
    bd = rt.breakdown()
    assert bd["device_ops"][0] == ["conv_fwd", 100e-6]
    gaps = dict(bd["idle_gaps"])
    # 1000-1160 and 1190-1310 inside sgd_core, 1675-1680 inside encrypt,
    # 1455-1655 and 1690-2000 with no hefl range open
    assert gaps == pytest.approx({"hefl.sgd_core": 280e-6, "hefl.encrypt": 5e-6,
                                  "none": 510e-6})
    assert bd["idle_gaps"][0][0] == "none"


def test_a_trace_without_device_ops_fails(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in EVENTS if e["cat"] not in
                                                tracing.DEVICE_OP_CATS]}))
    with pytest.raises(tracing.TraceError):
        tracing.read_round_trace(str(path))
