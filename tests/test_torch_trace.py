"""obs.scopes and obs.trace of the port against the JAX package's.

The phase names are the JAX module's, in its order. `trace_attribution`
reads `torch.profiler` traces, which carry no compiled program: the same
seeded timeline of device ops, phase ranges, containers and host spans is
written once as a JAX trace with its HLO text (the form of
tests/fixtures/golden_hlo.txt) and once as a torch trace (kernel events,
their `cuda_runtime` launches, `user_annotation` ranges, one backward
launch on a second thread), and the two records agree. The failure cases
are the JAX test's, plus a CUDA trace whose launches have no kernels.
"""

import gzip
import json
import time

import numpy as np
import pytest

from hefl_tpu.obs import scopes as jax_scopes
from hefl_tpu.obs import trace as jax_trace
from hefl_tpu_torch.obs import scopes
from hefl_tpu_torch.obs import trace

PID, MAIN, AUTOGRAD, DEVICE, STREAM = 7, 11, 12, 0, 7
MODULE = "hefl.phase.train+encrypt+aggregate"


def test_scope_names_are_the_jax_modules():
    names = [n for n in vars(jax_scopes) if n.isupper() and not n.startswith("_")]
    assert names, "no names read from hefl_tpu.obs.scopes"
    for name in names:
        assert getattr(scopes, name) == getattr(jax_scopes, name), name
    assert scopes.PHASES == jax_scopes.PHASES
    assert len(scopes.PHASES) == 14
    assert scopes.PHASES[0] == scopes.AUGMENT and scopes.PHASES[-1] == scopes.SERVE_HOIST
    # The port's own copies of the helpers, on the JAX test's strings.
    for s in ("jit(f)/jit(main)/hefl.sgd_core/jit(aug)/hefl.augment/gather",
              "jit(f)/vmap(hefl.sgd_core)/vmap(jit(_shuffle))/while",
              "jit(f)/jit(main)/reduce_sum", "hefl.serve_keyswitch", "hefl.phase.decrypt"):
        assert scopes.scope_of(s) == jax_scopes.scope_of(s), s
        assert scopes.is_phase_scope(s) == jax_scopes.is_phase_scope(s), s


def test_scoped_opens_a_range_per_call():
    import torch
    from torch.profiler import ProfilerActivity, profile

    @scopes.scoped(scopes.ENCRYPT)
    def f(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(torch.ones(3))
        f(torch.ones(3))
    hits = [e for e in prof.events() if e.name == scopes.ENCRYPT]
    assert len(hits) == 2
    assert f.__name__ == "f"


@pytest.mark.parametrize("seed", range(4))
def test_interval_unions_equal_the_jax_functions(seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 1000, 200)
    iv = [(float(s), float(s + d)) for s, d in zip(starts, rng.exponential(20, 200))]
    cover = [(float(s), float(s + d)) for s, d in
             zip(rng.uniform(0, 1000, 50), rng.exponential(40, 50))]
    assert trace._merged_length_us(iv) == jax_trace._merged_length_us(iv)
    assert trace._subtract_covered_us(iv, cover) == jax_trace._subtract_covered_us(iv, cover)
    assert trace._subtract_covered_us([], cover) == jax_trace._subtract_covered_us([], cover)


# ---------------------------------------------------------------- timelines


def _timeline(seed: int):
    """A seeded round: host segments, each a phase range (sgd_core with a
    nested augment range) or a gap, with kernels launched inside them (one
    sgd_core segment's backward launched from a second thread), two
    scope-less containers spanning others, a PhaseTimer bracket and a
    straggler wait. Integer microseconds, so both records are exact.
    -> (ops [(launch_ts, tid, ts, dur, phase, jax_path)], ranges
    [(name, ts, dur)], host spans [(name, ts, dur)])."""
    rng = np.random.default_rng(seed)
    choices = [scopes.SGD_CORE, scopes.VAL, scopes.ENCRYPT, scopes.PSUM_AGGREGATE,
               scopes.DECRYPT, scopes.EVALUATE, scopes.SANITIZE, None]
    ops, ranges = [], []
    t = 1000
    backward_done = False
    for _ in range(14):
        phase = choices[int(rng.integers(len(choices)))]
        length = int(rng.integers(60, 240))
        if phase is not None:
            ranges.append((phase, t, length))
        inner = None
        if phase == scopes.SGD_CORE:
            inner = (t + length // 4, length // 3)
            ranges.append((scopes.AUGMENT, *inner))
        for _ in range(int(rng.integers(1, 6))):
            lts = t + int(rng.integers(0, length))
            tid = MAIN
            if phase == scopes.SGD_CORE and not backward_done and not (
                    inner[0] <= lts < inner[0] + inner[1]):
                tid, backward_done = AUTOGRAD, True
            owner = phase
            path = "jit(synth)/jit(main)/" + (phase or "") + "/op"
            if inner is not None and inner[0] <= lts < inner[0] + inner[1]:
                owner = scopes.AUGMENT
                path = f"jit(synth)/jit(main)/{phase}/vmap({scopes.AUGMENT})/gather"
            ops.append((lts, tid, lts + int(rng.integers(1, 40)), int(rng.integers(1, 50)),
                        owner, path if owner is not None else None))
        t += length + int(rng.integers(0, 30))
    # Two containers: launched before any range, spanning other ops.
    for lo, hi in ((1100, 1400), (t // 2, t // 2 + 500)):
        ops.append((500, MAIN, lo, hi - lo, None, None))
    hosts = [(MODULE, 900, t - 800), (scopes.STRAGGLER_WAIT, t + 10, 250)]
    return ops, ranges, hosts


def _jax_trace(ops, hosts):
    """The JAX format: device events named by their HLO instruction, the
    scopes in the HLO text's op_name metadata, host spans without a module."""
    lines = ["HloModule jit_synth, entry_computation_layout={(f32[4]{0})->f32[4]{0}}", "",
             "ENTRY %main.1 (Arg_0.1: f32[4]) -> f32[4] {",
             "  %Arg_0.1 = f32[4]{0} parameter(0)"]
    events = []
    for i, (_, _, ts, dur, _, path) in enumerate(ops):
        meta = f', metadata={{op_name="{path}" source_file="synth.py" source_line=1}}' if path else ""
        lines.append(f"  %op.{i} = f32[4]{{0}} add(f32[4]{{0}} %Arg_0.1, f32[4]{{0}} %Arg_0.1)"
                     + meta)
        events.append({"ph": "X", "name": f"op.{i}", "pid": 1, "tid": 1 + i % 2, "ts": ts,
                       "dur": dur, "args": {"hlo_module": "jit_synth", "hlo_op": f"op.{i}"}})
    lines += ["  ROOT %r.2 = f32[4]{0} copy(f32[4]{0} %Arg_0.1)", "}"]
    for name, ts, dur in hosts:
        events.append({"ph": "X", "name": name, "pid": 2, "tid": 1, "ts": ts, "dur": dur})
    return events, "\n".join(lines)


def _torch_trace(ops, ranges, hosts):
    """The torch.profiler format: a kernel and its cuda_runtime launch per
    op (joined by correlation), the ranges as user_annotation events on the
    main thread, and what the attribution must ignore: gpu_user_annotation
    mirrors, flow events, cpu_ops, a non-hefl range."""
    events = [{"ph": "X", "cat": "user_annotation", "name": name, "pid": PID, "tid": MAIN,
               "ts": ts, "dur": dur} for name, ts, dur in list(ranges) + list(hosts)]
    events.append({"ph": "X", "cat": "user_annotation", "name": "other", "pid": PID,
                   "tid": MAIN, "ts": 0, "dur": 10**6})
    for i, (lts, tid, ts, dur, _, _) in enumerate(ops):
        corr = 1000 + i
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": PID,
                       "tid": tid, "ts": lts, "dur": 3, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"void k{i}()", "pid": DEVICE,
                       "tid": STREAM, "ts": ts, "dur": dur, "args": {"correlation": corr}})
        events.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr, "pid": PID,
                       "tid": tid, "ts": lts})
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": PID, "tid": tid,
                       "ts": lts - 1, "dur": 5})
    for name, ts, dur in ranges:
        events.append({"ph": "X", "cat": "gpu_user_annotation", "name": name, "pid": DEVICE,
                       "tid": STREAM, "ts": ts, "dur": dur * 3})
    return events


@pytest.mark.parametrize("seed", range(3))
def test_same_timeline_gives_the_jax_record(seed):
    ops, ranges, hosts = _timeline(seed)
    jax_events, hlo = _jax_trace(ops, hosts)
    want = jax_trace.trace_attribution(jax_events, [hlo])
    got = trace.trace_attribution(_torch_trace(ops, ranges, hosts))
    assert list(got["rows"]) == list(want["rows"])
    for ph, row in want["rows"].items():
        assert got["rows"][ph]["op_events"] == row["op_events"], ph
        assert got["rows"][ph]["device_seconds"] == pytest.approx(row["device_seconds"], abs=1e-9)
    for key in ("unattributed_s", "device_total_s"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert got["host_rows"] == want["host_rows"]
    assert got["op_events"] == want["op_events"] == len(ops)
    assert got["device_events"] == "kernel" and got["source"] == "trace"
    assert got["dropped_launches"] == got["unlinked_device_events"] == 0
    assert got["suspected_truncated"] is False
    # The module: every op launched inside the PhaseTimer bracket.
    inside = [op for op in ops if 900 <= op[0] < 900 + hosts[0][2]]
    assert set(got["modules"]) == {MODULE}
    assert got["modules"][MODULE] == pytest.approx(
        trace._merged_length_us([(ts, ts + d) for _, _, ts, d, _, _ in inside]) / 1e6, abs=1e-9)
    assert trace.attributed_sum_s(got) == pytest.approx(jax_trace.attributed_sum_s(want),
                                                         abs=1e-8)


def test_backward_launch_on_another_thread_takes_the_waiting_threads_phase():
    # The autograd engine's device thread launches a backward kernel while
    # the main thread waits inside hefl.sgd_core; a kernel whose launching
    # thread has its own phase range keeps it; one launched outside every
    # range is unattributed.
    events = [
        {"ph": "X", "cat": "user_annotation", "name": scopes.SGD_CORE, "pid": PID, "tid": MAIN,
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": scopes.ENCRYPT, "pid": PID, "tid": 99,
         "ts": 0, "dur": 1000},
    ]
    for corr, (tid, lts, ts) in enumerate(((AUTOGRAD, 150, 300), (99, 150, 310),
                                           (AUTOGRAD, 500, 320))):
        events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": PID,
                    "tid": tid, "ts": lts, "dur": 2, "args": {"correlation": corr}},
                   {"ph": "X", "cat": "kernel", "name": "k", "pid": DEVICE, "tid": STREAM,
                    "ts": ts, "dur": 5, "args": {"correlation": corr}}]
    # The second process never lends its ranges.
    events.append({"ph": "X", "cat": "user_annotation", "name": scopes.VAL, "pid": PID + 1,
                   "tid": MAIN, "ts": 0, "dur": 1000})
    rec = trace.trace_attribution(events)
    # The kernel at 320 launches at 500: only tid 99's encrypt range holds
    # 500, so it is encrypt's, as is the one tid 99 launched at 150.
    assert rec["rows"][scopes.SGD_CORE] == {"device_seconds": 5e-6, "op_events": 1}
    assert rec["rows"][scopes.ENCRYPT] == {"device_seconds": 10e-6, "op_events": 2}
    assert rec["unattributed_s"] == 0.0


def test_innermost_range_wins_and_rows_follow_the_canonical_order():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": scopes.SERVE_ROTATE, "pid": PID,
         "tid": MAIN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": scopes.SERVE_KEYSWITCH, "pid": PID,
         "tid": MAIN, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "hefl.custom", "pid": PID,
         "tid": MAIN, "ts": 50, "dur": 10},
    ]
    for corr, lts in enumerate((5, 15, 55, 70)):
        events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "pid": PID,
                    "tid": MAIN, "ts": lts, "dur": 1, "args": {"correlation": corr}},
                   {"ph": "X", "cat": "kernel", "name": "k", "pid": DEVICE, "tid": STREAM,
                    "ts": 200 + 10 * corr, "dur": 4, "args": {"correlation": corr}}]
    rec = trace.trace_attribution(events)
    assert list(rec["rows"]) == [scopes.SERVE_ROTATE, scopes.SERVE_KEYSWITCH, "hefl.custom"]
    assert rec["rows"][scopes.SERVE_ROTATE]["op_events"] == 2
    assert rec["rows"][scopes.SERVE_KEYSWITCH]["op_events"] == 1
    assert rec["rows"]["hefl.custom"]["op_events"] == 1


def _launch_and_kernel(corr, kernel=True, ts=10):
    out = [{"ph": "X", "cat": "user_annotation", "name": scopes.DECRYPT, "pid": PID, "tid": MAIN,
            "ts": 0, "dur": 100},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "pid": PID,
            "tid": MAIN, "ts": ts, "dur": 2, "args": {"correlation": corr}}]
    if kernel:
        out.append({"ph": "X", "cat": "kernel", "name": "k", "pid": DEVICE, "tid": STREAM,
                    "ts": 200 + corr, "dur": 4, "args": {"correlation": corr}})
    return out


def test_dropped_kernel_event_counts_and_flags_truncation():
    events = _launch_and_kernel(1) + _launch_and_kernel(2, kernel=False)[1:]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "pid": PID,
                   "tid": MAIN, "ts": 50, "dur": 2, "args": {"correlation": 3}})
    rec = trace.trace_attribution(events)
    assert rec["dropped_launches"] == 1
    assert rec["suspected_truncated"] is True
    assert rec["rows"][scopes.DECRYPT]["op_events"] == 1
    by_event = trace.attributed_events(events)
    assert by_event["dropped"] == [{"name": "cudaLaunchKernelExC", "tid": MAIN, "ts": 10,
                                    "phase": scopes.DECRYPT}]
    assert [(op["name"], op["phase"]) for op in by_event["ops"]] == [("k", scopes.DECRYPT)]


def test_device_op_without_its_launch_is_unattributed():
    events = _launch_and_kernel(1) + [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": DEVICE, "tid": STREAM,
         "ts": 400, "dur": 6, "args": {"correlation": 77}}]
    rec = trace.trace_attribution(events)
    assert rec["unlinked_device_events"] == 1
    assert rec["unattributed_s"] == pytest.approx(6e-6)
    assert rec["device_total_s"] == pytest.approx(10e-6)
    assert rec["op_events"] == 2


def _write(path, blob: bytes):
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("case", ["truncated_gzip", "bad_json", "no_events", "empty_logdir",
                                  "launches_without_kernels", "no_device_ops"])
def test_unusable_traces_raise(tmp_path, case):
    good = gzip.compress(json.dumps({"traceEvents": _launch_and_kernel(1)}).encode())
    if case == "truncated_gzip":
        arg = _write(tmp_path / "t.pt.trace.json.gz", good[: len(good) // 2])
    elif case == "bad_json":
        arg = _write(tmp_path / "t.pt.trace.json.gz", gzip.compress(b"{not json"))
    elif case == "no_events":
        arg = _write(tmp_path / "t.pt.trace.json.gz",
                     gzip.compress(json.dumps({"traceEvents": []}).encode()))
    elif case == "empty_logdir":
        arg = str(tmp_path / "nothing")
    elif case == "launches_without_kernels":
        arg = _launch_and_kernel(1, kernel=False) + _launch_and_kernel(2, kernel=False)
    else:
        arg = [{"ph": "X", "cat": "user_annotation", "name": scopes.SGD_CORE, "pid": PID,
                "tid": MAIN, "ts": 0, "dur": 10}]
    with pytest.raises(trace.TraceParseError):
        trace.trace_attribution(arg)


def test_reads_the_newest_trace_file_of_a_logdir(tmp_path):
    old = {"traceEvents": _launch_and_kernel(1)}
    new = {"traceEvents": _launch_and_kernel(1) + _launch_and_kernel(2)[1:]}
    (tmp_path / "a").mkdir()
    p_old = tmp_path / "a" / "h_1.1.pt.trace.json.gz"
    p_old.write_bytes(gzip.compress(json.dumps(old).encode()))
    p_new = tmp_path / "h_1.2.pt.trace.json.gz"
    p_new.write_bytes(gzip.compress(json.dumps(new).encode()))
    import os
    os.utime(p_old, (1, 1))
    rec = trace.trace_attribution(str(tmp_path))
    assert rec["trace_file"] == str(p_new)
    assert rec["op_events"] == 2


def test_a_million_events_attribute_in_seconds():
    # 10**6 events: 250,000 kernels, their launches and a cpu_op each, and
    # a phase range every 40 launches over four threads.
    n = 250_000
    events = []
    for r in range(n // 40):
        events.append({"ph": "X", "cat": "user_annotation", "name": scopes.PHASES[r % 10],
                       "pid": PID, "tid": MAIN + r % 4, "ts": 400 * r, "dur": 390})
    for i in range(n):
        lts = 10 * i
        tid = MAIN + (i // 40) % 4
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": PID,
                       "tid": tid, "ts": lts, "dur": 2, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": "k", "pid": DEVICE, "tid": STREAM,
                       "ts": lts + 3, "dur": 5, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": PID, "tid": tid,
                       "ts": lts, "dur": 4})
    events += [{"ph": "i", "name": "x", "ts": 0}] * (10**6 - len(events))
    t0 = time.perf_counter()
    rec = trace.trace_attribution(events)
    elapsed = time.perf_counter() - t0
    assert elapsed < 30.0, elapsed
    assert rec["op_events"] == n
    assert sum(r["op_events"] for r in rec["rows"].values()) == n - 10 * (n // 400)
    assert rec["device_total_s"] == pytest.approx(n * 5e-6)


def test_port_kernel_names_are_the_three_templates():
    from hefl_tpu_torch.utils.roofline import is_port_kernel

    ours = ["void (anonymous namespace)::ntt_kernel<12, 1, false, (anonymous namespace)::"
            "EncryptRows, (anonymous namespace)::EncryptStore>(EncryptRows, EncryptStore, "
            "unsigned int const*)",
            "void (anonymous namespace)::keyswitch_reduce_kernel<3>(uint4 const*)",
            "void (anonymous namespace)::hoisted_lazy_kernel(uint4 const*, uint4 const*)"]
    theirs = ["void (anonymous namespace)::elementwise_kernel_with_index<int, F>(int, F)",
              "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<...>()",
              "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3"]
    assert all(is_port_kernel(n) for n in ours)
    assert not any(is_port_kernel(n) for n in theirs)


def test_priming_launches_are_left_out():
    # A window opens with throwaway launches in a hefl.profiler_prime range,
    # two of whose kernel events the profiler lost: no dropped launch, no
    # op; a launch without its kernel outside the range still counts, and
    # another thread's launch at the same time is not primed.
    events = _launch_and_kernel(1) + [
        {"ph": "X", "cat": "user_annotation", "name": scopes.PROFILER_PRIME, "pid": PID,
         "tid": MAIN, "ts": 1, "dur": 8}]
    for corr, kernel in ((10, False), (11, False), (12, True)):
        events += _launch_and_kernel(corr, kernel=kernel, ts=2 + corr % 10)[1:]
    rec = trace.trace_attribution(events)
    assert rec["dropped_launches"] == 0 and rec["op_events"] == 1
    assert scopes.PROFILER_PRIME not in rec["rows"] and not rec["host_rows"]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": PID,
                   "tid": AUTOGRAD, "ts": 3, "dur": 1, "args": {"correlation": 20}})
    assert trace.trace_attribution(events)["dropped_launches"] == 1
