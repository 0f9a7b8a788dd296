"""The harness end to end on the CPU at a tiny size (`rehearse`), and the
check coming out false under each fault a round can have, planted in the
system underneath the harness. The client mesh's cell is not in
BENCHMARK.json; its rehearsal adds it to the scratch manifest, so that
the harness's path over several ranks stays tested for the cell that
brings it back."""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness, rehearse
from benchmark.manifest import Cell, load, quantity

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["medcnn-medical.fedavg32", "resnet20-cifar10.fedavg16"]
MESH = "medcnn-medical.fedavg128-mesh4"
MESH_ENTRY = {"name": MESH, "config": "medcnn-medical", "traffic": "fedavg128-mesh4",
              "chips": 4, "why": "the client mesh: 32 clients a rank, the sum all-reduced mod p"}
SEED = 3


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {w: rehearse.tiny_root(w, str(tmp_path_factory.mktemp(w)),
                                 entry=MESH_ENTRY if w == MESH else None, reports=("round_s",))
           for w in CELLS + [MESH]}
    yield out
    for r in out.values():
        shutil.rmtree(r, ignore_errors=True)


def _run(root, workload):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.run(root, workload, SEED, 0.05, False, "cpu", log=lambda m: None)


@pytest.mark.parametrize("workload", CELLS + [MESH])
def test_rehearsal_is_correct(roots, workload):
    out = _run(roots[workload], workload)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    cell = Cell(roots[workload], load(roots[workload]), workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end()}
    assert {quantity(m) for m in out["metrics"]} == {"round_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"


def test_rehearse_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "rehearse.py"),
                           "--workload", CELLS[1], "--seed", str(SEED)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and "checks" in out


def _unchanged(set_):
    from hefl_tpu_torch.fl import secure
    real = secure.train_block

    def broken(model, cfg, global_params, xs, *a, **kw):
        _, mets = real(model, cfg, global_params, xs, *a, **kw)
        return [dict(global_params) for _ in range(int(xs.shape[0]))], mets
    set_(secure, "train_block", broken)


def _half_batch(set_):
    from hefl_tpu_torch.fl import fusion
    real = fusion.fused_step

    def half(model, cfg, params, opt, xb, onehot, *a, **kw):
        c, b = int(onehot.shape[0]), int(onehot.shape[1])
        xb = xb.reshape(c, b, *xb.shape[1:])[:, : b // 2].reshape(c * (b // 2), *xb.shape[1:])
        return real(model, cfg, params, opt, xb, onehot[:, : b // 2], *a, **kw)
    set_(fusion, "fused_step", half)


def _half(set_):
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.ckks.ops import Ciphertext
    agg, dec = secure.aggregate_encrypted, secure.decrypt_average

    def half_sum(ctx, cts):
        k = int(cts.c0.shape[0]) // 2
        return agg(ctx, Ciphertext(c0=cts.c0[:k], c1=cts.c1[:k], scale=cts.scale))

    def half_mean(ctx, sk, ct_sum, num_clients, *a, **kw):
        return dec(ctx, sk, ct_sum, num_clients // 2, *a, **kw)
    set_(secure, "aggregate_encrypted", half_sum)
    set_(secure, "decrypt_average", half_mean)


def _ciphertext_altered(set_):
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.ckks.ntt import plain_tables
    agg = secure.aggregate_encrypted

    def altered(ctx, cts):
        out = agg(ctx, cts)
        p = int(plain_tables(ctx.ntt, out.c0.device).p.reshape(-1)[0])
        out.c0[0, 0, 5] = (out.c0[0, 0, 5].to(torch.int64) + 12345) % p
        return out
    set_(secure, "aggregate_encrypted", altered)


def _answer_altered(set_):
    from hefl_tpu_torch.fl import fedavg
    real = fedavg.evaluate

    def altered(*a, **kw):
        res = dict(real(*a, **kw))
        res["accuracy"] = res["accuracy"] + (0.25 if res["accuracy"] < 0.5 else -0.25)
        return res
    set_(fedavg, "evaluate", altered)


def _no_exchange(set_):
    from hefl_tpu_torch.fl import secure
    set_(secure, "psum_ciphertext", lambda ctx, ct, mesh: ct)


def _adam_no_bias_correction(set_):
    from hefl_tpu_torch.fl import fusion
    real = fusion.adam_update

    def broken(grads, state, params, lr, decay, lr_scale, **kw):
        # Adam at a step so far on that 1 - b**t rounds to 1 in float32:
        # the moments go uncorrected, at this step's learning rate.
        t = state.step + 1
        far = dataclasses.replace(state, step=10 ** 7)
        new, st = real(grads, far, params, lr / (1.0 + decay * t), 0.0, lr_scale, **kw)
        return new, dataclasses.replace(st, step=t)
    set_(fusion, "adam_update", broken)


FAULTS = {"state_unchanged": _unchanged, "half_the_clients": _half, "half_the_batch": _half_batch,
          "ciphertext_altered": _ciphertext_altered, "answer_altered": _answer_altered,
          "adam_no_bias_correction": _adam_no_bias_correction}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(roots, workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    out = _run(roots[workload], workload)
    assert out["correct"] is False, out["checks"]


def faulty_rank_run(*args, fault: str, **kw):
    """A rank of the mesh rehearsal with `fault` planted in its process."""
    dict(FAULTS, no_exchange=_no_exchange)[fault](setattr)
    return harness.rank_run(*args, log=lambda m: None, **kw)


@pytest.mark.parametrize("fault", ["no_exchange", "state_unchanged", "half_the_clients",
                                   "half_the_batch", "answer_altered"])
def test_a_planted_fault_on_the_mesh_is_not_correct(roots, fault):
    out = harness.on_ranks(faulty_rank_run, 4, roots[MESH], MESH, SEED, 0.05, False, "cpu",
                           harness.process_start_time(), fault=fault)
    assert out["correct"] is False, out["checks"]


def jax_loading_rank_run(*args, rank: int, **kw):
    """A rank of the mesh rehearsal that loads a (stub) `jax` module."""
    if rank == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    return harness.rank_run(*args, rank=rank, log=lambda m: None, **kw)


def test_a_rank_that_loads_jax_fails_the_run(roots):
    with pytest.raises(RuntimeError, match=r"forbidden modules loaded, by rank: \{2: \['jax'\]\}"):
        harness.on_ranks(jax_loading_rank_run, 4, roots[MESH], MESH, SEED, 0.05, False, "cpu",
                         harness.process_start_time())


def _canned_trace():
    """A Chrome trace of one round: the training, HE and evaluation ranges
    each with a kernel launched inside, and an idle gap."""
    def x(cat, name, ts, dur, tid=1, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev
    events = [x("user_annotation", "bench.round", 1000, 1000)]
    for i, (phase, ts) in enumerate([("hefl.sgd_core", 1000), ("hefl.augment", 1200),
                                     ("hefl.encrypt", 1400), ("hefl.decrypt", 1600),
                                     ("hefl.evaluate", 1800)]):
        events += [x("user_annotation", phase, ts, 150),
                   x("cuda_runtime", "cudaLaunchKernel", ts + 10, 2, corr=i + 1),
                   x("kernel", f"k{i}", ts + 20, 40, tid=100, corr=i + 1)]
    return {"traceEvents": events}


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_rehearsal_reports_the_cells_per_layer_metrics(roots, workload, monkeypatch):
    """The --trace 1 path on the CPU, with the profiler's trace replaced by
    a canned one (the CPU has no device trace): every per-layer metric of
    the cell is read, with `device`'s busy and window and a breakdown."""
    from benchmark import tracing

    @contextlib.contextmanager
    def canned(path, device):
        yield None
        with open(path, "w") as f:
            json.dump(_canned_trace(), f)
    monkeypatch.setattr(tracing, "profiled", canned)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    root = roots[workload]
    out = harness.run(root, workload, SEED, 0.05, True, "cpu", log=lambda m: None)
    assert out["correct"] is True, out["checks"]
    cell = Cell(root, load(root), workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer()}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    assert out["breakdown"]["device_ops"]
    assert not [f for f in os.listdir(os.environ.get("TMPDIR", "/tmp"))
                if f.startswith(f"bench_trace_{os.getpid()}")]
