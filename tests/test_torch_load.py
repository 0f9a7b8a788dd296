"""The port's BENCH_LOAD writer (`hefl_tpu_torch.fl.load`) held against the
JAX package and its committed BENCH_LOAD.json.

`commit_latency_sweep` is virtual time over the deterministic trace, so on
BENCH_LOAD.json's own `config` it must reproduce that file's block exactly;
`gather_record`'s bucket and cohort fields are the JAX record's; a tiny
`bench_load_record` passes its gates with the artifact's schema, its journal
and sum shas the JAX package's `drive_trace`'s on the same trace; `_main`
writes BENCH_TORCH_LOAD.json by default, with the device it ran on.
"""

import json
from pathlib import Path

import pytest
import torch

from hefl_tpu.fl import load as jload

from hefl_tpu_torch.fl import load

REPO = Path(__file__).resolve().parent.parent
BENCH = json.loads((REPO / "BENCH_LOAD.json").read_text())["bench_load"]
TINY = dict(num_clients=1_000, rounds=2, cohort_size=64, duplicate_clients=16,
            stale_replays=8, seed=3)


def test_commit_latency_sweep_reproduces_bench_load_json():
    cfg = load.LoadConfig(**BENCH["config"])
    assert load.commit_latency_sweep(cfg) == BENCH["commit_latency_sweep"]


@pytest.mark.parametrize("points", [((64, 0.5), (64, 0.9), (128, 0.75)), ((32, 1.0),)])
def test_commit_latency_sweep_equals_jax(points):
    got = load.commit_latency_sweep(load.LoadConfig(**TINY), points=points, rounds=3)
    want = jload.commit_latency_sweep(jload.LoadConfig(**TINY), points=points, rounds=3)
    assert got == want
    assert got["ok"] is (len(points) >= 3)


def test_gather_record_fields_equal_jax_and_bench_load_json():
    strip = lambda rows: [{k: v for k, v in r.items() if k != "gather_seconds"}  # noqa: E731
                          for r in rows]
    got = load.gather_record(registry_sizes=(1_000, 10_000, 100_000), cohort_size=512)
    want = jload.gather_record(registry_sizes=(1_000, 10_000, 100_000), cohort_size=512)
    assert strip(got) == strip(want)
    assert [r["bucket"] for r in got] == [512, 512, 512]
    cfg = BENCH["config"]
    assert strip(load.gather_record(sorted({10_000, cfg["num_clients"]}), cfg["cohort_size"],
                                    cfg["seed"])) == strip(BENCH["gather"])


def test_bench_load_record_tiny_gates_schema_and_jax_shas(tmp_path):
    rec = load.bench_load_record(load.LoadConfig(**TINY), workdir=str(tmp_path), device="cpu")
    # `ok` is every gate; the b = 4 fold's ingest rate against b = 8's is a
    # host-clock reading the record reports beside its floor, not a gate.
    ef = rec["ef_packing"]
    assert rec["ok"] is True
    assert ef["bytes_ratio_ok"] and ef["certified"]
    assert isinstance(ef["fold_ratio_ok"], bool) and ef["fold_ratio_floor"] == 1.5
    assert rec["fold_throughput"]["sha_equal"]
    assert set(rec) >= {"config", "row_shape", "device", "runs", "group_commit", "batched_fold",
                        "dedup", "fold_throughput", "recovery", "gather", "ef_packing", "ok"}
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    assert set(rec["runs"]) == {"always", "commit_grouped", "commit_unbatched",
                                "commit_grouped_batchfold"}
    want = jload.drive_trace(jload.LoadConfig(**TINY), str(tmp_path / "jax.jl"), "commit")
    for run in rec["runs"].values():
        assert run["sum_sha"] == want["sum_sha"]
        assert run["journal_bytes_sha"] == want["journal_bytes_sha"]
    assert rec["group_commit"]["sha_equal"] and rec["batched_fold"]["sha_equal"]
    assert rec["group_commit"]["fsync_ratio"] <= 0.1
    assert rec["dedup"]["peak"] <= rec["dedup"]["bound"]


@pytest.mark.parametrize("fold_batched", [False, True])
def test_drive_trace_on_a_device_keeps_the_shas(tmp_path, fold_batched):
    # The port folds on a device, the JAX package on the host: the same
    # journal bytes and released sum either way.
    dev = load.drive_trace(load.LoadConfig(**TINY), str(tmp_path / "b.jl"), "never",
                           fold_batched=fold_batched, device="cpu")
    host = jload.drive_trace(jload.LoadConfig(**TINY), str(tmp_path / "a.jl"), "never",
                             fold_batched=fold_batched)
    assert (dev["sum_sha"], dev["journal_bytes_sha"]) == (host["sum_sha"],
                                                          host["journal_bytes_sha"])
    assert (dev["folds"], dev["dedup_hits"]) == (host["folds"], host["dedup_hits"])


def test_load_writers_default_to_cuda(tmp_path, monkeypatch):
    # With no device named the trace's folds run on the card: without one
    # they raise instead of folding on the host.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load.drive_trace(load.LoadConfig(**TINY), str(tmp_path / "j.jl"), "never")
    with pytest.raises(RuntimeError, match="CUDA"):
        load.bench_load_record(load.LoadConfig(**TINY), workdir=str(tmp_path))


def test_main_writes_bench_torch_load(tmp_path, monkeypatch):
    monkeypatch.setattr(load, "LoadConfig", type("Tiny", (load.LoadConfig,), {
        "smoke": classmethod(lambda cls: load.LoadConfig(**TINY))}))
    monkeypatch.chdir(tmp_path)
    rc = load._main(["--smoke", "--sweep", "--device", "cpu"])
    art = json.loads((tmp_path / "BENCH_TORCH_LOAD.json").read_text())
    assert rc == (0 if art["bench_load"]["ok"] else 1)
    assert art["bench_load"]["commit_latency_sweep"]["ok"] is True
    assert art["bench_load"]["commit_latency_sweep"]["num_points"] == 4
    assert art["bench_load"]["device"]["platform"] == "cpu"
    assert "journal.appends" in art["metrics"]
