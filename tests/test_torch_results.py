"""The port's quality sweep (`hefl_tpu_torch.results`) against the root
`results.py` (the JAX package's): the same preset and convergence tables
row for row on the same records (the device cell aside: the port's names
the card and its power limit), the same merge and load rules, the same
record keys plus power_limit, the same nine convergence configs; and the
evidence rules of `tests/test_results.py` that apply to the port's own
artifacts (RESULTS_TORCH.json / .md, flagship_acc_torch_*.json,
BENCH_TORCH*.json, BENCH_TORCH_NTT.json).

The root script is loaded by path; only its pure functions run, in a
temporary working directory, and its `_measure` on a tiny plaintext config
(which never reaches the JAX pre-flight certifiers broken on JAX 0.9).
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import pytest

from hefl_tpu.presets import PRESETS as JPRESETS

from hefl_tpu_torch import results
from hefl_tpu_torch.presets import PRESETS

_spec = importlib.util.spec_from_file_location(
    "jax_results", Path(__file__).resolve().parent.parent / "results.py")
jresults = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jresults)

CARD = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "power_limit": "700.00 W"}


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _record(name, **kw):
    rec = {"preset": name, "label": results.PRESET_LABELS.get(name, name), "device": CARD,
           "power_limit": "700.00 W", "model": "smallcnn", "dataset": "mnist",
           "num_clients": 2, "encrypted": True, "partition": "iid", "prox_mu": 0.0,
           "rounds": 3, "seed": 0, "wallclock_s": 12.5, "cold_round_s": 5.1,
           "warm_round_s": 3.2, "rounds_per_sec_per_chip": 0.3125, "accuracy": 0.9,
           "precision": 0.91, "recall": 0.9, "f1": 0.9, "accuracy_by_round": [0.5, 0.8, 0.9],
           "encode_overflow_total": 0}
    rec.update(kw)
    return rec


def _as_jax(rec):
    """The same record in the JAX script's schema: device a name, no
    power_limit."""
    out = {k: v for k, v in rec.items() if k != "power_limit"}
    out["device"] = rec["device"]["kind"]
    return out


def _rows(md):
    """The table rows (header rows included) without their device cell."""
    out = []
    for line in md.splitlines():
        if line.startswith("|"):
            cells = line.split("|")
            out.append(cells[:2] + cells[3:])
    return out


def _data():
    presets = [_record("mnist-plain", encrypted=False),
               _record("medical-skew", prox_mu=0.01, num_clients=8, warm_round_s=None,
                       rounds_per_sec_per_chip=None, rounds=1, accuracy_by_round=[0.6]),
               _record("cifar-resnet16", num_clients=16)]
    conv = [_record("mnist-enc-dp-10r", label="dp row", rounds=10, dp_epsilon_final=20.175,
                    accuracy_by_round=[0.1] * 10),
            _record("mnist-enc-10r", label="plain row", rounds=10)]
    return {"presets": presets, "convergence": conv}


def test_tables_are_the_jax_tables_row_for_row(in_tmp):
    data = _data()
    jdata = {k: [_as_jax(r) for r in v] for k, v in data.items()}
    md, jmd = results.write_markdown(data), jresults.write_markdown(jdata)
    assert _rows(md) == _rows(jmd) and len(_rows(md)) == 2 * 2 + 3 + 2
    acc = [line for line in md.splitlines() if line.startswith("Accuracy by round")]
    assert acc == [line for line in jmd.splitlines() if line.startswith("Accuracy by round")]
    # the device cells name the card and its power limit
    for line in md.splitlines():
        if line.startswith("| ") and not line.startswith("| config"):
            assert line.split("|")[2].strip() == "NVIDIA H100 80GB HBM3 (700.00 W)"
    assert "Device: 1x NVIDIA H100 80GB HBM3 (700.00 W)" in md
    assert "RESULTS.md and RESULTS.json are the JAX package's" in md


def test_error_records_stay_out_of_the_tables(in_tmp):
    data = {"presets": [_record("mnist-enc"), {"preset": "medical-8", "error": "boom"}],
            "convergence": [{"preset": "x", "error": "boom"}]}
    md = results.write_markdown(data)
    assert "boom" not in md and "Convergence" not in md and "2. 2-client" in md


@pytest.mark.parametrize("old,new", [
    ([{"preset": "a", "accuracy": 0.9}, {"preset": "b", "accuracy": 0.8}],
     [{"preset": "a", "error": "boom"}, {"preset": "c", "accuracy": 0.7}]),
    ([{"preset": "a", "accuracy": 0.9}], [{"preset": "a", "accuracy": 0.95}]),
    ([{"preset": "a", "error": "x"}], [{"preset": "a", "error": "y"}]),
    ([], [{"preset": "a", "error": "y"}, {"preset": "b", "accuracy": 0.1}]),
])
def test_merge_records_is_the_jax_merge(old, new):
    assert results._merge_records(old, new) == jresults._merge_records(old, new)


def test_merge_presets_keeps_the_baseline_order():
    data = {"presets": [{"preset": "zzz", "accuracy": 0.1}, {"preset": "mnist-enc"}]}
    jdata = json.loads(json.dumps(data))
    new = [{"preset": "mnist-plain", "accuracy": 0.5}]
    results._merge_presets(data, new)
    jresults._merge_presets(jdata, new)
    assert data == jdata
    assert [r["preset"] for r in data["presets"]] == ["mnist-plain", "mnist-enc", "zzz"]


@pytest.mark.parametrize("content", [None, "{truncated", json.dumps([{"preset": "a"}]),
                                     json.dumps({"presets": [{"preset": "b"}]}),
                                     json.dumps({"convergence": []})])
def test_load_results_is_the_jax_loader(in_tmp, content):
    if content is not None:
        (in_tmp / "RESULTS_TORCH.json").write_text(content)
        (in_tmp / "RESULTS.json").write_text(content)
    assert results.load_results() == jresults.load_results()


def test_measure_has_the_jax_keys_plus_power_limit(in_tmp):
    tcfg = dataclasses.replace(PRESETS["mnist-plain"], rounds=1, n_train=32, n_test=8,
                               train=dataclasses.replace(PRESETS["mnist-plain"].train, epochs=1))
    jcfg = dataclasses.replace(JPRESETS["mnist-plain"], rounds=1, n_train=32, n_test=8,
                               train=dataclasses.replace(JPRESETS["mnist-plain"].train,
                                                         epochs=1))
    got = results._measure("mnist-plain", "x", tcfg, "cpu")
    want = jresults._measure("mnist-plain", "x", jcfg)
    assert set(got) == set(want) | {"power_limit"}
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    assert got["encode_overflow_total"] == want["encode_overflow_total"] == 0
    assert got["warm_round_s"] is None and got["rounds_per_sec_per_chip"] is None
    assert len(got["accuracy_by_round"]) == 1


def test_convergence_configs_are_the_jax_nine():
    got, want = results.convergence_configs(), jresults.convergence_configs()
    assert list(got) == list(want)
    for name in want:
        (tlabel, tcfg), (jlabel, jcfg) = got[name], want[name]
        assert tlabel == jlabel
        for field in ("model", "dataset", "num_clients", "rounds", "encrypted", "n_train",
                      "n_test", "seed", "partition", "centralized"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
        for field in ("epochs", "batch_size", "lr", "augment", "warmup_steps", "num_classes",
                      "prox_mu"):
            assert getattr(tcfg.train, field) == getattr(jcfg.train, field), (name, field)
        assert (tcfg.he.n, tcfg.he.num_primes) == (jcfg.he.n, jcfg.he.num_primes)
        assert (tcfg.dp is None) == (jcfg.dp is None)
        if jcfg.dp is not None:
            assert (tcfg.dp.clip_norm, tcfg.dp.noise_multiplier, tcfg.dp.delta) == (
                jcfg.dp.clip_norm, jcfg.dp.noise_multiplier, jcfg.dp.delta)


def test_unknown_convergence_name_fails_before_any_device_work(in_tmp, monkeypatch):
    import hefl_tpu_torch

    def no_device(*a, **k):
        raise AssertionError("a device was resolved")

    monkeypatch.setattr(hefl_tpu_torch, "resolve_device", no_device)
    with pytest.raises(SystemExit) as e:
        results.run_convergence(["definitely-not-a-config"])
    assert "available" in str(e.value)
    with pytest.raises(SystemExit, match="available"):
        results.main(["--device", "cpu", "no-such-preset"])
    assert not os.listdir(in_tmp)


def test_main_writes_the_port_files_only(in_tmp, monkeypatch):
    monkeypatch.setitem(PRESETS, "mnist-plain", dataclasses.replace(
        PRESETS["mnist-plain"], n_train=32, n_test=8))
    real = results.run_preset
    monkeypatch.setattr(results, "run_preset",
                        lambda name, device=None: real(name, rounds=2, epochs=1, device=device))
    assert results.main(["--device", "cpu", "mnist-plain"]) == 0
    assert sorted(os.listdir(in_tmp)) == ["RESULTS_TORCH.json", "RESULTS_TORCH.md"]
    data = json.loads((in_tmp / "RESULTS_TORCH.json").read_text())
    rec = data["presets"][0]
    assert set(rec) == set(_record("x")) and rec["power_limit"] is None
    assert rec["rounds"] == 2 and len(rec["accuracy_by_round"]) == 2
    assert rec["warm_round_s"] is not None and data["convergence"] == []
    md = (in_tmp / "RESULTS_TORCH.md").read_text()
    assert "1. 2-client plaintext FedAvg" in md and "| cpu |" in md
    # --render re-renders the markdown from disk and rewrites no evidence
    (in_tmp / "RESULTS_TORCH.md").unlink()
    before = (in_tmp / "RESULTS_TORCH.json").read_text()
    assert results.main(["--render"]) == 0
    assert (in_tmp / "RESULTS_TORCH.md").read_text() == md
    assert (in_tmp / "RESULTS_TORCH.json").read_text() == before


def test_a_render_failure_keeps_the_json(in_tmp, monkeypatch):
    def boom(data):
        raise RuntimeError("render bug")

    monkeypatch.setattr(results, "write_markdown", boom)
    results._write_evidence({"presets": [_record("a")], "convergence": []}, md_fatal=False)
    assert json.loads((in_tmp / "RESULTS_TORCH.json").read_text())["presets"][0]["preset"] == "a"
    assert not (in_tmp / "RESULTS_TORCH.md").exists()
    with pytest.raises(RuntimeError, match="render bug"):
        results._write_evidence({"presets": [], "convergence": []})


# ---- the port's artifacts -----------------------------------------------------------


def _write(path, rec):
    Path(path).write_text(json.dumps(rec, indent=2))


def test_flagship_runs_fold_into_markdown_smoke_and_corrupt_skipped(in_tmp):
    _write("flagship_acc_torch_0.json",
           {"task": "flagship_accuracy", "seed": 0, "device": CARD["kind"],
            "power_limit": "700.00 W", "local_epochs": 10, "epochs_run": 10, "accuracy": 0.645,
            "precision": 0.79, "recall": 0.645, "f1": 0.59, "acc_vs_reference": -0.1975,
            "wallclock_s_total": 4.69})
    _write("flagship_acc_torch_smoke_0.json", {"task": "flagship_accuracy", "smoke": True})
    (in_tmp / "flagship_acc_torch_1.json").write_text("{truncated")
    # the JAX runs' artifacts are never read
    _write("flagship_acc_0.json", {"seed": 0, "accuracy": 0.96, "device": "cpu"})
    runs = results.load_flagship_runs()
    assert [r["_seed_file"] for r in runs] == ["flagship_acc_torch_0.json"]
    md = results.write_markdown({"presets": [], "convergence": []})
    assert "| flagship_acc_torch_0.json | NVIDIA H100 80GB HBM3 (700.00 W) | 10/10 | 0.645" in md
    assert "smoke" not in md and "flagship_acc_0.json" not in md


def test_bench_runs_and_kernels_render_from_the_card_only(in_tmp):
    _write("BENCH_TORCH.json", {"value": 4.442, "steady_round_s": 3.428,
                                "rounds_per_sec_per_chip": 0.2917,
                                "accuracy_by_round": [0.75], "enc_plain_max_abs_diff": 6.8e-7,
                                "encode_overflow_count": 0, "device": CARD})
    _write("BENCH_TORCH_r02.json", {"smoke": True, "device": CARD})
    (in_tmp / "BENCH_TORCH_r03.json").write_text("{")
    _write("seeds_0.json", {"seed": 0, "device": "TPU v5 lite", "value": 90.0})
    _write("BENCH_TORCH_NTT.json", {"device": CARD, "parity": "bitwise", "timing_method": "t",
                                    "kernels": [{"name": "ntt_forward", "replaces": "p.py:413",
                                                 "shape": [55, 3, 4096], "ms": 0.0085,
                                                 "plain_ms": 6.5, "bound_ms": 0.0016,
                                                 "bound_by": "bytes"}]})
    assert [r["_seed_file"] for r in results.load_bench_runs()] == ["BENCH_TORCH.json"]
    md = results.write_markdown({"presets": [], "convergence": []})
    assert "| BENCH_TORCH.json | NVIDIA H100 80GB HBM3 (700.00 W) | 4.442 | 3.428" in md
    assert "| ntt_forward | p.py:413 | [55, 3, 4096] | 0.0085 | 6.5 | 0.0016 (bytes) |" in md
    assert "TPU v5 lite" not in md and "(no measured records)" not in md
    _write("BENCH_TORCH_NTT.json", {"device": {"platform": "cpu", "kind": "cpu"},
                                    "kernels": [{"name": "ntt_forward"}]})
    assert results.load_ntt_bench() is None
    assert "## Kernels" not in results.write_markdown({"presets": [], "convergence": []})


def test_render_reports_measured_devices_not_the_render_host(in_tmp):
    md = results.write_markdown({"presets": [], "convergence": []})
    assert "(no measured records)" in md
    md = results.write_markdown({"presets": [_record("mnist-enc")], "convergence": []})
    assert "Device: 1x NVIDIA H100 80GB HBM3 (700.00 W)" in md
