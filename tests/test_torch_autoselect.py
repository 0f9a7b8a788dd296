"""The persisted backend choice (`utils.autoselect`, `fl.fusion`'s "auto",
`ckks.backend`) against the JAX package's modules.

The winners' file has the JAX module's format: a file either package writes
is read by the other's reader. The fusion winner persists across two fresh
processes (the second reads it without probing). `resolve_he_backend`
follows the JAX priority and refuses a pin its device cannot run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hefl_tpu.ckks import backend as jbackend
from hefl_tpu.utils import autoselect as jautoselect

from hefl_tpu_torch.ckks import backend
from hefl_tpu_torch.fl import fusion
from hefl_tpu_torch.models import SmallCNN
from hefl_tpu_torch.obs import events, metrics
from hefl_tpu_torch.utils import autoselect

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """Persistence on, into a temporary directory (never the package's
    `_build/`)."""
    monkeypatch.setenv("HEFL_AUTOSELECT_CACHE", "1")
    monkeypatch.setattr(autoselect, "DEFAULT_DIR", tmp_path)
    return tmp_path


def test_store_then_load(cache_dir):
    assert autoselect.cache_file() == str(cache_dir / "hefl_autoselect.json")
    assert autoselect.load_winner("client_fusion", "NVIDIA H100 80GB HBM3") is None
    autoselect.store_winner("client_fusion", "NVIDIA H100 80GB HBM3", "fused",
                            {"fused": 1.5, "vmap": 3.25})
    autoselect.store_winner("client_fusion", "cpu", "vmap", {"fused": 9.0, "vmap": 2.0})
    autoselect.store_winner("he_backend", "cpu", "plain")
    assert autoselect.load_winner("client_fusion", "NVIDIA H100 80GB HBM3") == {
        "winner": "fused", "timings_ms": {"fused": 1.5, "vmap": 3.25}}
    assert autoselect.load_winner("client_fusion", "cpu")["winner"] == "vmap"
    assert autoselect.load_winner("he_backend", "cpu") == {"winner": "plain", "timings_ms": None}
    assert autoselect.load_winner("client_fusion", "another card") is None
    data = json.loads((cache_dir / "hefl_autoselect.json").read_text())
    assert set(data) == {"client_fusion", "he_backend"} and len(data["client_fusion"]) == 2
    assert not [p for p in os.listdir(cache_dir) if ".tmp." in p]


def test_allowed_filter_rejects_a_stale_winner(cache_dir):
    autoselect.store_winner("client_fusion", "cpu", "renamed_backend", {"renamed_backend": 1.0})
    assert autoselect.load_winner("client_fusion", "cpu", allowed=fusion.FUSION_BACKENDS) is None
    assert autoselect.load_winner("client_fusion", "cpu")["winner"] == "renamed_backend"


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", "", '{"client_fusion": 3}',
                                  '{"client_fusion": {"cpu": {"winner": 7}}}'],
                         ids=["truncated", "list", "empty", "decision_not_a_dict",
                              "winner_not_a_string"])
def test_corrupt_file_reads_as_empty(cache_dir, text):
    path = cache_dir / "hefl_autoselect.json"
    path.write_text(text)
    assert autoselect.load_winner("client_fusion", "cpu") is None
    # ...and the next store replaces it with a readable file.
    autoselect.store_winner("client_fusion", "cpu", "vmap")
    assert autoselect.load_winner("client_fusion", "cpu")["winner"] == "vmap"


def test_cache_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("HEFL_AUTOSELECT_CACHE", "0")
    monkeypatch.setattr(autoselect, "DEFAULT_DIR", tmp_path)
    assert autoselect.cache_file() is None
    autoselect.store_winner("client_fusion", "cpu", "vmap")
    assert autoselect.load_winner("client_fusion", "cpu") is None
    assert os.listdir(tmp_path) == []


def test_default_home_is_the_build_directory(monkeypatch):
    monkeypatch.setenv("HEFL_AUTOSELECT_CACHE", "1")
    assert Path(autoselect.cache_file()) == REPO / "hefl_tpu_torch" / "_build" / (
        "hefl_autoselect.json")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_file_is_the_jax_modules(cache_dir, monkeypatch, writer):
    # The JAX module's reader and writer, pointed at the same file (its own
    # location comes from the JAX compilation cache setting).
    path = str(cache_dir / "hefl_autoselect.json")
    monkeypatch.setattr(jautoselect, "_cache_file", lambda: path)
    monkeypatch.setattr(jautoselect, "_record_outcome", lambda *a, **k: None)
    timings = {"fused": 1.25, "vmap": 2.5}
    if writer == "port":
        autoselect.store_winner("client_fusion", "NVIDIA H100 80GB HBM3", "fused", timings)
        got = jautoselect.load_winner("client_fusion", "NVIDIA H100 80GB HBM3",
                                      allowed=("fused", "vmap"))
    else:
        jautoselect.store_winner("client_fusion", "NVIDIA H100 80GB HBM3", "fused", timings)
        got = autoselect.load_winner("client_fusion", "NVIDIA H100 80GB HBM3",
                                     allowed=fusion.FUSION_BACKENDS)
    assert got == {"winner": "fused", "timings_ms": timings}
    # Both write the same bytes for the same records.
    port_bytes = Path(path).read_bytes()
    Path(path).unlink()
    (autoselect if writer == "jax" else jautoselect).store_winner(
        "client_fusion", "NVIDIA H100 80GB HBM3", "fused", timings)
    assert Path(path).read_bytes() == port_bytes


def test_outcomes_reach_obs(cache_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("HEFL_EVENTS", "1")
    log = tmp_path / "events.jsonl"
    events.configure(str(log))
    base = metrics.snapshot()
    try:
        autoselect.store_winner("client_fusion", "cpu", "vmap", {"vmap": 1.0})
        autoselect.load_winner("client_fusion", "cpu")
        autoselect.load_winner("client_fusion", "cpu", allowed=("fused",))
    finally:
        events.configure(None)
    delta = metrics.snapshot_delta(base)
    assert delta.get("autoselect.probe") == 1 and delta.get("autoselect.cache") == 1
    rows = [e for e in events.read_events(str(log)) if e["event"] == "autoselect"]
    assert [(e["source"], e["winner"], e["decision"], e["device_kind"]) for e in rows] == [
        ("probe", "vmap", "client_fusion", "cpu"), ("cache", "vmap", "client_fusion", "cpu")]


@pytest.fixture
def fresh_fusion(monkeypatch):
    """The fusion module's in-process choice cleared for one test."""
    monkeypatch.setattr(fusion, "_AUTO_CHOICE", {})
    monkeypatch.setattr(fusion, "_AUTO_TIMINGS_MS", None)
    monkeypatch.setattr(fusion, "_AUTO_PERSISTED", False)
    monkeypatch.delenv("HEFL_CLIENT_FUSION", raising=False)


def test_fusion_auto_reads_a_persisted_winner_without_probing(cache_dir, fresh_fusion,
                                                              monkeypatch):
    autoselect.store_winner("client_fusion", "cpu", "fused", {"fused": 1.0, "vmap": 2.0})

    def no_probe(*a, **k):
        raise AssertionError("probed although a winner was persisted")

    monkeypatch.setattr(fusion, "_time_backend", no_probe)
    assert fusion.resolve_fusion_backend("auto", SmallCNN(), "cpu") == "fused"
    rep = fusion.fusion_report()
    assert rep["auto_persisted"] is True and rep["backend"] == "fused"
    assert rep["auto_timings_ms"] == {"fused": 1.0, "vmap": 2.0}


def test_fusion_auto_probes_and_persists_on_a_miss(cache_dir, fresh_fusion):
    winner = fusion.resolve_fusion_backend("auto", SmallCNN(), "cpu")
    rep = fusion.fusion_report()
    assert rep["auto_persisted"] is False and set(rep["auto_timings_ms"]) == {"fused", "vmap"}
    assert autoselect.load_winner("client_fusion", "cpu") == {
        "winner": winner, "timings_ms": rep["auto_timings_ms"]}


_PROCESS = """
import json, sys, time
from pathlib import Path
from hefl_tpu_torch.fl import fusion
from hefl_tpu_torch.models import SmallCNN
from hefl_tpu_torch.obs import metrics
from hefl_tpu_torch.utils import autoselect
autoselect.DEFAULT_DIR = Path(sys.argv[1])
t0 = time.perf_counter()
backend = fusion.resolve_fusion_backend("auto", SmallCNN(), "cpu")
seconds = time.perf_counter() - t0
snap = metrics.snapshot()
print(json.dumps({"backend": backend, "report": fusion.fusion_report(), "seconds": seconds,
                  "probe": snap.get("autoselect.probe", 0),
                  "cache": snap.get("autoselect.cache", 0)}))
"""


def test_fusion_winner_persists_across_two_processes(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "HEFL_CLIENT_FUSION"}
    env.update(HEFL_AUTOSELECT_CACHE="1", PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _PROCESS, str(tmp_path)], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert (first["probe"], first["cache"]) == (1, 0)
    assert first["report"]["auto_persisted"] is False
    assert (second["probe"], second["cache"]) == (0, 1)
    assert second["report"]["auto_persisted"] is True
    assert second["backend"] == first["backend"]
    assert second["report"]["auto_timings_ms"] == first["report"]["auto_timings_ms"]
    data = json.loads((tmp_path / "hefl_autoselect.json").read_text())
    assert data == {"client_fusion": {"cpu": {"winner": first["backend"],
                                              "timings_ms": first["report"]["auto_timings_ms"]}}}


# --- the HE backend -----------------------------------------------------------------


@pytest.mark.parametrize("env,override,device,want", [
    (None, None, "cpu", "plain"),
    (None, None, "cuda", "cuda"),
    ("auto", None, "cuda", "cuda"),
    ("plain", None, "cpu", "plain"),
    ("cuda", None, "cuda", "cuda"),
    ("cuda", "auto", "cpu", "plain"),
    ("plain", "cuda", "cuda", "cuda"),
], ids=["auto_cpu", "auto_card", "env_auto", "env_plain_cpu", "env_cuda_card",
        "override_beats_env", "override_pin_beats_env"])
def test_resolve_he_backend_priority(monkeypatch, env, override, device, want):
    if env is None:
        monkeypatch.delenv("HEFL_HE", raising=False)
    else:
        monkeypatch.setenv("HEFL_HE", env)
    assert backend.resolve_he_backend(None, torch.device(device), override) == want
    rep = backend.he_backend_report(torch.device(device), override)
    assert rep == {"requested": override or env or "auto", "backend": want,
                   "auto_timings_ms": None, "auto_persisted": False}
    # Pure: the report of a run without HE phases does not remember this one.
    assert backend.he_backend_report()["backend"] is None


@pytest.mark.parametrize("pin,device,match", [
    ("plain", "cuda", "'plain' cannot run on a cuda device"),
    ("cuda", "cpu", "'cuda' cannot run on a cpu device"),
    ("xla", "cpu", r"'xla': expected one of \('plain', 'cuda', 'auto'\)"),
    ("pallas", "cuda", r"'pallas': expected one of"),
])
@pytest.mark.parametrize("via", ["env", "override"])
def test_resolve_he_backend_refuses_what_the_device_cannot_run(monkeypatch, pin, device, match,
                                                               via):
    if via == "env":
        monkeypatch.setenv("HEFL_HE", pin)
        override = None
    else:
        monkeypatch.delenv("HEFL_HE", raising=False)
        override = pin
    with pytest.raises(ValueError, match=match):
        backend.resolve_he_backend(None, torch.device(device), override)
    with pytest.raises(ValueError, match=match):
        backend.he_backend_report(torch.device(device), override)


def test_he_backend_report_has_the_jax_keys():
    assert backend.he_backend_report().keys() == jbackend.he_backend_report().keys()
    assert set(backend.HE_BACKENDS) == {"plain", "cuda"}


def test_run_experiment_refuses_a_contradicting_pin(monkeypatch):
    from hefl_tpu_torch import experiment

    monkeypatch.setenv("HEFL_HE", "cuda")
    cfg = experiment.ExperimentConfig(model="smallcnn", dataset="mnist", n_train=16, n_test=4,
                                      he=experiment.HEConfig(n=256), events_path="")
    with pytest.raises(ValueError, match="'cuda' cannot run on a cpu device"):
        experiment.run_experiment(cfg, verbose=False, device="cpu")


def test_plaintext_run_records_no_he_backend(monkeypatch):
    # A run without HE phases checks no pin and reports backend None, as
    # the JAX driver's record of a plaintext run does.
    from hefl_tpu_torch import experiment

    monkeypatch.setenv("HEFL_HE", "cuda")
    cfg = experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", n_train=16, n_test=4, encrypted=False,
        train=experiment.TrainConfig(epochs=1, num_classes=10), events_path="")
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    assert out["he_backend"] == {"requested": "cuda", "backend": None, "auto_timings_ms": None,
                                 "auto_persisted": False}
