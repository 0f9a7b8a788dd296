"""The port's serving benchmark writer (`hefl_tpu_torch.bench_inference`)
at the smoke geometry on the CPU: its artifact passes the repository's
serving gates and carries the root bench's rows and blocks."""

import json

import pytest
import torch

from hefl_tpu_torch import bench_inference

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("infer") / "BENCH_TORCH_INFER.json"
    assert bench_inference._main(["--smoke", "--device", "cpu", "--reps", "3",
                                  "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_smoke_artifact_passes_the_gates(artifact):
    assert artifact["gates"] == []
    assert bench_inference.gate_failures(artifact) == []
    assert artifact["smoke"] is True and artifact["backend"] == "cpu"
    assert artifact["device"]["platform"] == "cpu"
    assert artifact["he_backend"]["backend"] == "plain"


def test_smoke_artifact_schema(artifact):
    assert set(artifact) >= {"artifact", "device", "backend", "smoke", "reps", "rows",
                             "batched_vs_single", "hoisted", "mlp_compare", "analysis_check",
                             "he_backend"}
    plans = [r["plan"] for r in artifact["rows"]]
    assert plans == ["ladder", "bsgs", "bsgs_hoisted", "bsgs_unhoisted", "bsgs", "mlp", "mlp",
                     "mlp_bsgs"]
    ladder = artifact["rows"][0]
    assert ladder["keyswitches_per_score"] == 10 * 7           # K x log2(128 slots)
    assert all(r["max_abs_err"] < 0.05 for r in artifact["rows"])
    assert artifact["analysis_check"]["violations"] == 0
    assert len(artifact["analysis_check"]["certified"]) == 4
    # The root bench's hoisted block, key for key: the twin's products run
    # through a kernel on a card, so no note qualifies the speedup.
    assert set(artifact["hoisted"]) == {
        "plan", "baby", "hoisted_qps", "unhoisted_qps", "speedup", "hoisted_ntts_per_score",
        "unhoisted_ntts_per_score", "parity_sha_hoisted", "parity_sha_unhoisted", "parity"}
    mlp = artifact["mlp_compare"]
    assert mlp["ladder_keyswitches_per_score"] == 4 * 8 + 4    # H x log2(256 slots) + H


def test_gate_failures_name_what_broke(artifact):
    broken = json.loads(json.dumps(artifact))
    broken["hoisted"]["parity"] = False
    broken["rows"][0]["argmax_ok"] = False
    broken["batched_vs_single"]["speedup"] = 1.0
    fails = bench_inference.gate_failures(broken)
    assert any("parity" in f for f in fails)
    assert any("argmax_ok" in f for f in fails)
    assert any("batched-vs-single" in f for f in fails)
