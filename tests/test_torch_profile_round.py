"""`hefl_tpu_torch.profile_round`, the port of the root profile_round.py.

The smoke configuration (mnist, 32 train images, SmallCNN, 1 epoch, N = 256)
on the CPU, traced: the record has the root harness's keys that the port
fills, `attribution_source` is "trace", and a trace that cannot be
attributed fails the run instead of falling back to the ablation. The
cohort comparison (`fl.stream.cohort_compare_smoke_record`, held to the JAX
package in tests/test_torch_bench.py) is stubbed to keep the run short.
"""

import json

import pytest
import torch

from hefl_tpu_torch import profile_round
from hefl_tpu_torch.fl import stream
from hefl_tpu_torch.obs import trace

# The root harness's `att` keys (profile_round.py) the port fills, one
# augment row per row-shift backend among them.
PART_D_KEYS = (
    "attribution_source", "trace_attribution", "full_round_s", "train_s", "he_in_round_s",
    "augment_s", "per_epoch_val_s", "sgd_core_s", "he_in_round_s_raw", "augment_s_raw",
    "per_epoch_val_s_raw", "sgd_core_s_raw", "attribution_unreliable", "standalone_encrypt_s",
    "standalone_aggregate_s", "decrypt_s", "decrypt_core_s", "evaluate_s", "augment_gather_ms",
    "augment_fft_ms", "augment_dft_ms", "augment_backend", "client_fusion",
    "client_fusion_compare", "phase_roofline", "he_backend", "he_roofline", "packing", "bytes_on_wire", "cohort_compare", "obs_metrics",
    "device",
)
COHORT = {"cohort_size": 2, "num_clients": 16, "bucket": 2, "full_c_train_s": 1.0,
          "cohort_train_s": 0.5, "speedup": 2.0, "bitwise_equal": True}


@pytest.fixture
def stub_cohort(monkeypatch):
    monkeypatch.setattr(stream, "cohort_compare_smoke_record", lambda device=None: dict(COHORT))


def test_smoke_main_prints_tables_and_the_traced_record(tmp_path, stub_cohort, capsys,
                                                        monkeypatch):
    prof = str(tmp_path / "trace")
    record = profile_round.run(device="cpu", profile=prof, smoke=True, reps=1)
    calls = []

    def traced_run(*args, **kwargs):
        calls.append((args, kwargs))
        return record

    # main at its defaults, on the record of one run at one repetition.
    monkeypatch.setattr(profile_round, "run", traced_run)
    assert profile_round.main(["--smoke", "--device", "cpu", "--profile", prof]) == 0
    assert calls == [(("cpu",), {"profile": prof, "smoke": True})]
    out = capsys.readouterr().out.splitlines()
    att = json.loads(out[-1])
    assert att["metric"] == "phase_attribution"
    assert set(profile_round.RECORD_KEYS) == set(PART_D_KEYS)
    for key in PART_D_KEYS:
        assert key in att, key
    assert att["attribution_source"] == "trace"
    tr = att["trace_attribution"]
    assert tr["round_module"] == "hefl.phase.train+encrypt+aggregate"
    assert set(tr["wall_s"]) == {"round", "decrypt", "evaluate", "total"}
    assert tr["device_events"] == "cpu_op"
    for phase in ("hefl.sgd_core", "hefl.augment", "hefl.val", "hefl.encrypt",
                  "hefl.psum_aggregate", "hefl.decrypt", "hefl.evaluate"):
        assert tr["rows"][phase]["device_seconds"] > 0, phase
    assert 0 < tr["round_wall_agreement"] <= 1.02
    assert tr["attributed_sum_s"] == pytest.approx(tr["device_total_s"], abs=1e-6)
    assert set(att["phase_roofline"]) == {"fused_round", "train_only", "decrypt", "evaluate"}
    assert att["he_backend"]["backend"] == "plain"
    assert att["packing"]["n_ct"] * 4 == att["packing"]["n_ct_unpacked"] == 880
    assert att["device"]["platform"] == "cpu"
    assert att["cohort_compare"] == COHORT
    text = "\n".join(out[:-1])
    assert "| phase (trace) |" in text and "| hefl.encrypt |" in text
    assert "Ablation cross-check" in text and "| packing (b=8, k=4) |" in text


def test_untraced_run_reports_the_ablation(stub_cohort):
    att = profile_round.run(device="cpu", smoke=True, reps=1)
    assert att["attribution_source"] == "ablation"
    assert "trace_attribution" not in att
    assert att["full_round_s"] > 0 and att["epochs"] == 1


def test_a_trace_that_cannot_be_attributed_fails_the_run(tmp_path, stub_cohort, monkeypatch):
    def unusable(_):
        raise trace.TraceParseError("no device ops")

    monkeypatch.setattr(trace, "trace_attribution", unusable)
    with pytest.raises(trace.TraceParseError):
        profile_round.run(device="cpu", smoke=True, profile=str(tmp_path), reps=1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_runs_on_cuda_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_round.run(smoke=True)
