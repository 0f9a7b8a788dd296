"""The controls and the planted faults of `harness.calibration` come out
not correct under the cell's limits, at a size a test run holds: on the
CPU at the rehearsal's tiny shapes, and on a card (marked `cuda`)."""

import shutil

import pytest
import torch

from benchmark import compare, harness, rehearse

CELLS = ["medcnn-medical.fedavg32", "resnet20-cifar10.fedavg16"]


def _readings(workload, device, tmp_path):
    root = rehearse.tiny_root(workload, str(tmp_path))
    try:
        return harness.calibration(root, workload, [3], device, control=1, faults=1,
                                   log=lambda m: None)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _check(rows):
    ok = {r["kind"]: compare.judge(r, rehearse.TINY_LIMITS)[0] for r in rows}
    assert ok["system"] is True
    # the float8 training control and the bfloat16 aggregation control are
    # one control, each in its stage's place: together they fail
    assert not (ok["control_fp8"] and ok["control_agg_bf16"])
    # (answers altered is left out here: a tiny model predicts one class,
    # so scoring it against other labels changes nothing; the rehearsal
    # test alters the system's answer instead)
    for kind in ("fault_half_clients", "fault_unchanged", "fault_half_batch"):
        assert ok[kind] is False, kind


@pytest.mark.parametrize("workload", CELLS)
def test_controls_and_faults_fail_on_the_cpu(workload, tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    _check(_readings(workload, "cpu", tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_controls_and_faults_fail_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check(_readings(workload, "cuda", tmp_path))


@pytest.mark.parametrize("workload", CELLS)
def test_adam_without_bias_correction_fails_on_the_cpu(workload, tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    root = rehearse.tiny_root(workload, str(tmp_path))
    try:
        rows = harness.adam_fault_readings(root, workload, [3], "cpu", log=lambda m: None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    limits = {"compared": {k: rehearse.TINY_LIMITS["compared"][k]
                           for k in ("grad1_median_gap", "update1_gap")}}
    ok = {r["kind"]: compare.judge(r, limits)[0] for r in rows}
    assert set(ok) == {"fault_adam_" + f for f in harness.ADAM_FAULTS}
    assert ok["fault_adam_no_bias_correction"] is False
