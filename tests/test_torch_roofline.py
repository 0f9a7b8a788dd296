"""The port's roofline accounting (`hefl_tpu_torch.utils.roofline`) held
against `hefl_tpu.utils.roofline`.

The shared functions (phase_stats, clamp_utilization, clamp_attribution,
backend_compare, train_flops_per_round, mfu) and the HE cost model
(he_phase_counts, he_roofline) equal the JAX module's on the same inputs
with a CPU device, exactly. The card's peaks come from its CUDA name (an
unknown card has none). `model_flops` counts MedCNN's and SmallCNN's conv
and matmul FLOPs exactly as the analytic count, and lies within [0.90,
1.00] of XLA's cost analysis of the same JAX model (which also counts the
elementwise ops). `run_experiment` fills the train row's flops and mfu.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.models import create_model as jcreate_model
from hefl_tpu.utils import roofline as jroofline

from hefl_tpu_torch import experiment
from hefl_tpu_torch.models import create_model
from hefl_tpu_torch.presets import PRESETS
from hefl_tpu_torch.utils import roofline

torch.set_num_threads(2)

H100 = "NVIDIA H100 80GB HBM3"
GEOMETRIES = [(4096, 3, 55, 2), (256, 3, 294, 8), (8192, 5, 13, 16)]


@pytest.mark.parametrize("n,num_limbs,n_ct,clients", GEOMETRIES)
def test_he_phase_counts_and_he_roofline_equal_jax(n, num_limbs, n_ct, clients):
    for phase in ("encrypt", "aggregate", "decrypt"):
        for c in (1, clients):
            kw = dict(n=n, num_limbs=num_limbs, n_ct=n_ct, num_clients=c)
            assert roofline.he_phase_counts(phase, **kw) == jroofline.he_phase_counts(phase, **kw)
    kw = dict(n=n, num_limbs=num_limbs, n_ct=n_ct, num_clients=clients, encrypt_clients=1)
    for secs in ({"encrypt": None, "aggregate": None, "decrypt": None},
                 {"encrypt": 0.012, "aggregate": 3e-4, "decrypt": 0.004},
                 {"encrypt": 1e-9, "aggregate": 0.5, "decrypt": None}):
        assert roofline.he_roofline(secs, device="cpu", **kw) == jroofline.he_roofline(
            secs, device="cpu", **kw)
        assert roofline.he_roofline(secs, **kw) == jroofline.he_roofline(secs, **kw)
    with pytest.raises(ValueError, match="unknown HE phase"):
        roofline.he_phase_counts("rotate", n=n, num_limbs=num_limbs, n_ct=n_ct)


@pytest.mark.parametrize("seconds,flops,images", [
    (1.5, 3.2e12, 1600), (0.3, None, 400), (None, 1e9, None), (1e-6, 1e12, 8), (2.0, 0.0, 0)])
def test_shared_roofline_functions_equal_jax(seconds, flops, images):
    for dev in ("cpu", None):
        assert roofline.phase_stats(seconds, flops, dev, images) == jroofline.phase_stats(
            seconds, flops, dev, images)
    assert roofline.mfu(flops, seconds, "cpu") == jroofline.mfu(flops, seconds, "cpu")
    assert roofline.train_flops_per_round(flops, 22, 10, 2) == jroofline.train_flops_per_round(
        flops, 22, 10, 2)
    by = {"vmap": seconds, "fused": 0.5}
    assert roofline.backend_compare(by, flops, "cpu", images) == jroofline.backend_compare(
        by, flops, "cpu", images)
    for v in (0.4, 1.0, 6.19, None):
        assert roofline.clamp_utilization({"u": v}, "u") == jroofline.clamp_utilization(
            {"u": v}, "u")
    raw = {"train": 1.2, "encrypt": -0.01 if flops else 0.3}
    assert roofline.clamp_attribution(raw) == jroofline.clamp_attribution(raw)
    assert roofline.peak_int_ops("cpu") == jroofline.peak_int_ops("cpu")
    assert roofline.peak_flops("cpu") == jroofline.peak_flops("cpu")


def test_card_peaks_by_cuda_name_and_none_for_an_unknown_card():
    assert roofline.peak_flops(H100) == (989.4e12, False)
    assert roofline.peak_int_ops(H100) == (roofline.ISSUE_OPS_PER_S, True)
    assert roofline.ISSUE_OPS_PER_S == 132 * 128 * 1.98e9
    for unknown in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert roofline.peak_flops(unknown) == (None, False)
        assert roofline.peak_int_ops(unknown) == (None, True)
        assert roofline.mfu(1e12, 1.0, unknown) is None
    assert roofline.device_kind(torch.device("cpu")) == "cpu"
    assert roofline.device_kind("cpu") == "cpu"
    assert roofline.peak_flops(torch.device("cpu")) == (roofline.CPU_PLACEHOLDER_FLOPS, True)
    rec = roofline.phase_stats(1.0, 4e14, H100, 100)
    assert rec["mfu"] == round(4e14 / 989.4e12, 5) and "peak_is_placeholder" not in rec
    he = roofline.he_phase_stats(1e-3, {"int_ops": 1e10, "bytes": 1e6}, device=H100)
    assert he["util_vs_peak_int_ops"] == round(1e13 / roofline.ISSUE_OPS_PER_S, 5)
    assert he["peak_is_estimate"] is True


def test_bound_takes_the_larger_of_bytes_and_pipe_rates():
    ms, by = roofline.bound(int(3.35e9), roofline.Ops())
    assert by == "bytes" and ms == pytest.approx(1.0)
    ops = roofline.Ops(mul=int(roofline.PIPE_OPS_PER_S), alu=0, add=0)
    ms, by = roofline.bound(0, ops)
    assert by == "operations" and ms == pytest.approx(1e3)
    ops = roofline.Ops(mul=10, alu=10, add=int(roofline.ISSUE_OPS_PER_S))
    assert roofline.bound(0, ops)[0] == pytest.approx(1e3, rel=1e-6)
    assert 2 * roofline.Ops(1, 2, 3) + roofline.Ops(1, 0, 0) == roofline.Ops(3, 4, 6)
    assert sum([roofline.Ops(1, 1, 1)] * 3) == roofline.Ops(3, 3, 3)


def test_steady_seconds_times_a_chain_below_the_floor():
    calls = []
    t = roofline.steady_seconds(lambda: calls.append(1), reps=2, warmup=1)
    assert 0.0 < t < roofline.TIMING_FLOOR_S
    assert len(calls) > 1 + 2 + 2 * 2          # warm-up, reps, then chains of >= 2


def _analytic_flops(features, dense, classes, hw, ch, batch):
    """2 a multiply-add: 3x3 VALID convs, then the dense stack."""
    flops, h, w, c = 0, hw, hw, ch
    for f in features:
        h, w = h - 2, w - 2
        flops += 2 * batch * h * w * f * c * 9
        h, w, c = h // 2, w // 2, f
    width = h * w * c
    for d in (*dense, classes):
        flops += 2 * batch * width * d
        width = d
    return flops


@pytest.mark.parametrize("name,batch,hw,ch,features,dense,classes", [
    ("medcnn", 32, 256, 3, (32, 32, 32, 64, 64, 128), (128, 64), 2),
    ("smallcnn", 8, 28, 1, (32, 64), (128,), 10),
])
def test_model_flops_equal_the_analytic_count_and_track_xla(name, batch, hw, ch, features, dense,
                                                            classes):
    model = create_model(name, device="cpu")
    got = roofline.model_flops(model, (batch, hw, hw, ch))
    assert got == _analytic_flops(features, dense, classes, hw, ch, batch)
    module, params = jcreate_model(name, rng=jax.random.key(0))
    want = jroofline.program_flops(lambda p, xb: module.apply({"params": p}, xb), params,
                                   jnp.zeros((batch, hw, hw, ch), jnp.float32))
    assert want is not None and 0.90 <= got / want <= 1.00
    assert roofline.model_flops(model, (0, hw, hw, ch)) is None
    assert all(not p.is_meta for p in model.parameters())     # the model itself is untouched


def test_run_experiment_fills_the_train_rows_flops_and_mfu():
    out = experiment.run_experiment(PRESETS["hhe-smoke"], device="cpu")
    model = create_model("smallcnn", device="cpu")
    for rec in out["history"]:
        rows = rec["phase_roofline"]
        train = rows["train+encrypt+aggregate"]
        assert train["flops"] > 0 and train["mfu"] > 0 and train["peak_is_placeholder"]
        # As the JAX driver: decrypt and evaluate carry no FLOP count.
        assert rows["decrypt"]["flops"] is None and rows["evaluate"]["flops"] is None
        assert rows["evaluate"]["images_per_s"] > 0
    cfg = PRESETS["hhe-smoke"]
    per_client = cfg.n_train // cfg.num_clients
    _, grp, steps = experiment.train_batch_geometry(cfg.train, per_client)
    fwd = roofline.model_flops(model, (grp, 28, 28, 1))
    want = 3.0 * fwd * steps * cfg.train.epochs * cfg.num_clients
    assert out["history"][0]["phase_roofline"]["train+encrypt+aggregate"]["flops"] == want
    assert np.isfinite(want)
