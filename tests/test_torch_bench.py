"""The headline benchmark's pieces (flagship setup, `encrypt_params`,
`encrypt_params_packed`, the cohort comparison, `bench`, `bench_ntt`) and
the unhoisted twin's step products, on the CPU.

`encrypt_params` and `encrypt_params_packed` are held BITWISE against the
JAX package's on the same SmallCNN weights (`convert.from_flax`), keys and
JAX-drawn encryption samples at N = 1024 (the JAX `PackedSpec` built with
its dataclass constructor, as `test_torch_packing.py` does). The cohort
comparison's two producers fold to the same sum. The bench's smoke run
carries the root bench's keys, decrypts within the 5e-6 yardstick and fills
every roofline row; its HE rows count what the JAX cost model counts. The
kernel bench's CPU artifact covers K1-K7 on the plain versions and exits 42
on a mismatch.
"""

import json

import numpy as np
import jax
import pytest
import torch

from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks import packing as jpack
from hefl_tpu.ckks import quantize as jq
from hefl_tpu.fl import secure as jsecure
from hefl_tpu.models import create_model as jcreate_model
from hefl_tpu.utils import roofline as jroofline

from hefl_tpu_torch import bench, bench_ntt, convert, flagship, he_inference as hei
from hefl_tpu_torch.ckks import cuda_ntt, keys, ops, packing, quantize
from hefl_tpu_torch.fl import hierarchy, secure, stream

torch.set_num_threads(2)

# The root bench's artifact keys (its smoke run adds "smoke").
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "rounds", "warm_round_s", "steady_round_s",
    "rounds_per_sec_per_chip", "train_mfu", "phase_roofline", "augment_backend",
    "client_fusion", "client_fusion_compare", "he_backend", "he_roofline", "packing",
    "bytes_on_wire", "cohort_compare", "dcn_compare", "device", "seed", "accuracy",
    "accuracy_by_round", "acc_vs_reference", "plaintext_round_s", "enc_plain_max_abs_diff",
    "enc_plain_max_abs_diff_exact_decode", "encode_overflow_count", "exclusions_by_round",
    "cell6_encode_overflow_count", "max_abs_trained_weight", "ciphertext_expansion",
    "obs_metrics", "compile_cache", "smoke",
}
# The JAX cohort_compare_record's keys.
COHORT_KEYS = {"num_clients", "cohort_size", "bucket", "full_c_train_s", "cohort_train_s",
               "speedup", "devices_per_axis", "bitwise_equal"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def smallcnn_1024():
    """SmallCNN's JAX weights (a base and a trained-like client) with JAX
    keys at N = 1024, and the same carried to the port."""
    jctx, tctx = jkeys.CkksContext.create(n=1024), keys.CkksContext.create(n=1024)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(21))
    _, base = jcreate_model("smallcnn", rng=jax.random.key(22))
    rng = np.random.default_rng(23)
    client = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.01, a.shape)).astype(np.float32), base)
    return dict(jctx=jctx, tctx=tctx, jpk=jpk, pk=convert.keys_from_jax(jsk, jpk)[1],
                base=base, client=client)


def test_encrypt_params_bitwise_vs_jax(smallcnn_1024):
    s = smallcnn_1024
    key = jax.random.key(24)
    want = jsecure.encrypt_params(s["jctx"], s["jpk"], s["client"], key)
    n_ct = int(want.c0.shape[0])
    samples = jops.encrypt_samples(s["jctx"], key, (n_ct,))
    got = secure.encrypt_params(s["tctx"], s["pk"], convert.from_flax(s["client"]),
                                samples=tuple(_t(x) for x in samples))
    assert n_ct == 220 and tuple(got.c0.shape) == (220, 3, 1024)
    np.testing.assert_array_equal(_u(got.c0), np.asarray(want.c0))
    np.testing.assert_array_equal(_u(got.c1), np.asarray(want.c1))
    assert got.scale == want.scale
    # From a generator: the same geometry, a fresh encryption.
    drawn = secure.encrypt_params(s["tctx"], s["pk"], convert.from_flax(s["client"]),
                                  torch.Generator().manual_seed(0))
    assert tuple(drawn.c0.shape) == (220, 3, 1024) and not torch.equal(drawn.c0, got.c0)


def test_encrypt_params_packed_bitwise_vs_jax(smallcnn_1024):
    s = smallcnn_1024
    cfg = dict(bits=8, interleave=4, clip=0.5)
    jbase = jpack.PackSpec.for_params(s["base"], s["jctx"].n)
    jcfg = jq.PackingConfig(**cfg)
    guard = jcfg.guard_bits + (2 - 1).bit_length()
    jspec = jpack.PackedSpec(
        base=jbase, bits=8, k=4, field_bits=jq.field_bits(8, 2), guard=guard,
        step=float(jcfg.step), clip=0.5, clients=2, n_ct=-(-jbase.n_ct // 4),
        error_budget=jq.quant_error_budget(jcfg), clips=None, spans=None)
    spec = packing.PackedSpec.for_params(convert.from_flax(s["base"]), s["tctx"],
                                         quantize.PackingConfig(**cfg), 2)
    assert (spec.n_ct, spec.k, spec.guard, spec.field_bits) == (
        jspec.n_ct, jspec.k, jspec.guard, jspec.field_bits)
    key = jax.random.key(25)
    want = jsecure.encrypt_params_packed(s["jctx"], s["jpk"], s["client"], s["base"], key, jspec)
    samples = jops.encrypt_samples(s["jctx"], key, (jspec.n_ct,))
    got = secure.encrypt_params_packed(s["tctx"], s["pk"], convert.from_flax(s["client"]),
                                       convert.from_flax(s["base"]), None, spec,
                                       samples=tuple(_t(x) for x in samples))
    assert tuple(got.c0.shape) == (55, 3, 1024)
    np.testing.assert_array_equal(_u(got.c0), np.asarray(want.c0))
    np.testing.assert_array_equal(_u(got.c1), np.asarray(want.c1))
    assert got.scale == want.scale == spec.guard_scale


def test_cohort_compare_smoke_record_is_bitwise_with_the_jax_keys():
    rec = stream.cohort_compare_smoke_record(device="cpu")
    assert set(rec) == COHORT_KEYS
    assert rec["bitwise_equal"] is True
    assert (rec["num_clients"], rec["cohort_size"], rec["bucket"]) == (16, 2, 2)
    assert rec["full_c_train_s"] > 0 and rec["cohort_train_s"] > 0
    assert rec["devices_per_axis"] == {"clients": 1, "ct": 1}


def test_flagship_setup_smoke_and_streams():
    s = flagship.flagship_setup(0, smoke=True, device="cpu")
    assert set(s) == {"module", "params", "cfg", "ctx", "train", "test"}
    assert s["ctx"].n == 512 and s["train"][0].shape == (64, 28, 28, 1)
    assert s["test"][0].shape == (32, 28, 28, 1) and s["cfg"].epochs == 1
    again = flagship.flagship_setup(0, smoke=True, device="cpu")["params"]
    other = flagship.flagship_setup(1, smoke=True, device="cpu")["params"]
    assert all(torch.equal(s["params"][k], again[k]) for k in again)
    assert not all(torch.equal(s["params"][k], other[k]) for k in other)
    draw = lambda g: torch.randint(0, 2**62, (4,), generator=g).tolist()  # noqa: E731
    assert draw(flagship.flagship_round_gen(0, 1)) == draw(flagship.flagship_round_gen(0, 1))
    assert draw(flagship.flagship_round_gen(0, 1)) != draw(flagship.flagship_round_gen(0, 2))
    assert draw(flagship.flagship_round_gen(0, 1)) != draw(flagship.flagship_round_gen(1, 1))
    assert draw(flagship.flagship_keygen_gen()) == draw(flagship.flagship_keygen_gen("cpu"))
    assert flagship.BASELINE_TOTAL_S == 6583.6 and flagship.BASELINE_ACC == 0.8425


def test_bench_smoke_artifact(tmp_path, monkeypatch):
    # The cohort and DCN records have their own tests (above and in
    # test_torch_hierarchy.py); stand-ins keep this run short.
    cohort = dict.fromkeys(COHORT_KEYS, 1.0) | {"bitwise_equal": True}
    dcn = {"cohort_size": 8, "num_hosts": 4, "bytes_ratio": 2.0, "ratio_floor": 2.0,
           "bitwise_equal": True}
    monkeypatch.setattr(stream, "cohort_compare_smoke_record", lambda device=None: cohort)
    monkeypatch.setattr(hierarchy, "dcn_compare_smoke_record", lambda device=None: dcn)
    out = tmp_path / "BENCH_TORCH.json"
    assert bench._main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert set(art) - {"round_stats", "flops_counter"} == BENCH_KEYS
    assert art["smoke"] is True and art["rounds"] == 2 and len(art["accuracy_by_round"]) == 2
    assert art["compile_cache"] == "n/a" and art["flops_counter"] == "torch.utils.flop_counter"
    assert art["device"]["platform"] == "cpu" and art["he_backend"]["backend"] == "plain"
    assert art["enc_plain_max_abs_diff"] <= 5e-6
    assert art["enc_plain_max_abs_diff_exact_decode"] <= 5e-6
    assert art["encode_overflow_count"] == 0 and art["cell6_encode_overflow_count"] == 0
    for row in art["phase_roofline"].values():
        assert row["flops"] is not None and row["flops"] > 0 and row["mfu"] is not None
    assert art["train_mfu"] is not None and art["warm_round_s"] > 0
    assert art["phase_roofline"]["decrypt"]["op_kind"] == "int32"
    assert art["packing"]["packed_round_within_budget"] is True
    assert set(art["client_fusion_compare"]) == {"vmap", "fused", "fused_speedup_vs_vmap"}
    assert art["cohort_compare"] == cohort and art["dcn_compare"] == dcn
    # The HE rows count what the JAX cost model counts at this geometry.
    geo = art["he_roofline"]["geometry"]
    assert geo == {"n": 512, "num_limbs": 3, "n_ct": 440, "num_clients": 2,
                   "encrypt_clients": 1}
    want = jroofline.he_roofline({}, **geo)
    for phase in ("encrypt", "aggregate", "decrypt"):
        assert art["he_roofline"][phase]["int_ops"] == want[phase]["int_ops"]
        assert art["he_roofline"][phase]["bytes"] == want[phase]["bytes"]
        assert art["he_roofline"][phase]["util_vs_peak_int_ops"] is not None
    packed_geo = art["packing"]["he_roofline_packed"]["geometry"]
    assert packed_geo["n_ct"] == art["packing"]["n_ct"] == 110


def test_bench_raises_without_cuda_or_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_ntt.run()


def test_bench_ntt_cpu_artifact_and_exit_42(tmp_path, monkeypatch):
    out = tmp_path / "BENCH_TORCH_NTT.json"
    assert bench_ntt._main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["bitwise"] is True
    assert art["kernels_covered"] == [f"K{i}" for i in range(1, 8)]
    names = {rec["name"] for rec in art["kernels"]}
    assert names == {"ntt_forward", "ntt_inverse", "encrypt_fused", "decrypt_fused",
                     "keyswitch_fused", "keyswitch_fused_eval", "hoisted_products",
                     "transcipher_fused"}
    for rec in art["kernels"]:
        assert rec["max_abs_err"] == 0 and rec["ms"] is None and rec["plain_ms"] > 0
        assert rec["bound_ms"] > 0 and rec["bound_by"] in ("bytes", "operations")
        assert rec["route"] == "cuda" and rec["source"] == "hefl_tpu_torch/csrc/ntt.cu"
    assert {tuple(s) for s in art["shapes"]["hoisted"]} == set(bench_ntt.HOIST_SHAPES)
    monkeypatch.setattr(bench_ntt, "max_abs_err", lambda got, want: 1)
    assert bench_ntt._main(["--device", "cpu", "--out", str(tmp_path / "x.json")]) == 42


def test_launch_shape_lists_tell_every_launch_apart():
    # LAUNCH_ROWS keys K3/K4/K7 by (B*L, N) and K6 by (S*B*L, N): no two
    # timed shapes of one kernel share a key, the one-step twins included.
    for shapes, steps in ((bench_ntt.ENC_SHAPES, False), (bench_ntt.DEC_SHAPES, False),
                          (bench_ntt.TC_SHAPES, False), (bench_ntt.HOIST_SHAPES, True)):
        keys_ = {((s[0] if steps else 1) * s[-3] * s[-2], s[-1]) for s in shapes}
        assert len(keys_) == len(shapes)
    for shape in ((1, 18, 1, 3, 4096), (1, 30, 1, 5, 8192), (1, 18, 1, 3, 8192)):
        assert shape in bench_ntt.HOIST_SHAPES
    for shape in ((55, 3, 4096), (14, 3, 4096), (28, 3, 4096), (14080, 3, 256), (1760, 3, 256)):
        assert shape in bench_ntt.ENC_SHAPES
    assert (14, 3, 4096) in bench_ntt.DEC_SHAPES


def test_unhoisted_step_products_are_k6_at_one_step_on_the_cpu():
    # The twin's per-step products equal K6's plain version at S = 1 (the
    # function the card's route launches), and the twin stays bitwise the
    # hoisted plan.
    ctx = keys.CkksContext.create(n=256)
    sk, pk = keys.keygen(ctx, torch.Generator().manual_seed(30), device="cpu")
    steps = [1, 5, 17]
    gks = hei.gen_rotation_keys_for_steps(ctx, sk, 31, steps)
    x = np.random.default_rng(32).normal(0, 0.5, 40)
    ct = hei.encrypt_features(ctx, pk, x, torch.Generator().manual_seed(33))
    num_r = ctx.num_primes * ctx.ksk_num_digits
    rng = np.random.default_rng(34)
    p = np.asarray(ctx.ntt.p).astype(np.int64)
    res = lambda shape: torch.from_numpy(  # noqa: E731
        (rng.integers(0, 2**40, size=shape) % p).astype(np.int32))
    pc0, d = res((3, 256)), res((num_r, 3, 256))
    bk, ak = gks[5].b_mont[:num_r], gks[5].a_mont[:num_r]
    cuda_ntt.reset_launch_counts()
    got = ops.step_key_products(ctx, pc0, d, bk, ak)
    want = cuda_ntt.hoisted_products_plain(ctx.ntt, pc0, d, bk[None], ak[None])
    assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    assert all(g.dtype == torch.int32 for g in got)
    twin = ops.hoisted_rotations_reference(ctx, ct, steps, gks)
    hoisted = ops.hoisted_rotations(ctx, ct, steps, gks)
    assert torch.equal(twin.c0, hoisted.c0) and torch.equal(twin.c1, hoisted.c1)
    assert cuda_ntt.launch_counts()["hoisted_products"] == 0
