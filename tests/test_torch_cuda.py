"""The port's CUDA kernels on the card, and the wrappers' device contract.

This file imports no JAX, so it runs on a machine with a GPU and PyTorch
alone:  python -m pytest tests/test_torch_cuda.py -m cuda
The tests marked `cuda` need a card and skip elsewhere (the kernels have no
CPU or interpret mode); the unmarked ones check, on the CPU, what the
wrappers do with CPU tensors and with inputs the kernels do not take.
"""

import numpy as np
import pytest
import torch

from hefl_tpu_torch.ckks import cuda_ntt, ntt
from hefl_tpu_torch.ckks.primes import find_ntt_primes

torch.set_num_threads(2)


def _ctx(n: int) -> ntt.NTTContext:
    return ntt.NTTContext.build(find_ntt_primes(3, 27, 2 * n), n)


def _res(ctx, shape, seed, device="cpu") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    p = np.asarray(ctx.p).astype(np.int64)
    x = rng.integers(0, 2**40, size=shape, dtype=np.int64) % p
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_versions():
    # Bitwise by construction, and no launch is counted.
    ctx = _ctx(1024)
    cuda_ntt.reset_launch_counts()
    x, y = _res(ctx, (2, 3, 1024), 1), _res(ctx, (2, 3, 1024), 2)
    k = _res(ctx, (3, 1024), 3)
    assert torch.equal(cuda_ntt.ntt_forward(ctx, x), cuda_ntt.ntt_forward_plain(ctx, x))
    assert torch.equal(cuda_ntt.ntt_inverse(ctx, x), cuda_ntt.ntt_inverse_plain(ctx, x))
    for got, want in zip(cuda_ntt.encrypt_fused(ctx, x, y, x, y, k, k),
                         cuda_ntt.encrypt_fused_plain(ctx, x, y, x, y, k, k)):
        assert torch.equal(got, want)
    assert torch.equal(cuda_ntt.decrypt_fused(ctx, x, y, k),
                       cuda_ntt.decrypt_fused_plain(ctx, x, y, k))
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)


def test_cpu_tensors_take_the_plain_keyswitch_and_hoisted_products():
    # K5 (both modes) and K6 on CPU tensors: the plain versions, no launch.
    ctx = _ctx(1024)
    num_r = 3 * 6
    cuda_ntt.reset_launch_counts()
    x = _res(ctx, (2, 3, 1024), 20)
    keys = _res(ctx, (num_r + 1, 3, 1024), 21), _res(ctx, (num_r + 1, 3, 1024), 22)
    for eval_input in (False, True):
        for got, want in zip(cuda_ntt.keyswitch_fused(ctx, x, *keys, 5, 6, eval_input),
                             cuda_ntt.keyswitch_fused_plain(ctx, x, *keys, 5, 6, eval_input)):
            assert torch.equal(got, want)
    d = _res(ctx, (2, num_r, 3, 1024), 23)
    hk = _res(ctx, (2, num_r, 3, 1024), 24), _res(ctx, (2, num_r, 3, 1024), 25)
    for got, want in zip(cuda_ntt.hoisted_products(ctx, x, d, *hk),
                         cuda_ntt.hoisted_products_plain(ctx, x, d, *hk)):
        assert torch.equal(got, want)
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)


def test_plain_inverse_undoes_forward_at_every_kernel_size():
    # Exact round trip at each N the kernels support.
    for n in cuda_ntt.SUPPORTED_N:
        ctx = _ctx(n)
        x = _res(ctx, (2, 3, n), n)
        assert torch.equal(ntt.ntt_inverse_plain(ctx, ntt.ntt_forward_plain(ctx, x)), x)


def test_wrappers_reject_what_the_kernels_do_not_take():
    ctx = _ctx(1024)
    x = _res(ctx, (2, 3, 1024), 4)
    with pytest.raises(TypeError):
        cuda_ntt.ntt_forward(ctx, x.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_ntt.ntt_forward(ctx, x[:, :2])                 # wrong prime count
    with pytest.raises(ValueError):
        cuda_ntt.decrypt_fused(ctx, x, x, x.to("meta"))     # mixed devices


def test_library_path_is_keyed_by_source_hash():
    path = cuda_ntt.library_path()
    assert path.parent == cuda_ntt.BUILD_DIR
    assert path.name.startswith("libhefl_ntt_") and path.suffix == ".so"
    assert cuda_ntt.SOURCE.parent == cuda_ntt.CSRC


def test_library_path_covers_every_file_under_csrc(tmp_path, monkeypatch):
    # A changed header must change the library's name, not load a stale one.
    for f in cuda_ntt.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_ntt, "CSRC", tmp_path)
    before = cuda_ntt.library_path()
    (tmp_path / "extra.cuh").write_text("// header\n")
    assert cuda_ntt.library_path() != before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
def test_kernels_bitwise_vs_plain_on_card(cuda_device, n):
    # Bitwise: K1-K4 against their plain versions on the same card tensors,
    # and each launch counted once.
    ctx = _ctx(n)
    dev = cuda_device
    x = _res(ctx, (5, 3, n), 5, dev)
    m, u, e0, e1 = (_res(ctx, (7, 3, n), s, dev) for s in (6, 7, 8, 9))
    b, a = _res(ctx, (3, n), 10, dev), _res(ctx, (3, n), 11, dev)
    cuda_ntt.reset_launch_counts()
    assert torch.equal(cuda_ntt.ntt_forward(ctx, x), cuda_ntt.ntt_forward_plain(ctx, x))
    assert torch.equal(cuda_ntt.ntt_inverse(ctx, x), cuda_ntt.ntt_inverse_plain(ctx, x))
    for got, want in zip(cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a),
                         cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)):
        assert torch.equal(got, want)
    assert torch.equal(cuda_ntt.decrypt_fused(ctx, m, u, b),
                       cuda_ntt.decrypt_fused_plain(ctx, m, u, b))
    torch.cuda.synchronize(dev)
    k1_k4 = ("ntt_forward", "ntt_inverse", "encrypt_fused", "decrypt_fused")
    assert cuda_ntt.launch_counts() == {k: int(k in k1_k4) for k in cuda_ntt.LAUNCHES}


@pytest.mark.cuda
def test_kernels_reject_unsupported_ring_on_card(cuda_device):
    ctx = _ctx(256)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_forward(ctx, _res(ctx, (1, 3, 256), 12, cuda_device))


@pytest.mark.cuda
def test_round_on_card_runs_through_the_kernels(cuda_device):
    # A tiny encrypted round (SmallCNN, N=1024) on the card: K1, K3 and K4
    # launch, and the decrypted average sits within the repo's 5e-6
    # encrypted-average yardstick of the plaintext mean.
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
    from hefl_tpu_torch.data.synthetic import make_dataset
    from hefl_tpu_torch.fl.config import TrainConfig
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.models import create_model

    dev = cuda_device
    (x, y), _, _ = make_dataset("mnist", seed=0, n_train=64, n_test=8)
    xs, ys = stack_federated(x, y, iid_contiguous(len(y), 2))
    gen = torch.Generator().manual_seed(0)
    model = create_model("smallcnn", gen=gen, device=dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = CkksContext.create(n=1024)
    cuda_ntt.reset_launch_counts()
    sk, pk = keygen(ctx, gen, device=dev)
    ct_sum, _, _, ref = secure_fedavg_round(
        model, TrainConfig(epochs=1, num_classes=10), ctx, pk, params,
        torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev), gen,
        with_plain_reference=True,
    )
    avg = decrypt_average(ctx, sk, ct_sum, 2, PackSpec.for_params(params, ctx.n))
    counts = cuda_ntt.launch_counts()
    assert counts["ntt_forward"] == 2 and counts["encrypt_fused"] == 1
    assert counts["decrypt_fused"] == 1
    assert max((avg[k] - ref[k]).abs().max().item() for k in ref) <= 5e-6


def _ks_cases(n, dev):
    """(name, kernel fn, plain fn) for K5 in both modes and K6, at N=n."""
    ctx = _ctx(n)
    ctx5 = ntt.NTTContext.build(find_ntt_primes(5, 27, 2 * n), n)
    x, x5 = _res(ctx, (4, 3, n), 30, dev), _res(ctx5, (1, 5, n), 31, dev)
    k3 = _res(ctx, (19, 3, n), 32, dev), _res(ctx, (19, 3, n), 33, dev)
    k5 = _res(ctx5, (31, 5, n), 34, dev), _res(ctx5, (31, 5, n), 35, dev)
    d = _res(ctx, (2, 18, 3, n), 36, dev)
    hk = _res(ctx, (22, 18, 3, n), 37, dev), _res(ctx, (22, 18, 3, n), 38, dev)
    c0 = x[:2].contiguous()
    return [
        ("keyswitch_fused", lambda: cuda_ntt.keyswitch_fused(ctx, x, *k3, 5, 6),
         lambda: cuda_ntt.keyswitch_fused_plain(ctx, x, *k3, 5, 6)),
        ("keyswitch_fused_eval", lambda: cuda_ntt.keyswitch_fused(ctx5, x5, *k5, 5, 6, True),
         lambda: cuda_ntt.keyswitch_fused_plain(ctx5, x5, *k5, 5, 6, True)),
        ("hoisted_products", lambda: cuda_ntt.hoisted_products(ctx, c0, d, *hk),
         lambda: cuda_ntt.hoisted_products_plain(ctx, c0, d, *hk)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096, 8192])
def test_keyswitch_and_hoisted_products_bitwise_vs_plain_on_card(cuda_device, n):
    # Bitwise: K5 (coefficient input at L=3, B=4; eval input at L=5) and K6
    # (S=22, R=18, B=2) against their plain versions on the same card
    # tensors; each wrapper call counted once, under its own name.
    cuda_ntt.reset_launch_counts()
    for name, kern, plain in _ks_cases(n, cuda_device):
        for got, want in zip(kern(), plain()):
            assert torch.equal(got, want), name
        torch.cuda.synchronize(cuda_device)
        assert cuda_ntt.launch_counts()[name] == 1
    ctx = _ctx(n)
    empty = cuda_ntt.hoisted_products(
        ctx, _res(ctx, (3, n), 39, cuda_device), _res(ctx, (18, 3, n), 40, cuda_device),
        *(torch.zeros((0, 18, 3, n), dtype=torch.int32, device=cuda_device),) * 2)
    assert tuple(empty[0].shape) == (0, 3, n)
    assert cuda_ntt.launch_counts()["hoisted_products"] == 1


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(cuda_device):
    # A small BSGS linear score (N=1024) on the card through K1, K2, K5 and
    # K6 is bitwise the same score run on CPU copies (the plain versions).
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen

    ctx = CkksContext.create(n=1024)
    gen = torch.Generator().manual_seed(41)
    sk, pk = keygen(ctx, gen, device=cuda_device)
    rng = np.random.default_rng(42)
    d, k = 40, 4
    W, b, x = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k), rng.normal(0, 0.5, d)
    plan = hei.bsgs_plan(512, d, k)
    gks = hei.gen_rotation_keys_for_steps(ctx, sk, 43, plan.rotation_steps_needed)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    scorer = hei.BsgsLinearScorer(ctx, W, b, gks, device=cuda_device)
    cuda_ntt.reset_launch_counts()
    out = scorer.score(ct)
    counts = cuda_ntt.launch_counts()
    assert counts["keyswitch_fused"] == len(plan.giant_steps)
    assert counts["hoisted_products"] == 1
    cpu_gks = {s: hei.GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())
               for s, v in gks.items()}
    ref = hei.BsgsLinearScorer(ctx, W, b, cpu_gks, device="cpu").score(
        hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    assert torch.equal(out.c0.cpu(), ref.c0) and torch.equal(out.c1.cpu(), ref.c1)
    got = hei.decrypt_class_scores(ctx, sk, out, k)
    assert np.max(np.abs(got - (x @ W.T + b))) <= 0.05
