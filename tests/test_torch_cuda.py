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
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 1)


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
