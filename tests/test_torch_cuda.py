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


def _ctx(n: int, num_l: int = 3) -> ntt.NTTContext:
    return ntt.NTTContext.build(find_ntt_primes(num_l, 27, 2 * n), n)


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


def _k7_inputs(ctx, rows, seed, device="cpu"):
    """Word pairs int32[rows, N] below 2**31 and pad residues [rows, L, N]."""
    rng = np.random.default_rng(seed)
    words = [torch.from_numpy(rng.integers(0, 2**31, (rows, ctx.n)).astype(np.int32)).to(device)
             for _ in range(2)]
    return (*words, _res(ctx, (rows, ctx.num_primes, ctx.n), seed + 1, device),
            _res(ctx, (rows, ctx.num_primes, ctx.n), seed + 2, device))


def test_cpu_tensors_take_the_plain_transcipher():
    # K7 on CPU tensors: the plain version, no launch; a zero pad_c1 word
    # stays zero under the negation.
    ctx = _ctx(1024)
    w_hi, w_lo, p0, p1 = _k7_inputs(ctx, 4, 50)
    p1[0, 0, :7] = 0
    cuda_ntt.reset_launch_counts()
    c0, c1 = cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, p0, p1)
    want = cuda_ntt.transcipher_fused_plain(ctx, w_hi, w_lo, p0, p1)
    assert torch.equal(c0, want[0]) and torch.equal(c1, want[1])
    assert torch.all(c1[0, 0, :7] == 0) and torch.all((c1 >= 0) & (c1 < 2**27))
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
@pytest.mark.parametrize("rows", [1, 3, 6, 54, 57, 165, 330, 456])
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
def test_kernels_bitwise_vs_plain_on_card(cuda_device, n, rows):
    # Bitwise: K1-K4 on `rows` rows (every cluster plan of ntt_plan: 8, 8,
    # 8, 2, 2 and 1 blocks a row; 330 and 456 rows are K3's launches in the
    # round and the HHE round) against their plain versions on the same
    # card tensors, each launch counted once at its shape.
    ctx = _ctx(n) if rows % 3 == 0 else _ctx(n, 1)
    dev = cuda_device
    shape = (rows // ctx.num_primes, ctx.num_primes, n)
    m, u, e0, e1 = (_res(ctx, shape, s, dev) for s in (5, 6, 7, 8))
    b, a = _res(ctx, shape[1:], 10, dev), _res(ctx, shape[1:], 11, dev)
    cuda_ntt.reset_launch_counts()
    assert torch.equal(cuda_ntt.ntt_forward(ctx, m), cuda_ntt.ntt_forward_plain(ctx, m))
    assert torch.equal(cuda_ntt.ntt_inverse(ctx, m), cuda_ntt.ntt_inverse_plain(ctx, m))
    for got, want in zip(cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a),
                         cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)):
        assert torch.equal(got, want)
    assert torch.equal(cuda_ntt.decrypt_fused(ctx, u, e1, b),
                       cuda_ntt.decrypt_fused_plain(ctx, u, e1, b))
    torch.cuda.synchronize(dev)
    k1_k4 = ("ntt_forward", "ntt_inverse", "encrypt_fused", "decrypt_fused")
    assert cuda_ntt.launch_counts() == {k: int(k in k1_k4) for k in cuda_ntt.LAUNCHES}
    assert cuda_ntt.launch_rows() == {(k, rows, n): 1 for k in k1_k4}


@pytest.mark.cuda
def test_ntt_rejects_unaligned_rows_on_card(cuda_device):
    # K1/K2 load rows as 16-byte vectors: a view 4 bytes off is refused.
    ctx = _ctx(1024, 1)
    flat = _res(ctx, (2, 1, 1024), 13, cuda_device).reshape(-1)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_inverse(ctx, flat[1:1025].reshape(1, 1, 1024))


@pytest.mark.cuda
def test_encrypt_decrypt_reject_unaligned_rows_on_card(cuda_device):
    # K4 loads c0, c1 and the key row as 16-byte vectors, K3's epilogue the
    # public key rows: a view 4 bytes off is refused, and nothing launches.
    ctx = _ctx(1024, 1)
    good = _res(ctx, (1, 1, 1024), 14, cuda_device)
    bad = _res(ctx, (2, 1, 1024), 15, cuda_device).reshape(-1)[1:1025].reshape(1, 1, 1024)
    cuda_ntt.reset_launch_counts()
    for c0, c1, s in ((bad, good, good[0]), (good, bad, good[0]), (good, good, bad[0])):
        with pytest.raises(ValueError):
            cuda_ntt.decrypt_fused(ctx, c0, c1, s)
    with pytest.raises(ValueError):
        cuda_ntt.encrypt_fused(ctx, good, good, good, good, bad[0], good[0])
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)


@pytest.mark.cuda
def test_kernels_reject_unsupported_ring_on_card(cuda_device):
    # N = 128 is below the kernels' rings (256..16384): refused by name.
    ctx = _ctx(128)
    with pytest.raises(ValueError, match="not 128"):
        cuda_ntt.ntt_forward(ctx, _res(ctx, (1, 3, 128), 12, cuda_device))


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


def _ks_cases(n, num_l, batch, dev):
    """(name, kernel fn, plain fn) for K5 in both modes on [batch, num_l, n]
    (R = 6 * num_l gadget components), and K6 (S=22, R=18, B=2) at L=3."""
    ctx = _ctx(n, num_l)
    num_c = 6 * num_l + 1
    x = _res(ctx, (batch, num_l, n), 30 + num_l, dev)
    keys = _res(ctx, (num_c, num_l, n), 32, dev), _res(ctx, (num_c, num_l, n), 33, dev)
    cases = [
        ("keyswitch_fused", lambda: cuda_ntt.keyswitch_fused(ctx, x, *keys, 5, 6),
         lambda: cuda_ntt.keyswitch_fused_plain(ctx, x, *keys, 5, 6)),
        ("keyswitch_fused_eval", lambda: cuda_ntt.keyswitch_fused(ctx, x, *keys, 5, 6, True),
         lambda: cuda_ntt.keyswitch_fused_plain(ctx, x, *keys, 5, 6, True)),
    ]
    if num_l == 3:
        d = _res(ctx, (2, 18, 3, n), 36, dev)
        hk = _res(ctx, (22, 18, 3, n), 37, dev), _res(ctx, (22, 18, 3, n), 38, dev)
        c0 = _res(ctx, (2, 3, n), 39, dev)
        cases.append(("hoisted_products", lambda: cuda_ntt.hoisted_products(ctx, c0, d, *hk),
                      lambda: cuda_ntt.hoisted_products_plain(ctx, c0, d, *hk)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("num_l", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
def test_keyswitch_and_hoisted_products_bitwise_vs_plain_on_card(cuda_device, n, num_l, batch):
    # Bitwise: K5 in both modes at [batch, num_l, n] (the digit stage on
    # 6, 24, 54 or 150 rows a ciphertext: every cluster plan C = 8, 4, 2, 1
    # of keyswitch_plan; the eval-input inverse on 1 to 20 rows) and, at
    # L=3, K6 (S=22, R=18, B=2) against their plain versions on the same
    # card tensors; each wrapper call counted once, under its own name, at
    # its (rows, N).
    cuda_ntt.reset_launch_counts()
    for name, kern, plain in _ks_cases(n, num_l, batch, cuda_device):
        for got, want in zip(kern(), plain()):
            assert torch.equal(got, want), name
        torch.cuda.synchronize(cuda_device)
        assert cuda_ntt.launch_counts()[name] == 1
    rows = cuda_ntt.launch_rows()
    assert rows[("keyswitch_fused", batch * num_l, n)] == 1
    assert rows[("keyswitch_fused_eval", batch * num_l, n)] == 1
    if num_l == 3:
        ctx = _ctx(n)
        empty = cuda_ntt.hoisted_products(
            ctx, _res(ctx, (3, n), 39, cuda_device), _res(ctx, (18, 3, n), 40, cuda_device),
            *(torch.zeros((0, 18, 3, n), dtype=torch.int32, device=cuda_device),) * 2)
        assert tuple(empty[0].shape) == (0, 3, n)
        assert cuda_ntt.launch_counts()["hoisted_products"] == 1


@pytest.mark.cuda
def test_keyswitch_rejects_unaligned_keys_on_card(cuda_device):
    # K5's inner product loads the key rows as 16-byte vectors: a key view
    # 4 bytes off is refused, as an unaligned eval-domain input is.
    ctx = _ctx(1024, 1)
    x = _res(ctx, (1, 1, 1024), 41, cuda_device)
    flat = _res(ctx, (8, 1, 1024), 42, cuda_device).reshape(-1)
    bad = flat[1:1 + 7 * 1024].reshape(7, 1, 1024)
    with pytest.raises(ValueError):
        cuda_ntt.keyswitch_fused(ctx, x, bad, bad, 5, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kw", [{}] + [{"split": q} for q in cuda_ntt.HOIST_SPLITS],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "plan")
@pytest.mark.parametrize("num_s,batch,num_l,n", [
    (1, 1, 3, 4096),      # one step
    (1, 5, 6, 1024),      # R = 36 > K: two component chunks
    (3, 5, 6, 8192),
    (22, 4, 3, 4096),     # score_many's shape
    (4, 1, 3, 8192),      # the MLP's second layer
])
def test_hoisted_products_bitwise_vs_plain_on_card(cuda_device, num_s, batch, num_l, n,
                                                   plan_kw):
    # K6 at the plan's split and at every split Q, against its plain
    # version on the same card tensors; one launch counted at its (S*B*L, N).
    ctx = _ctx(n, num_l)
    r = 6 * num_l
    c0 = _res(ctx, (batch, num_l, n), 50, cuda_device)
    d = _res(ctx, (batch, r, num_l, n), 51, cuda_device)
    hk = _res(ctx, (num_s, r, num_l, n), 52, cuda_device), _res(ctx, (num_s, r, num_l, n), 53,
                                                               cuda_device)
    cuda_ntt.reset_launch_counts()
    plan = cuda_ntt.hoisted_plan(num_s, batch, r, ctx.p[:, 0], n, **plan_kw)
    got = cuda_ntt.hoisted_products(ctx, c0, d, *hk, plan=plan)
    for g, w in zip(got, cuda_ntt.hoisted_products_plain(ctx, c0, d, *hk)):
        assert torch.equal(g, w)
    torch.cuda.synchronize(cuda_device)
    assert cuda_ntt.launch_rows() == {("hoisted_products", num_s * batch * num_l, n): 1}


@pytest.mark.cuda
def test_hoisted_products_rejects_unaligned_inputs_on_card(cuda_device):
    # K6 loads c0, the digits and both keys as 16-byte vectors: a view 4
    # bytes off in any of them is refused before a launch.
    ctx = _ctx(1024, 1)
    good = [_res(ctx, shape, 60 + i, cuda_device) for i, shape in enumerate(
        [(1, 1, 1024), (1, 6, 1, 1024), (2, 6, 1, 1024), (2, 6, 1, 1024)])]
    cuda_ntt.reset_launch_counts()
    for k in range(4):
        flat = torch.cat([good[k].reshape(-1)[:1], good[k].reshape(-1)])
        args = list(good)
        args[k] = flat[1:].reshape(good[k].shape)
        with pytest.raises(ValueError):
            cuda_ntt.hoisted_products(ctx, *args)
    assert cuda_ntt.launch_counts()["hoisted_products"] == 0


def _small_linear_score(dev):
    """A small BSGS linear score (N=1024, d=40, K=4) on `dev`: (ctx, sk, W,
    b, x, k, plan, Galois keys, ciphertext, scorer)."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks.keys import CkksContext, keygen

    ctx = CkksContext.create(n=1024)
    gen = torch.Generator().manual_seed(41)
    sk, pk = keygen(ctx, gen, device=dev)
    rng = np.random.default_rng(42)
    d, k = 40, 4
    W, b, x = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k), rng.normal(0, 0.5, d)
    plan = hei.bsgs_plan(512, d, k)
    gks = hei.gen_rotation_keys_for_steps(ctx, sk, 43, plan.rotation_steps_needed)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    scorer = hei.BsgsLinearScorer(ctx, W, b, gks, device=dev)
    return ctx, sk, W, b, x, k, plan, gks, ct, scorer


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(cuda_device):
    # A small BSGS linear score (N=1024) on the card through K1, K2, K5 and
    # K6 is bitwise the same score run on CPU copies (the plain versions).
    from hefl_tpu_torch import he_inference as hei

    ctx, sk, W, b, x, k, plan, gks, ct, scorer = _small_linear_score(cuda_device)
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


@pytest.mark.cuda
def test_linear_score_launch_rows_on_card(cuda_device):
    # One linear score launches K1 on 3 rows (one ciphertext) and on 54 (the
    # hoisted digits, L*d = 18 components of 3 primes), K2 on 3 rows (c1)
    # and on 6 (c0 and c1 of each giant step): the row counts ntt_plan
    # spreads over clusters.
    *_, plan, _, ct, scorer = _small_linear_score(cuda_device)
    cuda_ntt.reset_launch_counts()
    scorer.score(ct)
    shapes = cuda_ntt.launch_rows()
    assert shapes[("ntt_forward", 3, 1024)] >= 1
    assert shapes[("ntt_forward", 54, 1024)] == 1
    assert shapes[("ntt_inverse", 3, 1024)] == 1
    assert shapes[("ntt_inverse", 6, 1024)] == len(plan.giant_steps)
    assert sum(v for (name, _, _), v in shapes.items() if name == "ntt_forward") == \
        cuda_ntt.launch_counts()["ntt_forward"]


def _small_ladder(dev, n: int = 1024, num_l: int = 3):
    """A small ladder setup on `dev`: (ctx, sk, pk, Galois keys, relin key,
    generator)."""
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks.keys import CkksContext, gen_relin_key, keygen

    ctx = CkksContext.create(n=n, num_primes=num_l)
    gen = torch.Generator().manual_seed(44)
    sk, pk = keygen(ctx, gen, device=dev)
    return ctx, sk, pk, hei.gen_rotation_keys(ctx, sk, 45), gen_relin_key(ctx, sk, gen), gen


def _cpu_keys(gks):
    from hefl_tpu_torch import he_inference as hei

    return {s: hei.GaloisKey(g=v.g, b_mont=v.b_mont.cpu(), a_mont=v.a_mont.cpu())
            for s, v in gks.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
def test_ladder_linear_on_card_equals_cpu(cuda_device, batch):
    # The ladder LinearScorer (N=1024, d=40, K=4; one query and score_many
    # on 3) through K1, K2 and K5 on the card is bitwise the same score on
    # CPU copies; per stage one K5, one K2 and one K1 launch.
    from hefl_tpu_torch import he_inference as hei

    ctx, sk, pk, gks, _, gen = _small_ladder(cuda_device)
    rng = np.random.default_rng(46)
    d, k = 40, 4
    W, b = rng.normal(0, 0.3, (k, d)), rng.normal(0, 0.2, k)
    x = rng.normal(0, 0.5, (d,) if batch is None else (batch, d))
    ct = hei.encrypt_features(ctx, pk, x, gen)
    scorer = hei.LinearScorer(ctx, W, b, gks, device=cuda_device)
    cuda_ntt.reset_launch_counts()
    out = scorer.score_batched(ct) if batch is None else scorer.score_many(ct)
    stages = len(hei.rotation_steps(512))
    counts = cuda_ntt.launch_counts()
    assert (counts["keyswitch_fused"], counts["ntt_inverse"], counts["ntt_forward"]) == (
        stages, stages, stages + 2)
    ref = hei.LinearScorer(ctx, W, b, _cpu_keys(gks), device="cpu")
    cpu_ct = hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale)
    want = ref.score_batched(cpu_ct) if batch is None else ref.score_many(cpu_ct)
    assert torch.equal(out.c0.cpu(), want.c0) and torch.equal(out.c1.cpu(), want.c1)
    got = hei.decrypt_score_matrix(ctx, sk, out)
    assert np.max(np.abs(got - (x @ W.T + b))) <= 0.05


@pytest.mark.cuda
def test_ladder_mlp_on_card_equals_cpu(cuda_device):
    # The ladder MlpScorer (N=1024, L=5, d=16, H=4, K=3): the hidden ladder,
    # the square's eval-input K5, two rescales; bitwise the CPU plain run.
    from hefl_tpu_torch import he_inference as hei
    from hefl_tpu_torch.ckks.keys import RelinKey

    ctx, sk, pk, gks, rlk, gen = _small_ladder(cuda_device, num_l=5)
    rng = np.random.default_rng(47)
    d, hidden, k = 16, 4, 3
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (k, hidden)), rng.normal(0, 0.2, k)
    x = rng.normal(0, 0.4, d)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    scorer = hei.MlpScorer(ctx, w1, b1, w2, b2, gks, rlk, device=cuda_device)
    cuda_ntt.reset_launch_counts()
    out = scorer.score_batched(ct)
    assert cuda_ntt.launch_rows()[("keyswitch_fused_eval", hidden * 5, 1024)] == 1
    ref = hei.MlpScorer(ctx, w1, b1, w2, b2, _cpu_keys(gks),
                        RelinKey(b_mont=rlk.b_mont.cpu(), a_mont=rlk.a_mont.cpu()), device="cpu")
    want = ref.score_batched(hei.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.scale))
    assert torch.equal(out.c0.cpu(), want.c0) and torch.equal(out.c1.cpu(), want.c1)
    got = hei.decrypt_score_matrix(scorer.sub_ctx, hei.slice_secret_key(sk, 3), out)
    assert np.max(np.abs(got - (((x @ w1.T + b1) ** 2) @ w2.T + b2))) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 18, 24, 57, 456])
@pytest.mark.parametrize("n", [1024, 4096, 8192])
def test_transcipher_bitwise_vs_plain_on_card(cuda_device, n, rows):
    # Bitwise: K7 on `rows` = upload rows x L rows (every cluster plan of
    # ntt_plan: 8, 4, 4, 2 and 1 blocks a row; 456 is the HHE round's 8
    # clients x 19 packed rows x 3 primes) against its plain version on the
    # same card tensors, one launch counted at its shape; a zero pad_c1 word
    # stays zero.
    ctx = _ctx(n) if rows % 3 == 0 else _ctx(n, 1)
    args = _k7_inputs(ctx, rows // ctx.num_primes, 60 + rows, cuda_device)
    args[3][0, 0, :5] = 0
    cuda_ntt.reset_launch_counts()
    got = cuda_ntt.transcipher_fused(ctx, *args)
    want = cuda_ntt.transcipher_fused_plain(ctx, *args)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_ntt.launch_counts() == {k: int(k == "transcipher_fused") for k in cuda_ntt.LAUNCHES}
    assert cuda_ntt.launch_rows() == {("transcipher_fused", rows, n): 1}
    with pytest.raises(ValueError):
        cuda_ntt.transcipher_fused(ctx, args[0][:, :-1].contiguous(), *args[1:])


@pytest.mark.cuda
def test_transcipher_rejects_unaligned_pads_on_card(cuda_device):
    # K7's epilogue loads the pad rows as 16-byte vectors: a pad view 4
    # bytes off is refused, and nothing launches.
    ctx = _ctx(1024)
    w_hi, w_lo, pad0, pad1 = _k7_inputs(ctx, 1, 61, cuda_device)
    bad = _res(ctx, (2, 3, 1024), 62, cuda_device).reshape(-1)[1:1 + 3 * 1024].reshape(1, 3, 1024)
    cuda_ntt.reset_launch_counts()
    for pads in ((bad, pad1), (pad0, bad)):
        with pytest.raises(ValueError):
            cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, *pads)
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)


@pytest.mark.cuda
def test_encrypt_fused_at_the_medical_round_shape_on_card(cuda_device):
    # K3 at [440, 3, 4096]: one medical-8 / medical-skew round's 8 clients x
    # 55 ciphertexts (1,320 rows), bitwise against its plain version, one
    # launch counted at its shape.
    ctx = _ctx(4096)
    m, u, e0, e1 = (_res(ctx, (440, 3, 4096), 70 + i, cuda_device) for i in range(4))
    b, a = (_res(ctx, (3, 4096), 74 + i, cuda_device) for i in range(2))
    cuda_ntt.reset_launch_counts()
    got = cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a)
    want = cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_ntt.launch_rows() == {("encrypt_fused", 1320, 4096): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 16384])
def test_k1_to_k7_bitwise_vs_plain_at_the_smallest_and_largest_rings_on_card(cuda_device, n):
    # The rings beside 1024..8192: one block a row at N = 256 and 512, at
    # least two at 16384 (18 rows take C = 4, 3 rows C = 8). K1-K4 and K7 on
    # 3, 18, 57 and 456 rows, K5 in both modes at L = 1 and 3, K6 at every
    # split, each bitwise against its plain version on the same card tensors.
    dev = cuda_device
    for rows in (3, 18, 57, 456):
        ctx = _ctx(n)
        shape = (rows // 3, 3, n)
        m, u, e0, e1 = (_res(ctx, shape, rows + s, dev) for s in (5, 6, 7, 8))
        b, a = _res(ctx, shape[1:], 10, dev), _res(ctx, shape[1:], 11, dev)
        w_hi, w_lo, pad0, pad1 = _k7_inputs(ctx, rows // 3, rows, dev)
        assert torch.equal(cuda_ntt.ntt_forward(ctx, m), cuda_ntt.ntt_forward_plain(ctx, m))
        assert torch.equal(cuda_ntt.ntt_inverse(ctx, m), cuda_ntt.ntt_inverse_plain(ctx, m))
        for got, want in zip(cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a),
                             cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)):
            assert torch.equal(got, want)
        assert torch.equal(cuda_ntt.decrypt_fused(ctx, u, e1, b),
                           cuda_ntt.decrypt_fused_plain(ctx, u, e1, b))
        for got, want in zip(cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, pad0, pad1),
                             cuda_ntt.transcipher_fused_plain(ctx, w_hi, w_lo, pad0, pad1)):
            assert torch.equal(got, want)
    for num_l in (1, 3):
        ctx = _ctx(n, num_l)
        x = _res(ctx, (1, num_l, n), 30 + num_l, dev)
        keys = [_res(ctx, (6 * num_l + 1, num_l, n), 31 + i, dev) for i in range(2)]
        for eval_input in (False, True):
            for got, want in zip(cuda_ntt.keyswitch_fused(ctx, x, *keys, 5, 6, eval_input),
                                 cuda_ntt.keyswitch_fused_plain(ctx, x, *keys, 5, 6, eval_input)):
                assert torch.equal(got, want)
    ctx = _ctx(n)
    c0 = _res(ctx, (2, 3, n), 40, dev)
    d, bk, ak = (_res(ctx, shape, 41 + i, dev) for i, shape in enumerate(
        ((2, 18, 3, n), (3, 18, 3, n), (3, 18, 3, n))))
    want = cuda_ntt.hoisted_products_plain(ctx, c0, d, bk, ak)
    for q in cuda_ntt.HOIST_SPLITS:
        plan = cuda_ntt.hoisted_plan(3, 2, 18, ctx.p[:, 0], n, split=q)
        for g, w in zip(cuda_ntt.hoisted_products(ctx, c0, d, bk, ak, plan=plan), want):
            assert torch.equal(g, w)
    torch.cuda.synchronize(dev)
    assert {n_ for _, _, n_ in cuda_ntt.launch_rows()} >= {n}


@pytest.mark.cuda
def test_hhe_smoke_preset_runs_on_the_card(cuda_device, monkeypatch):
    # hhe-smoke's first round at its own ring (N = 256) through the kernels:
    # the decrypted average within the packed spec's error budget of the
    # plaintext mean of the same trained weights, expansion_hhe <= 1.1, and
    # exactly K1 twice (keygen), one K3 and one K7 over 8 clients x 294
    # packed rows and one K4 over 294.
    import dataclasses

    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.fl import secure, stream
    from hefl_tpu_torch.presets import PRESETS

    trained, avgs = [], []
    real_uploads, real_decrypt = stream.client_uploads, experiment.decrypt_average

    def uploads(*a, **k):
        out = real_uploads(*a, **k)
        trained.append(out[3])
        return out

    def decrypt(*a, **k):
        avgs.append((real_decrypt(*a, **k), k["packing"]))
        return avgs[-1][0]

    monkeypatch.setattr(stream, "client_uploads", uploads)
    monkeypatch.setattr(experiment, "decrypt_average", decrypt)
    cuda_ntt.reset_launch_counts()
    out = experiment.run_experiment(dataclasses.replace(PRESETS["hhe-smoke"], rounds=1),
                                    verbose=False)
    torch.cuda.synchronize(cuda_device)
    (avg, spec), = avgs
    ref = secure.plain_mean(trained[0])
    assert max((avg[k] - ref[k]).abs().max().item() for k in ref) <= spec.error_budget
    assert out["hhe"]["expansion_hhe"] <= 1.1
    assert out["history"][0]["encode_overflow"] == [0] * 8
    rows = 3 * out["packing"]["n_ct"]
    assert cuda_ntt.launch_rows() == {
        ("ntt_forward", 3, 256): 2, ("encrypt_fused", 8 * rows, 256): 1,
        ("transcipher_fused", 8 * rows, 256): 1, ("decrypt_fused", rows, 256): 1}


def _masked_half(device):
    """The masked round's HE half on `device` with CPU-drawn keys and
    samples: six clients (clean, NaN-poisoned, +1e15-poisoned, scheduled
    out, two clean), poison -> overflow -> exclusion bits -> encrypt every
    client's rows (one K3 on a card) -> zero the excluded rows -> sum ->
    decrypt (one K4)."""
    from hefl_tpu_torch.ckks import encoding, ops
    from hefl_tpu_torch.ckks.keys import CkksContext, PublicKey, SecretKey, keygen
    from hefl_tpu_torch.ckks.packing import PackSpec, pack_params
    from hefl_tpu_torch.fl import faults, secure
    from hefl_tpu_torch.fl.config import TrainConfig

    ctx = CkksContext.create(n=1024)
    sk, pk = keygen(ctx, torch.Generator().manual_seed(70), device="cpu")
    gen = torch.Generator().manual_seed(71)
    gp = {"a.weight": torch.randn(3000, generator=gen) * 0.2,
          "b.bias": torch.randn(40, generator=gen) * 0.2}
    clients = [{k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in gp.items()}
               for _ in range(6)]
    codes, mask = [0, 1, 2, 0, 0, 0], [1, 1, 1, 0, 1, 1]
    spec = PackSpec.for_params(gp, ctx.n)
    samples = ops.encrypt_samples(ctx, gen, (6, spec.n_ct), "cpu")
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    sk = SecretKey(s_mont=sk.s_mont.to(device))
    pk = PublicKey(b_mont=pk.b_mont.to(device), a_mont=pk.a_mont.to(device))
    p_out = [faults.poison_tree(to(c), code) for c, code in zip(clients, codes)]
    overflow = torch.stack([encoding.encode_overflow_count(pack_params(prm, ctx.n), ctx.scale)
                            for prm in p_out])
    bits = faults.exclusion_bits(TrainConfig(max_update_norm=50.0, on_overflow="exclude"),
                                 to(gp), p_out, mask, overflow)
    ct = secure.encrypt_stack(ctx, pk, p_out, samples=tuple(s.to(device) for s in samples))
    ct_sum = secure.aggregate_encrypted(ctx, secure.zero_excluded(ct, bits == 0))
    meta = faults.RoundMeta.from_bits(bits)
    res = ops.decrypt(ctx, sk, ct_sum)
    avg = secure.decrypt_average(ctx, sk, ct_sum, 6, spec, meta=meta)
    return dict(bits=bits, ct=ct, ct_sum=ct_sum, res=res, avg=avg, meta=meta,
                kept=[c for c, b in zip(clients, bits.tolist()) if b == 0])


@pytest.mark.cuda
def test_masked_he_half_on_card_equals_cpu(cuda_device):
    # Bitwise: the bits, every client's ciphertext rows (the NaN client's,
    # encoded to 0, and the saturated client's included), the masked sum
    # and its decrypt; K3 once over all six clients' rows, K4 once for the
    # decrypt and once inside decrypt_average. The decoded average within
    # the 5e-6 yardstick of the kept clients' mean.
    want = _masked_half("cpu")
    cuda_ntt.reset_launch_counts()
    got = _masked_half(cuda_device)
    torch.cuda.synchronize(cuda_device)
    rows = cuda_ntt.launch_rows()
    assert rows[("encrypt_fused", 6 * 3 * 3, 1024)] == 1 and rows[("decrypt_fused", 9, 1024)] == 2
    assert torch.equal(got["bits"].cpu(), want["bits"])
    assert got["meta"].surviving == 3 and got["meta"].bits == want["meta"].bits
    for key in ("c0", "c1"):
        assert torch.equal(getattr(got["ct"], key).cpu(), getattr(want["ct"], key))
        assert torch.equal(getattr(got["ct_sum"], key).cpu(), getattr(want["ct_sum"], key))
    assert torch.equal(got["res"].cpu(), want["res"])
    for k, v in got["avg"].items():
        mean = torch.stack([c[k] for c in want["kept"]]).mean(0)
        assert (v.cpu() - mean).abs().max().item() <= 5e-6


@pytest.mark.cuda
def test_encrypt_and_transcipher_at_the_streaming_shapes_on_card(cuda_device):
    # K3 at [220, 3, 4096] (a medical-8 cohort of 4 trains fedavg.cohort_bucket
    # = 4 slots x 55 ciphertexts) and K7 at [294, 3, 256] (journal replay
    # re-transciphers one hhe-smoke upload at a time), each bitwise against
    # its plain version, one launch counted at its shape.
    ctx = _ctx(4096)
    m, u, e0, e1 = (_res(ctx, (220, 3, 4096), 80 + i, cuda_device) for i in range(4))
    b, a = (_res(ctx, (3, 4096), 84 + i, cuda_device) for i in range(2))
    small = _ctx(256)
    w_hi, w_lo, pad0, pad1 = _k7_inputs(small, 294, 882, cuda_device)
    cuda_ntt.reset_launch_counts()
    got = cuda_ntt.encrypt_fused(ctx, m, u, e0, e1, b, a)
    got7 = cuda_ntt.transcipher_fused(small, w_hi, w_lo, pad0, pad1)
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got + got7, cuda_ntt.encrypt_fused_plain(ctx, m, u, e0, e1, b, a)
                    + cuda_ntt.transcipher_fused_plain(small, w_hi, w_lo, pad0, pad1)):
        assert torch.equal(g, w)
    assert cuda_ntt.launch_rows() == {("encrypt_fused", 660, 4096): 1,
                                      ("transcipher_fused", 882, 256): 1}


@pytest.mark.cuda
def test_journaled_crash_recovery_at_n256_is_bitwise_on_card(cuda_device, tmp_path):
    # A journaled streaming run (tau = 1, stragglers carried, a duplicate),
    # its twin crashed mid-append at round 1's 2nd fold, then recovered from
    # the journal alone: the commit sum_sha chain and the final parameters
    # bitwise the uninterrupted run's, on the card (deterministic kernels).
    import dataclasses

    from hefl_tpu_torch import experiment
    from hefl_tpu_torch.fl import journal
    from hefl_tpu_torch.fl.config import StreamConfig, TrainConfig
    from hefl_tpu_torch.fl.faults import CrashConfig, FaultConfig, SimulatedCrash

    cfg = experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=4, rounds=2, n_train=64, n_test=16,
        seed=3, events_path="", he=experiment.HEConfig(n=256),
        train=TrainConfig(epochs=1, batch_size=8, num_classes=10, augment=False,
                          val_fraction=0.25),
        stream=StreamConfig(quorum=0.75, deadline_s=1.0, staleness_rounds=1),
        faults=FaultConfig(seed=3, straggler_fraction=0.25, straggler_delay_s=1.5,
                           arrival_delay_s=1.0, duplicate_clients=1))
    twin = experiment.run_experiment(
        dataclasses.replace(cfg, journal_path=str(tmp_path / "twin.wal")),
        verbose=False, device=cuda_device)
    crash = dataclasses.replace(
        cfg, journal_path=str(tmp_path / "crash.wal"),
        crash=CrashConfig(round=1, at="mid_append", after_folds=2))
    with pytest.raises(SimulatedCrash):
        experiment.run_experiment(crash, verbose=False, device=cuda_device)
    out = experiment.run_experiment(dataclasses.replace(crash, crash=None),
                                    verbose=False, device=cuda_device)
    assert out["journal"]["recovered"]["torn_bytes_truncated"] == 24

    def chain(path):
        return {r["round"]: r["sum_sha"] for r in journal.read_journal(path)
                if r["kind"] == "commit"}

    assert chain(tmp_path / "crash.wal") == chain(tmp_path / "twin.wal") and len(
        chain(tmp_path / "twin.wal")) == 2
    for k, v in twin["params"].items():
        assert torch.equal(out["params"][k], v), k


@pytest.mark.cuda
def test_hierarchical_error_feedback_round_on_card_equals_the_flat_round(cuda_device):
    # A small streaming round with b = 4 error feedback through 4 host
    # tiers on the card: the committed sum, the stream record (hosts aside)
    # and the residual rows bitwise the flat engine's; the residual moved
    # on the cohort's rows only; one K3 launch at the packed rows.
    from hefl_tpu_torch.ckks import keys, packing
    from hefl_tpu_torch.data import partition, synthetic
    from hefl_tpu_torch.experiment import deterministic_algorithms
    from hefl_tpu_torch.fl import stream
    from hefl_tpu_torch.fl.config import PackingConfig, StreamConfig, TrainConfig
    from hefl_tpu_torch.fl.faults import FaultConfig
    from hefl_tpu_torch.models import create_model

    (x, y), _, _ = synthetic.make_dataset("mnist", seed=0, n_train=64, n_test=8)
    xs, ys = (torch.from_numpy(a).to(cuda_device) for a in partition.stack_federated(
        x, y, partition.iid_contiguous(64, 8)))
    model = create_model("smallcnn", device=cuda_device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = keys.CkksContext.create(n=256)
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(21), device=cuda_device)
    spec = packing.PackedSpec.for_params(
        params, ctx, PackingConfig(bits=4, clip=0.05, error_feedback=True), 8)
    cfg = TrainConfig(epochs=1, batch_size=4, num_classes=10, augment=False,
                      val_fraction=0.25, client_fusion="vmap")
    out = {}
    for hosts in (0, 4):
        eng = stream.StreamEngine(
            StreamConfig(cohort_size=4, quorum=0.5, deadline_s=2.0, num_hosts=hosts),
            FaultConfig(seed=5, duplicate_clients=2, arrival_delay_s=1.0))
        cuda_ntt.reset_launch_counts()
        with deterministic_algorithms():
            ct, _, _, sm = eng.run_round(model, cfg, ctx, pk, params, xs, ys,
                                         torch.Generator().manual_seed(22), 0, packing=spec)
        torch.cuda.synchronize(cuda_device)
        assert cuda_ntt.launch_rows() == {("encrypt_fused", 4 * spec.n_ct * 3, 256): 1}
        rec = sm.record()
        assert (rec.pop("hosts", None) is not None) == bool(hosts)
        res = eng._ef_residual
        others = [c for c in range(8) if c not in sm.cohort]
        assert not res[others].any() and res[list(sm.cohort)].any()
        out[hosts] = (stream.ct_hash(ct.c0, ct.c1), rec, res.cpu())
    assert out[0][:2] == out[4][:2] and torch.equal(out[0][2], out[4][2])


@pytest.mark.cuda
@pytest.mark.parametrize("n,num_l", [(4096, 3), (8192, 5), (8192, 3)])
def test_unhoisted_step_products_run_k6_at_one_step_on_card(cuda_device, n, num_l):
    # The unhoisted twin's per-step products on the card (one K6 launch at
    # S = 1, counted at its (S*B*L, N)) against the CPU's int64 products on
    # copies of the same tensors: bitwise.
    from hefl_tpu_torch.ckks import keys, ops

    ctx = keys.CkksContext.create(n=n, num_primes=num_l)
    r = num_l * ctx.ksk_num_digits
    pc0, d = _res(ctx.ntt, (num_l, n), 60), _res(ctx.ntt, (r, num_l, n), 61)
    bk, ak = _res(ctx.ntt, (r + 1, num_l, n), 62), _res(ctx.ntt, (r + 1, num_l, n), 63)
    want = ops.step_key_products(ctx, pc0, d, bk[:r], ak[:r])
    card = [t.to(cuda_device) for t in (pc0, d, bk, ak)]
    cuda_ntt.reset_launch_counts()
    got = ops.step_key_products(ctx, card[0], card[1], card[2][:r], card[3][:r])
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert cuda_ntt.launch_rows() == {("hoisted_products", num_l, n): 1}


@pytest.mark.cuda
def test_encrypt_params_on_card_bitwise_vs_cpu(cuda_device):
    # encrypt_params on the card (one K3 launch over the 55 ciphertexts of
    # MedCNN) against its CPU plain run on the same samples: bitwise.
    from hefl_tpu_torch.ckks import keys, ops
    from hefl_tpu_torch.fl import secure
    from hefl_tpu_torch.models import create_model

    ctx = keys.CkksContext.create()
    params = {k: v.detach() for k, v in create_model("medcnn", device="cpu").named_parameters()}
    _, pk = keys.keygen(ctx, torch.Generator().manual_seed(40), device="cpu")
    samples = ops.encrypt_samples(ctx, torch.Generator().manual_seed(41), (55,), "cpu")
    want = secure.encrypt_params(ctx, pk, params, samples=samples)
    card_pk = keys.PublicKey(b_mont=pk.b_mont.to(cuda_device), a_mont=pk.a_mont.to(cuda_device))
    cuda_ntt.reset_launch_counts()
    got = secure.encrypt_params(ctx, card_pk, {k: v.to(cuda_device) for k, v in params.items()},
                                samples=tuple(s.to(cuda_device) for s in samples))
    torch.cuda.synchronize(cuda_device)
    assert cuda_ntt.launch_rows() == {("encrypt_fused", 55 * 3, 4096): 1}
    assert torch.equal(got.c0.cpu(), want.c0) and torch.equal(got.c1.cpu(), want.c1)
    assert got.scale == want.scale
