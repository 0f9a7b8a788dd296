"""The fused training backend (`fl.fusion`, `models.folded`) against the JAX
package's and against the port's per-client loop.

  * the folded primitives against `hefl_tpu.models.folded` on the same
    numpy-made inputs, forward and gradients, at the JAX tests' own
    tolerances (`tests/test_fusion.py`), and client independence bitwise;
  * every model's `folded_apply` against its per-client forward at
    `tests/test_fusion.py`'s tolerances;
  * `fused_train` against the per-client loop on the same generators, and
    against the JAX package's `fused_train` fed the same JAX streams, on a
    fixture that exercises the LR plateau and early stopping: equal
    learning-rate ladders and stopped flags, metrics and weights within the
    JAX package's fused-vs-vmap tolerance 2e-2 (`tests/test_perf.py`);
    with a participation mask, a scheduled-out client ships the global
    weights bit for bit and its metrics rows are the JAX fused backend's;
  * backend resolution: pins, the environment, the error on a model without
    `folded_apply`, and "auto" timing once and caching.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.data import augment as jaug
from hefl_tpu.data import partition as jpart
from hefl_tpu.data import synthetic as jsyn
from hefl_tpu.fl import client as jclient
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import fusion as jfusion
from hefl_tpu.models import SmallCNN as JSmallCNN
from hefl_tpu.models import folded as jfolded

from hefl_tpu_torch import convert
from hefl_tpu_torch.fl import fedavg, fusion
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.models import LogReg, MedCNN, ResNet20, SmallCNN, folded

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _from_channels(x: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Channel-folded [B, C*ch, H, W] -> the JAX package's batch-folded NHWC
    [C*B, H, W, ch] (the inverse of `folded.to_channels`)."""
    b, cch, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, h, w, num_clients, cch // num_clients)
    return x.permute(3, 0, 1, 2, 4).reshape(num_clients * b, h, w, cch // num_clients)


# --- the folded primitives against the JAX package's ---------------------------------


@pytest.mark.parametrize("strides,padding", [(1, "VALID"), (2, "SAME")])
def test_folded_conv_matches_jax_forward_and_grads(strides, padding):
    # tests/test_fusion.py's tolerances: forward 1e-2 absolute (bf16 outputs
    # of size ~1), each gradient within 1e-3 of its largest entry.
    c, b, h, w, ch, f = 3, 4, 16, 16, 8, 16
    rng = np.random.default_rng(0)
    kern = (rng.normal(size=(c, 3, 3, ch, f)) * 0.1).astype(np.float32)   # [C, kh, kw, ch, f]
    x = rng.random((c * b, h, w, ch), dtype=np.float32)                   # [C*B, H, W, ch]

    def jfwd(k, xx):
        return jfolded.folded_conv(xx, k, None, num_clients=c, strides=(strides, strides),
                                   padding=padding).astype(jnp.float32)

    want = jfwd(jnp.asarray(kern), jnp.asarray(x))
    jgk, jgx = jax.grad(lambda k, xx: jnp.sum(jfwd(k, xx)), argnums=(0, 1))(
        jnp.asarray(kern), jnp.asarray(x))

    tk = _t(kern).permute(0, 4, 3, 1, 2).contiguous().requires_grad_(True)   # [C, f, ch, kh, kw]
    tx = _t(x).requires_grad_(True)
    out = folded.folded_conv(folded.to_channels(tx, c), tk, None, stride=strides,
                             padding=padding)
    got = _from_channels(out.to(torch.float32), c)
    gk, gx = torch.autograd.grad(got.sum(), (tk, tx))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0, atol=1e-2)
    for g, jg in ((_n(gk.permute(0, 3, 4, 2, 1)), np.asarray(jgk)), (_n(gx), np.asarray(jgx))):
        scale = np.abs(jg).max() + 1e-9
        np.testing.assert_allclose(g / scale, jg / scale, rtol=0, atol=1e-3)


def test_folded_dense_matches_jax_forward_and_grad():
    c, b, d_in, d_out = 3, 5, 24, 7
    rng = np.random.default_rng(1)
    x = rng.normal(size=(c, b, d_in)).astype(np.float32)
    kern = (rng.normal(size=(c, d_in, d_out)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(c, d_out)) * 0.1).astype(np.float32)

    def jfwd(k):
        return jfolded.folded_dense(jnp.asarray(x), k, jnp.asarray(bias)).astype(jnp.float32)

    want, jg = jfwd(jnp.asarray(kern)), jax.grad(lambda k: jnp.sum(jfwd(k)))(jnp.asarray(kern))
    tk = _t(kern).transpose(1, 2).contiguous().requires_grad_(True)          # [C, out, in]
    got = folded.folded_dense(_t(x), tk, _t(bias)).to(torch.float32)
    (gk,) = torch.autograd.grad(got.sum(), (tk,))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0, atol=1e-2)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(_n(gk.transpose(1, 2)) / scale, np.asarray(jg) / scale,
                               rtol=0, atol=1e-3)


def test_folded_group_norm_matches_jax_forward_and_grads():
    # f32 statistics (fast variance, eps 1e-6) on the same inputs: 1e-5 on
    # unit-scale outputs; the affine gradients within 1e-3 of their largest.
    c, b, h, w, f = 3, 2, 6, 5, 16
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(c * b, h, w, f)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=(c, f))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c, f))).astype(np.float32)

    def jfwd(sc, bi):
        return jfolded.folded_group_norm(jnp.asarray(x), sc, bi, num_clients=c, num_groups=8)

    want = jfwd(jnp.asarray(scale), jnp.asarray(bias))
    jgs, jgb = jax.grad(lambda s_, b_: jnp.sum(jfwd(s_, b_) ** 2), argnums=(0, 1))(
        jnp.asarray(scale), jnp.asarray(bias))
    ts, tb = _t(scale).requires_grad_(True), _t(bias).requires_grad_(True)
    out = folded.folded_group_norm(folded.to_channels(_t(x), c), ts, tb, num_groups=8)
    got = _from_channels(out, c)
    gs, gb = torch.autograd.grad((got ** 2).sum(), (ts, tb))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=0, atol=1e-5)
    for g, jg in ((gs, jgs), (gb, jgb)):
        s_ = np.abs(np.asarray(jg)).max()
        np.testing.assert_allclose(_n(g) / s_, np.asarray(jg) / s_, rtol=0, atol=1e-3)


def test_folded_conv_clients_are_independent():
    # Perturbing client 1's input leaves clients 0 and 2 bitwise untouched.
    c, b = 3, 4
    rng = np.random.default_rng(3)
    kern = _t(rng.normal(size=(c, 8, 2, 3, 3)) * 0.1)
    x = _t(rng.random((c * b, 12, 12, 2)))

    def run(xx):
        return _from_channels(folded.folded_conv(folded.to_channels(xx, c), kern, None),
                                    c).to(torch.float32)

    base = run(x)
    x2 = x.clone()
    x2[b:2 * b] *= 3.0
    pert = run(x2)
    assert torch.equal(base[:b], pert[:b]) and torch.equal(base[2 * b:], pert[2 * b:])
    assert not torch.equal(base[b:2 * b], pert[b:2 * b])


def test_same_padding_is_xla_s():
    # SAME at stride 2 pads (0, 1) on even sizes, not PyTorch's (1, 1).
    assert folded.same_padding(32, 3, 2) == (0, 1)
    assert folded.same_padding(32, 3, 1) == (1, 1)
    assert folded.same_padding(32, 1, 2) == (0, 0)
    assert folded.same_padding(7, 3, 2) == (1, 1)


# --- folded_apply against the per-client forward -------------------------------------


def _stacked(model, c):
    """Distinct per-client weights: the fused forward must be exact for
    diverged clients, not only for the round's identical entry."""
    p = {k: v.detach() for k, v in model.named_parameters()}
    return {k: torch.stack([v * (1 + 0.05 * i) for i in range(c)]) for k, v in p.items()}


@pytest.mark.parametrize("make,shape,atol", [
    (lambda: SmallCNN(), (28, 28, 1), 1e-4),
    (lambda: LogReg(), (28, 28, 1), 1e-6),
    # 20 bf16 layers: reduction-order drift, not approximation.
    (lambda: ResNet20(), (32, 32, 3), 5e-2),
    (lambda: MedCNN(), (256, 256, 3), 5e-3),
], ids=["smallcnn", "logreg", "resnet20", "medcnn"])
def test_folded_apply_matches_the_per_client_forward(make, shape, atol):
    model = make()
    model.reset_parameters(torch.Generator().manual_seed(5))
    c, b = (2, 1) if shape[0] == 256 else (3, 4)
    stacked = _stacked(model, c)
    x = torch.rand((c, b) + shape, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = folded.unfold_clients(model.folded_apply(stacked, folded.fold_clients(x), c), c)
        want = torch.stack([torch.func.functional_call(
            model, {k: v[i] for k, v in stacked.items()}, (x[i],)) for i in range(c)])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_n(got), _n(want), rtol=0, atol=atol)


# --- fused training ------------------------------------------------------------------

# Patience tight enough that the fixture exercises plateau and early stop,
# the per-client semantics the fused backend must keep (tests/test_perf.py).
FUSE_KW = dict(epochs=4, batch_size=8, num_classes=10, augment=True, val_fraction=0.25,
               es_patience=2, plateau_patience=1)


@pytest.fixture(scope="module")
def block():
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=3, n_train=4 * 40, n_test=16)
    xs, ys = jpart.stack_federated(x, y, jpart.iid_contiguous(len(x), 4))
    module = JSmallCNN(num_classes=10)
    params = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])
    model = SmallCNN()
    model.load_state_dict(convert.from_flax(params))
    return module, params, model, xs, ys


def _assert_same_training(mets_a, p_a, mets_b, p_b, tol=2e-2):
    mets_a, mets_b = np.asarray(mets_a), np.asarray(mets_b)
    np.testing.assert_array_equal(mets_a[:, :, 2], mets_b[:, :, 2])     # lr ladder
    np.testing.assert_array_equal(mets_a[:, :, 3], mets_b[:, :, 3])     # stopped
    np.testing.assert_allclose(mets_a[:, :, :2], mets_b[:, :, :2], rtol=0, atol=tol)
    assert len(p_a) == len(p_b)
    for a, b in zip(p_a, p_b):
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] - b[k]).abs().max().item() <= tol, k


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_fused_train_matches_the_per_client_loop(block, prox_mu):
    # The same generators give the same batches and affines on both paths.
    _, _, model, xs, ys = block
    cfg = TrainConfig(**FUSE_KW, prox_mu=prox_mu)
    params = {k: v.detach() for k, v in model.named_parameters()}
    xs_t, ys_t = torch.from_numpy(xs), torch.from_numpy(ys)

    def gens():
        return [torch.Generator().manual_seed(40 + i) for i in range(len(xs))]

    p_loop, m_loop = fedavg.train_clients(model, cfg, params, xs_t, ys_t, gens=gens())
    p_fused, m_fused = fusion.fused_train(model, cfg, params, xs_t, ys_t, gens=gens())
    assert tuple(m_fused.shape) == (4, 4, 4) and m_fused.dtype == torch.float32
    assert bool(m_loop[:, :, 3].any()), "the fixture must exercise early stopping"
    assert len(set(m_loop[:, :, 2].flatten().tolist())) > 1, "and the LR plateau"
    _assert_same_training(m_loop, p_loop, m_fused, p_fused)


def test_fused_train_matches_jax_fused_train_on_its_streams(block):
    # JAX's fused_train fed its own hoisted streams (streams_blk); the port's
    # fed the same permutations and the affines JAX draws from its augment
    # keys (the gather warp on both sides).
    module, params, model, xs, ys = block
    jcfg = jconfig.TrainConfig(**FUSE_KW, aug_backend="gather")
    keys = jax.random.split(jax.random.key(7), len(xs))
    perms, aug_keys = jclient.epoch_index_streams(jcfg, keys, xs.shape[1])
    pj, mj = jax.jit(lambda p: jfusion.fused_train(
        module, jcfg, p, jnp.asarray(xs), jnp.asarray(ys), keys,
        streams_blk=(perms, aug_keys)))(params)
    grp = perms.shape[-1]
    affines = jax.vmap(jax.vmap(lambda k: jaug.draw_affine_params(
        k, grp, jcfg.aug_shear, jcfg.aug_zoom, jcfg.aug_flip)))(aug_keys)
    streams = [(torch.from_numpy(np.asarray(perms[c]).astype(np.int64)),
                tuple(torch.from_numpy(np.array(a[c])) for a in affines))
               for c in range(len(xs))]
    pt, mt = fusion.fused_train(model, TrainConfig(**FUSE_KW, aug_backend="gather"),
                                convert.from_flax(params),
                                torch.from_numpy(xs), torch.from_numpy(ys), streams=streams)
    want = [convert.from_flax({k: jax.tree_util.tree_map(lambda a: np.asarray(a)[c], v)
                               for k, v in pj.items()}) for c in range(len(xs))]
    _assert_same_training(np.asarray(mj), want, mt, pt)


def _jax_streams(jcfg, xs, seed):
    keys = jax.random.split(jax.random.key(seed), len(xs))
    perms, aug_keys = jclient.epoch_index_streams(jcfg, keys, xs.shape[1])
    grp = perms.shape[-1]
    affines = jax.vmap(jax.vmap(lambda k: jaug.draw_affine_params(
        k, grp, jcfg.aug_shear, jcfg.aug_zoom, jcfg.aug_flip)))(aug_keys)
    streams = [(torch.from_numpy(np.asarray(perms[c]).astype(np.int64)),
                tuple(torch.from_numpy(np.array(a[c])) for a in affines))
               for c in range(len(xs))]
    return keys, (perms, aug_keys), streams


def test_fused_participation_ships_global_weights_and_matches_jax(block):
    # The masked round's mask: client 1 scheduled out. Its rows flow through
    # every folded step, its updates are no-ops: it ships the global weights
    # bit for bit, its callback rows are JAX's, and the other clients train
    # as the JAX fused backend's within the fused tolerance.
    module, params, model, xs, ys = block
    part = np.array([1, 0, 1, 1], np.int32)
    jcfg = jconfig.TrainConfig(**FUSE_KW, aug_backend="gather")
    keys, streams_blk, streams = _jax_streams(jcfg, xs, 8)
    pj, mj = jax.jit(lambda p: jfusion.fused_train(
        module, jcfg, p, jnp.asarray(xs), jnp.asarray(ys), keys,
        participation=jnp.asarray(part), streams_blk=streams_blk))(params)
    gp = convert.from_flax(params)
    pt, mt = fusion.fused_train(model, TrainConfig(**FUSE_KW, aug_backend="gather"), gp,
                                torch.from_numpy(xs),
                                torch.from_numpy(ys), streams=streams, participation=part)
    assert all(torch.equal(pt[1][k], gp[k]) for k in gp)
    want = [convert.from_flax({k: jax.tree_util.tree_map(lambda a: np.asarray(a)[c], v)
                               for k, v in pj.items()}) for c in range(len(xs))]
    assert all(torch.equal(want[1][k], gp[k]) for k in gp)
    _assert_same_training(np.asarray(mj), want, mt, pt)
    moved = [max((pt[c][k] - gp[k]).abs().max().item() for k in gp) for c in (0, 2, 3)]
    assert min(moved) > 1e-4


@pytest.mark.parametrize("backend", ["fused", "vmap"])
def test_train_block_dispatches_on_the_configured_backend(block, backend):
    _, _, model, xs, ys = block
    cfg = TrainConfig(**dict(FUSE_KW, epochs=1), client_fusion=backend)
    params = {k: v.detach() for k, v in model.named_parameters()}
    xs_t, ys_t = torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2])

    def gens():
        return [torch.Generator().manual_seed(50 + i) for i in range(2)]

    got = fedavg.train_block(model, cfg, params, xs_t, ys_t, gens=gens())
    ref = (fusion.fused_train if backend == "fused" else fedavg.train_clients)(
        model, cfg, params, xs_t, ys_t, gens=gens())
    assert torch.equal(got[1], ref[1])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got[0], ref[0]) for k in a)


# --- backend resolution --------------------------------------------------------------


class _NoFold(torch.nn.Module):
    pass


def test_resolve_fusion_backend_pins_env_and_errors(monkeypatch):
    model = SmallCNN()
    assert fusion.resolve_fusion_backend("vmap", model) == "vmap"
    assert fusion.resolve_fusion_backend("fused", model) == "fused"
    with pytest.raises(ValueError, match="fancy"):
        fusion.resolve_fusion_backend("fancy", model)
    with pytest.raises(ValueError, match="folded_apply"):
        fusion.resolve_fusion_backend("fused", _NoFold())
    monkeypatch.delenv("HEFL_CLIENT_FUSION", raising=False)
    assert fusion.resolve_fusion_backend("auto", _NoFold()) == "vmap"
    # the environment is read only in auto mode
    monkeypatch.setenv("HEFL_CLIENT_FUSION", "vmap")
    assert fusion.resolve_fusion_backend("auto", model) == "vmap"
    assert fusion.resolve_fusion_backend("fused", model) == "fused"
    monkeypatch.setenv("HEFL_CLIENT_FUSION", "fused")
    assert fusion.resolve_fusion_backend(None, model) == "fused"
    assert fusion.fusion_report()["requested"] == "fused"


def test_auto_times_once_and_caches(monkeypatch):
    # The probe geometry shrunk, the timer counted: the first "auto" times
    # both backends, later ones on the same device reuse the winner.
    monkeypatch.delenv("HEFL_CLIENT_FUSION", raising=False)
    monkeypatch.setattr(fusion, "_AUTO_CHOICE", {})
    monkeypatch.setattr(fusion, "_AUTO_TIMINGS_MS", None)
    monkeypatch.setattr(fusion, "_PROBE_CLIENTS", 2)
    monkeypatch.setattr(fusion, "_PROBE_BATCH", 2)
    monkeypatch.setattr(fusion, "_PROBE_HW", 12)
    timed = []
    real = fusion._time_backend

    def counted(fn, device):
        timed.append(device)
        return real(fn, device)

    monkeypatch.setattr(fusion, "_time_backend", counted)
    chosen = fusion.resolve_fusion_backend("auto", SmallCNN(), "cpu")
    assert chosen in fusion.FUSION_BACKENDS and len(timed) == 2
    assert fusion.resolve_fusion_backend("auto", LogReg(), "cpu") == chosen and len(timed) == 2
    rep = fusion.fusion_report()
    assert rep["backend"] == chosen and set(rep["auto_timings_ms"]) == set(fusion.FUSION_BACKENDS)
    assert rep.keys() == jfusion.fusion_report().keys() and rep["auto_persisted"] is False


def test_fused_pin_on_a_model_without_folded_apply_fails_the_round(block):
    _, _, _, xs, ys = block
    cfg = TrainConfig(**dict(FUSE_KW, epochs=1), client_fusion="fused")
    with pytest.raises(ValueError, match="folded_apply"):
        fedavg.train_block(_NoFold(), cfg, {}, torch.from_numpy(xs), torch.from_numpy(ys),
                           gens=[torch.Generator()] * len(xs))


def test_stack_and_fold_layouts():
    x = torch.arange(2 * 3 * 4 * 5 * 6, dtype=torch.float32).reshape(2, 3, 4, 5, 6)
    f = folded.fold_clients(x)
    assert f.shape == (6, 4, 5, 6) and torch.equal(folded.unfold_clients(f, 2), x)
    assert torch.equal(f[3], x[1, 0])
    ch = folded.to_channels(f, 2)
    assert ch.shape == (3, 12, 4, 5) and torch.equal(_from_channels(ch, 2), f)
    assert torch.equal(ch[0, 6:], x[1, 0].permute(2, 0, 1))
    st = folded.stack_params({"w": torch.ones(2, 3)}, 4)
    assert st["w"].shape == (4, 2, 3) and st["w"].is_contiguous()
