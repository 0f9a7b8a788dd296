"""The port's training pieces held against the JAX package on the same inputs.

Augmentation, one Adam step and a short `local_train` are float computations,
so they agree within stated tolerances rather than bitwise: the two packages
use different convolution and reduction orders, and both models compute in
bfloat16. Inputs come from a seed with numpy; the JAX side gets the shuffle
stream it would derive itself, and the port is handed the same one.
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
from hefl_tpu.fl import loss as jloss
from hefl_tpu.fl import metrics as jmetrics
from hefl_tpu.fl import optimizer as jopt
from hefl_tpu.models import create_model as jcreate_model

from hefl_tpu_torch import convert
from hefl_tpu_torch.data import augment, partition, synthetic
from hefl_tpu_torch.fl import client, loss, metrics, optimizer
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.models import SmallCNN

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def smallcnn_jax():
    module, params = jcreate_model("smallcnn", rng=jax.random.key(31))
    return module, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jparams):
    model = SmallCNN()
    model.load_state_dict(convert.from_flax(jparams))
    return model


@pytest.mark.parametrize("name", ["mnist", "medical"])
def test_synthetic_data_and_partition_equal_jax(name):
    # Exact: the port keeps its own copy of the numpy generators.
    kw = dict(seed=5, n_train=24, n_test=8)
    (x, y), (xt, yt), _ = synthetic.make_dataset(name, **kw)
    (jx, jy), (jxt, jyt), _ = jsyn.make_dataset(name, **kw)
    for got, want in ((x, jx), (y, jy), (xt, jxt), (yt, jyt)):
        np.testing.assert_array_equal(got, want)
    parts = partition.iid_contiguous(len(y), 3)
    jparts = jpart.iid_contiguous(len(jy), 3)
    for got, want in zip(partition.stack_federated(x, y, parts),
                         jpart.stack_federated(jx, jy, jparts)):
        np.testing.assert_array_equal(got, want)


def test_classification_metrics_equal_jax():
    # Same host computation on the same labels: equal to float64 rounding.
    rng = np.random.default_rng(6)
    y, pred = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    got, want = metrics.classification_metrics(y, pred), jmetrics.classification_metrics(y, pred)
    for k in ("accuracy", "precision", "recall", "f1"):
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12), k


@pytest.mark.parametrize("hw", [(28, 28), (32, 20)])
def test_apply_affine_matches_jax_gather_backend(hw):
    # Tolerance 1e-5 absolute on [0, 1] pixels: the same bilinear gathers at
    # the same source coordinates; only float32 rounding of tan(s)/zx and of
    # the interpolation weights may differ between the two libraries.
    h, w = hw
    rng = np.random.default_rng(7)
    images = rng.random((6, h, w, 3), dtype=np.float32)
    s = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    zx = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    zy = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    f = np.array([1, -1, 1, -1, -1, 1], np.float32)
    want = np.asarray(jaug.apply_affine(*map(jnp.asarray, (images, s, zx, zy, f)), backend="gather"))
    got = augment.apply_affine(*map(torch.from_numpy, (images, s, zx, zy, f))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_draw_affine_params_ranges():
    # Keras ranges: shear in (-s, s), zooms in (1-z, 1+z), flip sign +-1.
    gen = torch.Generator().manual_seed(8)
    s, zx, zy, f = augment.draw_affine_params(gen, 4096, 0.2, 0.2, True)
    assert s.abs().max() <= 0.2 and ((zx >= 0.8) & (zx <= 1.2)).all()
    assert ((zy >= 0.8) & (zy <= 1.2)).all() and set(f.unique().tolist()) == {-1.0, 1.0}
    assert abs(f.mean().item()) < 0.1
    assert torch.equal(augment.draw_affine_params(gen, 3, 0.2, 0.2, False)[3], torch.ones(3))


def test_adam_update_matches_jax_on_same_grads():
    # Tolerance 2 float32 ulp of the parameter scale: the same elementwise
    # float32 formula; XLA may fuse the division chain differently.
    rng = np.random.default_rng(9)
    params = {"w": rng.normal(size=(64, 16)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(64, 16)).astype(np.float32)} for _ in range(3)]
    jstate, jp = jopt.adam_init(params), {"w": jnp.asarray(params["w"])}
    tstate = optimizer.adam_init({"w": torch.from_numpy(params["w"])})
    tp = {"w": torch.from_numpy(params["w"])}
    for g in grads:
        jp, jstate = jopt.adam_update({"w": jnp.asarray(g["w"])}, jstate, jp, 1e-3, 1e-4, 0.3)
        tp, tstate = optimizer.adam_update({"w": torch.from_numpy(g["w"])}, tstate, tp, 1e-3, 1e-4, 0.3)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0, atol=2 * 2.0**-23 * 4)
    assert tstate.step == int(jstate.step) == 3


def test_one_adam_step_on_same_batch_matches_jax(smallcnn_jax):
    # One SGD step of SmallCNN (loss, gradient, Adam) on the same batch.
    # Tolerance: loss within 1e-2 relative (bf16 forward); parameters within
    # 1.5 * lr of each other, since Adam moves each weight by about lr times
    # sign(g) and a gradient that is tiny next to bf16 noise can flip sign.
    module, jparams = smallcnn_jax
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, (16, 28, 28, 1), dtype=np.uint8)
    y = rng.integers(0, 10, 16)
    onehot = np.eye(10, dtype=np.float32)[y]
    lr = 1e-3

    def jloss_of(p):
        logits = module.apply({"params": p}, jaug.rescale(jnp.asarray(x)))
        return jloss.cross_entropy(logits, jnp.asarray(onehot))

    jl, jg = jax.value_and_grad(jloss_of)(jparams)
    jnew, _ = jopt.adam_update(jg, jopt.adam_init(jparams), jparams, lr, 1e-4, 1.0)

    model = _port_model(jparams)
    leaves = {k: v.detach().requires_grad_(True) for k, v in convert.from_flax(jparams).items()}
    logits = torch.func.functional_call(model, leaves, (augment.rescale(torch.from_numpy(x)),))
    tl = loss.cross_entropy(logits, torch.from_numpy(onehot))
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    tnew, _ = optimizer.adam_update(
        grads, optimizer.adam_init(leaves), {k: v.detach() for k, v in leaves.items()}, lr, 1e-4, 1.0
    )
    assert tl.item() == pytest.approx(float(jl), rel=1e-2)
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, jnew))
    for k in want:
        err = (tnew[k] - want[k]).abs().max().item()
        assert err <= 1.5 * lr, (k, err)


def test_local_train_matches_jax_metric_rows(smallcnn_jax):
    # SmallCNN, 2 epochs, augment off, the JAX package's index stream fed to
    # both. Tolerance: val_loss within 1e-2 absolute and val_acc within one
    # validation sample (bf16 training drifts apart over 8 Adam steps); the
    # lr_scale and stopped columns are discrete callback state and must match.
    module, jparams = smallcnn_jax
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=11, n_train=40, n_test=4)
    kw = dict(epochs=2, batch_size=8, augment=False, num_classes=10, plateau_patience=1)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(12)
    perms, aug_keys = jclient.epoch_index_streams(jcfg, key[None], len(y))
    jtrain = jax.jit(jclient.local_train, static_argnums=(0, 1))
    jparams_out, jmets = jtrain(module, jcfg, jparams, jnp.asarray(x), jnp.asarray(y), key,
                                streams=(perms[0], aug_keys[0]))
    model = _port_model(jparams)
    tparams_out, tmets = client.local_train(
        model, TrainConfig(**kw), convert.from_flax(jparams),
        torch.from_numpy(x), torch.from_numpy(y),
        streams=(torch.from_numpy(np.asarray(perms[0]).astype(np.int64)), None),
    )
    jmets, tmets = np.asarray(jmets), tmets.numpy()
    assert tmets.shape == jmets.shape == (2, 4)
    n_val = len(y) - client.train_batch_geometry(TrainConfig(**kw), len(y))[0]
    np.testing.assert_allclose(tmets[:, 0], jmets[:, 0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tmets[:, 1], jmets[:, 1], rtol=0, atol=1.0 / n_val + 1e-6)
    np.testing.assert_array_equal(tmets[:, 2:], jmets[:, 2:])
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, jparams_out))
    assert want.keys() == tparams_out.keys()
    for k in want:                       # 8 Adam steps move a weight <= ~8 lr
        assert (tparams_out[k] - want[k]).abs().max().item() <= 8e-3, k
