"""TrainConfig's last three fields and `data/batches.py`, held against the
JAX package on the same inputs.

  * the augment's row-shift backends (`gather`, `fft`, `dft`): the shifts
    and the whole `apply_affine` against the JAX functions on the same fed
    (s, zx, zy, f), and the JAX package's own properties per backend;
  * the backend's resolution (override > HEFL_AUG_SHIFT > auto), the
    auto probe persisted and read back as a cache hit;
  * `accum_steps`: the batch geometry over a grid, accum k at batch b
    bitwise accum 1 at batch k*b, the JAX-streamed run, fused against the
    per-client loop, the clamp on tiny clients;
  * `flat_scan`: both values train alike, and the JAX refusal of a cohort
    gather under the per-client backend;
  * `Batcher` / `one_hot`, and every config field with the JAX default.

Tolerances: the shifts and the spectral warps within 2e-5 absolute (the JAX
package's own dft/fft agreement, tests/test_data.py), the gather warp
within 1e-5 (tests/test_torch_train.py); trained weights as
tests/test_torch_train.py and tests/test_torch_fusion.py hold them.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.data import augment as jaug
from hefl_tpu.data import batches as jbatches
from hefl_tpu.data import synthetic as jsyn
from hefl_tpu.fl import client as jclient
from hefl_tpu.fl import config as jconfig
from hefl_tpu.models import create_model as jcreate_model

from hefl_tpu_torch import convert, experiment
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.data import Batcher, augment, one_hot
from hefl_tpu_torch.data.partition import iid_contiguous, stack_federated
from hefl_tpu_torch.fl import client, fedavg, fusion, stream
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.models import LogReg, SmallCNN
from hefl_tpu_torch.utils import autoselect

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BACKENDS = augment.SHIFT_BACKENDS


@pytest.fixture
def fresh_augment(monkeypatch):
    """The augment module's process-global selection state cleared for one
    test (restored after it), HEFL_AUG_SHIFT's value at "auto"."""
    monkeypatch.setattr(augment, "_AUTO_CHOICE", {})
    monkeypatch.setattr(augment, "_AUTO_TIMINGS_MS", None)
    monkeypatch.setattr(augment, "_AUTO_PERSISTED", False)
    monkeypatch.setattr(augment, "_LAST_RESOLVED", None)
    monkeypatch.setattr(augment, "_ENV_BACKEND", "auto")


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """Persistence on, into a temporary directory."""
    monkeypatch.setenv("HEFL_AUTOSELECT_CACHE", "1")
    monkeypatch.setattr(autoselect, "DEFAULT_DIR", tmp_path)
    return tmp_path


def _affine_inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((b, h, w, 3), dtype=np.float32)
    s = rng.uniform(-0.2, 0.2, b).astype(np.float32)
    zx = rng.uniform(0.8, 1.2, b).astype(np.float32)
    zy = rng.uniform(0.8, 1.2, b).astype(np.float32)
    f = np.where(rng.random(b) < 0.5, -1.0, 1.0).astype(np.float32)
    return images, s, zx, zy, f


# --- the row shifts and the warp ----------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_shift_rows_match_jax(backend):
    rng = np.random.default_rng(7)
    x = rng.random((3, 8, 32, 2), dtype=np.float32)
    delta = rng.uniform(-6.0, 6.0, (3, 8)).astype(np.float32)
    want = np.asarray(jaug._SHIFT_FNS[backend](jnp.asarray(x), jnp.asarray(delta)))
    got = augment._SHIFT_FNS[backend](torch.from_numpy(x), torch.from_numpy(delta))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_dft_shift_matches_the_fft_shift():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((3, 8, 32, 2), dtype=np.float32))
    delta = torch.from_numpy(rng.uniform(-6.0, 6.0, (3, 8)).astype(np.float32))
    np.testing.assert_allclose(augment._shift_rows_dft(x, delta).numpy(),
                               augment._shift_rows_fft(x, delta).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("hw", [(28, 28), (32, 20)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_affine_matches_jax(backend, hw):
    inputs = _affine_inputs(6, *hw, seed=9)
    want = np.asarray(jaug.apply_affine(*map(jnp.asarray, inputs), backend=backend))
    got = augment.apply_affine(*map(torch.from_numpy, inputs), backend=backend).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if backend == "gather" else 2e-5)


def test_gather_backend_is_the_default_warp_bitwise():
    inputs = tuple(map(torch.from_numpy, _affine_inputs(4, 20, 24, seed=10)))
    assert torch.equal(augment.apply_affine(*inputs), augment.apply_affine(*inputs, "gather"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_augment_keeps_shape_range_and_identity(backend):
    # tests/test_data.py's properties, per backend.
    gen = torch.Generator().manual_seed(0)
    imgs = torch.rand((4, 16, 16, 3), generator=gen)
    out = augment.random_augment(gen, imgs, backend=backend)
    assert out.shape == imgs.shape
    assert out.min().item() >= -1e-5 and out.max().item() <= 1.0 + 1e-5
    ident = augment.random_augment(gen, imgs, shear=0.0, zoom=0.0, flip=False, backend=backend)
    np.testing.assert_allclose(ident.numpy(), imgs.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_augment_flip_only_is_a_mirror(backend):
    src = torch.arange(16.0).reshape(1, 4, 4, 1) / 16.0
    out = augment.random_augment(torch.Generator().manual_seed(1), src.repeat(8, 1, 1, 1),
                                 shear=0.0, zoom=0.0, backend=backend)
    mirrors = 0
    for row in out:
        same = torch.allclose(row, src[0], atol=1e-5)
        mirrored = torch.allclose(row, src[0].flip(1), atol=1e-5)
        assert same or mirrored
        mirrors += mirrored
    assert 0 < mirrors < 8


# --- resolution ---------------------------------------------------------------------


def test_resolution_priority_and_refusal(fresh_augment, monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed although the backend was pinned")

    monkeypatch.setattr(augment, "_autoselect_backend", no_probe)
    monkeypatch.setattr(augment, "_ENV_BACKEND", "dft")
    assert augment.resolve_shift_backend("fft") == "fft"          # override > env
    assert augment.resolve_shift_backend(None) == "dft"           # env > auto
    assert augment.backend_report() == {"requested": "dft", "backend": "dft",
                                        "auto_timings_ms": None, "auto_persisted": False}
    with pytest.raises(ValueError, match="augment shift backend 'fancy'"):
        augment.resolve_shift_backend("fancy")
    monkeypatch.setattr(augment, "_ENV_BACKEND", "fancy")
    with pytest.raises(ValueError, match="expected one of"):
        augment.resolve_shift_backend(None)


def test_backend_report_has_the_jax_keys(fresh_augment):
    assert augment.backend_report().keys() == jaug.backend_report().keys()
    assert augment.backend_report()["backend"] is None          # nothing resolved yet
    augment.resolve_shift_backend("gather")
    assert augment.backend_report()["backend"] == "gather"


def test_auto_probe_persists_and_a_second_process_hits(fresh_augment, cache_dir, monkeypatch):
    # The live probe at _PROBE_SHAPE on the CPU, then, with the in-process
    # choice cleared (a fresh process), the winner read back from the file.
    winner = augment.resolve_shift_backend(None, "cpu")
    rep = augment.backend_report()
    assert winner in BACKENDS and rep["backend"] == winner and rep["auto_persisted"] is False
    assert set(rep["auto_timings_ms"]) == set(BACKENDS)
    assert winner == min(rep["auto_timings_ms"], key=rep["auto_timings_ms"].get)
    assert autoselect.load_winner("augment_shift", "cpu") == {
        "winner": winner, "timings_ms": rep["auto_timings_ms"]}

    def no_probe(*a, **k):
        raise AssertionError("probed although a winner was persisted")

    monkeypatch.setattr(augment, "_time_backend", no_probe)
    monkeypatch.setattr(augment, "_AUTO_CHOICE", {})
    monkeypatch.setattr(augment, "_AUTO_TIMINGS_MS", None)
    assert augment.resolve_shift_backend(None, "cpu") == winner
    hit = augment.backend_report()
    assert hit["auto_persisted"] is True and hit["auto_timings_ms"] == rep["auto_timings_ms"]


def test_auto_picks_the_fastest_and_rejects_a_stale_winner(fresh_augment, cache_dir,
                                                            monkeypatch):
    autoselect.store_winner("augment_shift", "cpu", "renamed", {"renamed": 0.1})
    times = iter([3.0, 1.0, 2.0])            # gather, fft, dft in SHIFT_BACKENDS order
    monkeypatch.setattr(augment, "_time_backend", lambda fn, device: next(times))
    assert augment.resolve_shift_backend("auto", "cpu") == "fft"
    assert augment.backend_report()["auto_timings_ms"] == {"gather": 3000.0, "fft": 1000.0,
                                                           "dft": 2000.0}


# --- accum_steps --------------------------------------------------------------------


@pytest.mark.parametrize("val_fraction", [0.0, 0.1])
def test_batch_geometry_equals_jax_over_a_grid(val_fraction):
    for accum in range(1, 5):
        for bs in range(1, 33):
            kw = dict(batch_size=bs, accum_steps=accum, val_fraction=val_fraction)
            cfg, jcfg = TrainConfig(**kw), jconfig.TrainConfig(**kw)
            for n in range(2, 201):
                assert (client.train_batch_geometry(cfg, n)
                        == jclient.train_batch_geometry(jcfg, n)), (kw, n)


def test_accum_steps_clamps_on_tiny_clients():
    # tests/test_perf.py's case: accum 8 at batch 16 on 24 samples takes one
    # step of one batch (the accumulation clamps, never starves).
    cfg = TrainConfig(batch_size=16, accum_steps=8, val_fraction=0.1)
    n_tr, grp, steps = client.train_batch_geometry(cfg, 24)
    assert (n_tr, grp, steps) == (22, 16, 1)


@pytest.fixture(scope="module")
def mnist():
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=11, n_train=40, n_test=4)
    model = SmallCNN()
    model.reset_parameters(torch.Generator().manual_seed(3))
    return model, torch.from_numpy(x), torch.from_numpy(y)


def _params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("backend", BACKENDS)
def test_accum_2_at_batch_8_is_accum_1_at_batch_16_bitwise(mnist, backend):
    model, x, y = mnist
    base = dict(epochs=2, num_classes=10, aug_backend=backend)
    runs = [client.local_train(model, TrainConfig(**base, **kw), _params(model), x, y,
                               gen=torch.Generator().manual_seed(5))
            for kw in (dict(batch_size=8, accum_steps=2), dict(batch_size=16))]
    (p_a, m_a), (p_b, m_b) = runs
    assert _equal(p_a, p_b) and torch.equal(m_a, m_b)


def test_accum_2_on_jax_streams_matches_the_jax_local_train():
    # tests/test_torch_train.py's comparison at accum 2: augment off, the JAX
    # index stream (16 samples a step) fed to both.
    module, jparams = jcreate_model("smallcnn", rng=jax.random.key(31))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=11, n_train=40, n_test=4)
    kw = dict(epochs=2, batch_size=8, accum_steps=2, augment=False, num_classes=10,
              plateau_patience=1)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(12)
    perms, aug_keys = jclient.epoch_index_streams(jcfg, key[None], len(y))
    assert perms.shape[-1] == 16
    jtrain = jax.jit(jclient.local_train, static_argnums=(0, 1))
    jparams_out, jmets = jtrain(module, jcfg, jparams, jnp.asarray(x), jnp.asarray(y), key,
                                streams=(perms[0], aug_keys[0]))
    model = SmallCNN()
    model.load_state_dict(convert.from_flax(jparams))
    cfg = TrainConfig(**kw)
    tparams_out, tmets = client.local_train(
        model, cfg, convert.from_flax(jparams), torch.from_numpy(x), torch.from_numpy(y),
        streams=(torch.from_numpy(np.asarray(perms[0]).astype(np.int64)), None))
    jmets, tmets = np.asarray(jmets), tmets.numpy()
    n_val = len(y) - client.train_batch_geometry(cfg, len(y))[0]
    np.testing.assert_allclose(tmets[:, 0], jmets[:, 0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tmets[:, 1], jmets[:, 1], rtol=0, atol=1.0 / n_val + 1e-6)
    np.testing.assert_array_equal(tmets[:, 2:], jmets[:, 2:])
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, jparams_out))
    for k in want:
        assert (tparams_out[k] - want[k]).abs().max().item() <= 8e-3, k


def test_fused_matches_the_per_client_loop_at_accum_2():
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=3, n_train=4 * 40, n_test=16)
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 4))
    model = SmallCNN()
    model.reset_parameters(torch.Generator().manual_seed(0))
    cfg = TrainConfig(epochs=3, batch_size=4, accum_steps=2, augment=False, num_classes=10,
                      val_fraction=0.25, es_patience=2, plateau_patience=1)
    gens = lambda: [torch.Generator().manual_seed(40 + i) for i in range(4)]  # noqa: E731
    args = (model, cfg, _params(model), torch.from_numpy(xs), torch.from_numpy(ys))
    p_loop, m_loop = fedavg.train_clients(*args, gens=gens())
    p_fused, m_fused = fusion.fused_train(*args, gens=gens())
    np.testing.assert_array_equal(m_loop[:, :, 2:].numpy(), m_fused[:, :, 2:].numpy())
    np.testing.assert_allclose(m_loop[:, :, :2].numpy(), m_fused[:, :, :2].numpy(), rtol=0,
                               atol=2e-2)
    for a, b in zip(p_loop, p_fused):
        for k in a:
            assert (a[k] - b[k]).abs().max().item() <= 2e-2, k


# --- flat_scan ----------------------------------------------------------------------


def test_flat_scan_values_train_alike_bitwise(mnist):
    # TrainConfig(accum_steps=2, aug_backend="fft", flat_scan=False) trains,
    # bitwise its flat_scan=True twin.
    model, x, y = mnist
    runs = [client.local_train(model, TrainConfig(epochs=2, batch_size=8, accum_steps=2,
                                                  num_classes=10, aug_backend="fft",
                                                  flat_scan=flat),
                               _params(model), x, y, gen=torch.Generator().manual_seed(6))
            for flat in (True, False)]
    assert _equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_hoist_streams_is_the_jax_predicate():
    for flat in (True, False):
        for backend in ("fused", "vmap"):
            assert client.hoist_streams(TrainConfig(flat_scan=flat), backend) == \
                jclient.hoist_streams(jconfig.TrainConfig(flat_scan=flat), backend)


@pytest.fixture(scope="module")
def logreg_round():
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=4, n_train=3 * 12, n_test=4)
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 3))
    model = LogReg()
    model.reset_parameters(torch.Generator().manual_seed(1))
    ctx = experiment.HEConfig(n=256).build()
    sk, pk = keys.keygen(ctx, torch.Generator().manual_seed(2), device="cpu")
    return model, ctx, pk, torch.from_numpy(xs), torch.from_numpy(ys)


def test_cohort_gather_without_flat_scan_is_refused_under_the_per_client_backend(
        logreg_round):
    model, ctx, pk, xs, ys = logreg_round
    cfg = TrainConfig(epochs=1, batch_size=4, num_classes=10, augment=False,
                      client_fusion="vmap", flat_scan=False)
    with pytest.raises(ValueError, match="flat_scan"):
        stream.produce_uploads(model, cfg, None, ctx, pk, _params(model), xs, ys,
                               torch.Generator().manual_seed(3), cohort=np.array([0, 2]))
    # The full-C producer accepts it, and trains as flat_scan=True does.
    outs = [stream.produce_uploads(model, dataclasses.replace(cfg, flat_scan=flat), None, ctx,
                                   pk, _params(model), xs, ys, torch.Generator().manual_seed(3))
            for flat in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip((outs[0][0].c0, outs[0][0].c1, outs[0][1]),
                                                 (outs[1][0].c0, outs[1][0].c1, outs[1][1])))


# --- Batcher / one_hot --------------------------------------------------------------


@pytest.mark.parametrize("n,bs", [(103, 10), (7, 10), (32, 32), (33, 8)])
def test_batcher_plans_equal_jax(n, bs):
    b, jb = Batcher(n, bs), jbatches.Batcher(n, bs)
    assert b.steps_per_epoch == jb.steps_per_epoch
    np.testing.assert_array_equal(b.epoch_indices_eval(), jb.epoch_indices_eval())
    plan = b.epoch_indices(torch.Generator().manual_seed(0))
    assert plan.dtype == torch.int64
    assert tuple(plan.shape) == tuple(jb.epoch_indices(jax.random.key(0)).shape)
    flat = plan.flatten().tolist()
    assert len(set(flat)) == len(flat) and set(flat) <= set(range(n))


def test_one_hot_equals_jax():
    labels = np.array([0, 2, 1, 3, -1, 4], np.int64)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(labels), 4, dtype=jnp.float32))
    got = one_hot(torch.from_numpy(labels), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jbatches.one_hot(jnp.asarray(labels), 4)), want)


# --- the config surface -------------------------------------------------------------


def _fields(path: Path, cls: str) -> dict:
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {n.target.id: None if n.value is None else ast.unparse(n.value)
                    for n in node.body if isinstance(n, ast.AnnAssign)}
    raise AssertionError(f"{path} has no class {cls}")


@pytest.mark.parametrize("rel,cls", [
    ("fl/config.py", "TrainConfig"), ("fl/config.py", "StreamConfig"),
    ("experiment.py", "ExperimentConfig"), ("experiment.py", "HEConfig"),
])
def test_every_jax_config_field_exists_with_its_default(rel, cls):
    want = _fields(REPO / "hefl_tpu" / rel, cls)
    got = _fields(REPO / "hefl_tpu_torch" / rel, cls)
    assert want and got == want


def test_train_config_refuses_an_unknown_backend_and_accum_below_1():
    TrainConfig(accum_steps=2, aug_backend="fft", flat_scan=False)
    for backend in BACKENDS + ("auto", None):
        TrainConfig(aug_backend=backend)
    with pytest.raises(ValueError, match="aug_backend='fancy'"):
        TrainConfig(aug_backend="fancy")
    with pytest.raises(ValueError, match="accum_steps=0"):
        TrainConfig(accum_steps=0)


def test_run_experiment_records_the_pinned_backend(fresh_augment):
    cfg = experiment.ExperimentConfig(
        model="smallcnn", dataset="mnist", num_clients=2, rounds=1, encrypted=False,
        n_train=48, n_test=8, seed=3,
        train=TrainConfig(epochs=1, batch_size=4, accum_steps=2, aug_backend="dft",
                          num_classes=10, val_fraction=0.25))
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    assert out["augment_backend"] == {"requested": "auto", "backend": "dft",
                                      "auto_timings_ms": None, "auto_persisted": False}
    assert out["augment_backend"] == augment.backend_report()
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["val_loss"]).all()


@pytest.mark.parametrize("total,n", [(5, 4), (8, 4), (300, 256)])
def test_pack_flat_equals_jax(total, n):
    from hefl_tpu.ckks import packing as jpacking

    from hefl_tpu_torch.ckks import packing

    flat = np.random.default_rng(total).normal(size=total).astype(np.float32)
    want = np.asarray(jpacking.pack_flat(jnp.asarray(flat), n))
    np.testing.assert_array_equal(packing.pack_flat(torch.from_numpy(flat), n).numpy(), want)
