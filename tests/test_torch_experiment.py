"""The port's experiment driver, presets and CLI against the JAX package's.

Deterministic pieces are held bitwise (partitions, preset configs, the CLI's
flag mapping, CKKS geometry); the training pieces within the tolerances of
`tests/test_torch_train.py`, fed the JAX package's index streams; and whole
runs by the round record's schema, the encode-overflow lists and the
decrypted average's error. jax.random streams cannot be reproduced in
torch, so two runs' histories are not compared number for number.

The JAX side runs the tiny config of `tests/test_experiment.py` (N = 256).
Its encrypted run stubs out the JAX package's pre-flight certifier, which
needs `jax.experimental.enable_x64`, removed in JAX 0.9 (ROADMAP caveat
R1); the run itself is unchanged.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hefl_tpu.analysis as janalysis
from hefl_tpu import cli as jcli
from hefl_tpu import experiment as jexp
from hefl_tpu import presets as jpresets
from hefl_tpu.ckks.packing import PackSpec as JPackSpec
from hefl_tpu.data import partition as jpart
from hefl_tpu.data import synthetic as jsyn
from hefl_tpu.fl import client as jclient
from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import dp as jdp
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.fl import loss as jloss
from hefl_tpu.models import create_model as jcreate_model

from hefl_tpu_torch import cli, convert, experiment, presets
from hefl_tpu_torch.ckks import keys
from hefl_tpu_torch.ckks.packing import PackSpec
from hefl_tpu_torch.data import partition, synthetic
from hefl_tpu_torch.data.augment import rescale
from hefl_tpu_torch.fl import client, fedavg, loss, secure
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.dp import DpConfig, epsilon_spent
from hefl_tpu_torch.fl.faults import FaultConfig
from hefl_tpu_torch.models import LogReg, SmallCNN, count_params, create_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(model="smallcnn", dataset="mnist", num_clients=2, rounds=2, he_n=256,
            n_train=64, n_test=32, seed=3)
TINY_TRAIN = dict(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25)


def _tiny(pkg, **kw):
    """`tests/test_experiment.py`'s `_tiny_cfg` in either package."""
    base = {k: v for k, v in TINY.items() if k != "he_n"}
    base.update(train=pkg.TrainConfig(**TINY_TRAIN), he=pkg.HEConfig(n=TINY["he_n"]))
    base.update(kw)
    return pkg.ExperimentConfig(**base)


class _J:
    ExperimentConfig, HEConfig, TrainConfig = jexp.ExperimentConfig, jexp.HEConfig, jconfig.TrainConfig


class _T:
    ExperimentConfig, HEConfig, TrainConfig = (experiment.ExperimentConfig, experiment.HEConfig,
                                               TrainConfig)


# --- partitions ----------------------------------------------------------------------


@pytest.mark.parametrize("clients", [2, 8])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_partitions_bitwise_equal_jax(seed, alpha, clients):
    (_, y), _, _ = synthetic.make_dataset("mnist", seed=seed, n_train=200, n_test=4)
    got = partition.label_skew(y, clients, alpha=alpha, seed=seed)
    want = jpart.label_skew(y, clients, alpha=alpha, seed=seed)
    assert len(got) == len(want) == clients
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        for a, b in zip(partition.train_val_split(g, 0.1 * (1 + seed)),
                        jpart.train_val_split(w, 0.1 * (1 + seed))):
            np.testing.assert_array_equal(a, b)
    for i in range(clients):
        np.testing.assert_array_equal(partition.client_slice(len(y), i, clients),
                                      jpart.client_slice(len(y), i, clients))


# --- FedProx loss and local training -------------------------------------------------


@pytest.fixture(scope="module")
def smallcnn_jax():
    module, params = jcreate_model("smallcnn", rng=jax.random.key(31))
    return module, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jparams, cls=SmallCNN):
    model = cls()
    model.load_state_dict(convert.from_flax(jparams))
    return model


@pytest.mark.parametrize("mu", [0.0, 0.1])
def test_prox_term_and_loss_fn_match_jax(smallcnn_jax, mu):
    # The proximal term is float32 sums of squares: rtol 1e-5 (the two sum
    # in different orders). The cross-entropy is the bf16 forward: within
    # 1e-2 relative, the tolerance of test_one_adam_step_on_same_batch.
    module, jglobal = smallcnn_jax
    rng = np.random.default_rng(20)
    jparams = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), jglobal)
    x = rng.integers(0, 256, (8, 28, 28, 1), dtype=np.uint8)
    onehot = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    tparams, tglobal = convert.from_flax(jparams), convert.from_flax(jglobal)
    want = float(jloss.prox_term(jparams, jglobal, mu))
    got = loss.prox_term(tparams, tglobal, mu)
    assert got.dtype == torch.float32
    if mu == 0.0:
        assert got.item() == want == 0.0
    else:
        assert got.item() == pytest.approx(want, rel=1e-5)
    xf = rescale(torch.from_numpy(x))
    jl, (jce, _) = jloss.loss_fn(module, jparams, jnp.asarray(xf.numpy()), jnp.asarray(onehot),
                                 jglobal, mu)
    tl, (tce, _) = loss.loss_fn(_port_model(jglobal), tparams, xf, torch.from_numpy(onehot),
                                tglobal, mu)
    assert tce.item() == pytest.approx(float(jce), rel=1e-2)
    assert (tl - tce).item() == pytest.approx(float(jl - jce), rel=1e-5, abs=1e-7)


def test_local_train_with_prox_matches_jax_metric_rows(smallcnn_jax):
    # test_local_train_matches_jax_metric_rows with FedProx at mu = 0.1, and
    # its tolerances.
    module, jparams = smallcnn_jax
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=11, n_train=40, n_test=4)
    kw = dict(epochs=2, batch_size=8, augment=False, num_classes=10, plateau_patience=1,
              prox_mu=0.1)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(12)
    perms, aug_keys = jclient.epoch_index_streams(jcfg, key[None], len(y))
    jtrain = jax.jit(jclient.local_train, static_argnums=(0, 1))
    jparams_out, jmets = jtrain(module, jcfg, jparams, jnp.asarray(x), jnp.asarray(y), key,
                                streams=(perms[0], aug_keys[0]))
    tparams_out, tmets = client.local_train(
        _port_model(jparams), TrainConfig(**kw), convert.from_flax(jparams),
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
    for k in want:
        assert (tparams_out[k] - want[k]).abs().max().item() <= 8e-3, k


def test_fedavg_round_is_plain_mean_of_train_clients_bitwise():
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=4, n_train=48, n_test=4)
    xs, ys = (torch.from_numpy(a) for a in partition.stack_federated(
        x, y, partition.iid_contiguous(len(y), 3)))
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    cfg = TrainConfig(**TINY_TRAIN)
    got, mets = fedavg.fedavg_round(model, cfg, params, xs, ys, torch.Generator().manual_seed(9))
    gens = fedavg.client_generators(torch.Generator().manual_seed(9), 3, xs.device)
    p_out, want_mets = fedavg.train_clients(model, cfg, params, xs, ys, gens=gens)
    want = secure.plain_mean(p_out)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(mets, want_mets) and tuple(mets.shape) == (3, 1, 4)


def _assert_metric_rows_close(tmets, jmets, n_val):
    """`test_local_train_matches_jax_metric_rows`'s tolerances: val loss
    within 1e-2, val accuracy within one validation sample, lr scale and
    stopped flag exact."""
    assert tmets.shape == jmets.shape
    np.testing.assert_allclose(tmets[..., 0], jmets[..., 0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tmets[..., 1], jmets[..., 1], rtol=0, atol=1.0 / n_val + 1e-6)
    np.testing.assert_array_equal(tmets[..., 2:], jmets[..., 2:])


def _max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max((got[k] - want[k]).abs().max().item() for k in want)


def _jax_to_port(tree) -> dict:
    return convert.from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_fedavg_round_matches_the_jax_round_on_its_streams(smallcnn_jax):
    # The JAX plaintext round derives each client's streams from
    # split(key, C); the port's round is fed those streams.
    from hefl_tpu.fl import fedavg as jfedavg
    from hefl_tpu.parallel.mesh import make_mesh

    module, jparams = smallcnn_jax
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=4, n_train=48, n_test=4)
    xs, ys = jpart.stack_federated(x, y, jpart.iid_contiguous(len(y), 2))
    kw = dict(epochs=2, batch_size=8, augment=False, num_classes=10, plateau_patience=1)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(17)
    jnew, jmets = jfedavg.fedavg_round(module, jcfg, make_mesh(2), jparams, jnp.asarray(xs),
                                       jnp.asarray(ys), key)
    perms, _ = jclient.epoch_index_streams(jcfg, jax.random.split(key, 2), xs.shape[1])
    streams = [(torch.from_numpy(np.asarray(p).astype(np.int64)), None) for p in perms]
    tnew, tmets = fedavg.fedavg_round(
        _port_model(jparams), TrainConfig(**kw), convert.from_flax(jparams),
        torch.from_numpy(xs), torch.from_numpy(ys), torch.Generator(), streams=streams)
    n_val = xs.shape[1] - client.train_batch_geometry(TrainConfig(**kw), xs.shape[1])[0]
    _assert_metric_rows_close(tmets.numpy(), np.asarray(jmets), n_val)
    assert tuple(tmets.shape) == (2, 2, 4)
    assert _max_diff(tnew, _jax_to_port(jnew)) <= 8e-3


def test_centralized_training_restores_best_accuracy_weights(smallcnn_jax):
    # The JAX centralized trainer (`local_train_epochs` with the
    # best-by-accuracy copy) and the port's, fed the same streams. Every
    # epoch here scores the same validation accuracy, so the restore must
    # take the FIRST epoch's weights (a strict improvement over -inf); the
    # final weights lie farther from them than the tolerance.
    module, jparams = smallcnn_jax
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=7, n_train=48, n_test=4)
    kw = dict(epochs=5, batch_size=8, augment=False, num_classes=10, plateau_patience=2,
              es_patience=3, val_fraction=0.25, lr=3e-3)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(13)
    perms, aug = jclient.epoch_index_streams(jcfg, key[None], len(y))
    jtrain = jax.jit(jclient.local_train_epochs, static_argnums=(0, 1, 7))
    final, jmets = jtrain(module, jcfg, jparams, jnp.asarray(x), jnp.asarray(y),
                          jclient.init_client_state(jparams), jax.random.split(key, jcfg.epochs),
                          True, streams=(perms[0], aug[0]))
    best, tmets = client.train_centralized(
        _port_model(jparams), TrainConfig(**kw), convert.from_flax(jparams),
        torch.from_numpy(x), torch.from_numpy(y),
        streams=(torch.from_numpy(np.asarray(perms[0]).astype(np.int64)), None))
    jmets = np.asarray(jmets)
    assert len(set(jmets[:, 1].tolist())) == 1
    n_val = len(y) - client.train_batch_geometry(TrainConfig(**kw), len(y))[0]
    _assert_metric_rows_close(tmets.numpy(), jmets, n_val)
    jbest, jfinal = _jax_to_port(final.best_params), _jax_to_port(final.params)
    assert _max_diff(best, jbest) <= 8e-3 < _max_diff(jfinal, jbest)


def test_epoch_update_transitions_equal_jax():
    # The callback transition on scripted (val_loss, val_acc) sequences,
    # with each epoch's weights a marker: ties in accuracy keep the first
    # epoch, early stopping freezes every later epoch (their better
    # accuracies are ignored), ReduceLROnPlateau fires on a flat loss.
    kw = dict(es_patience=2, plateau_patience=1, lr=1e-3)
    jcfg, tcfg = jconfig.TrainConfig(**kw), TrainConfig(**kw)
    loss_seq = [2.0, 1.9, 1.95, 1.97, 1.99, 1.5, 1.4]
    acc_seq = [0.5, 0.5, 0.75, 0.75, 0.9, 0.95, 1.0]
    j0 = {"w": jnp.zeros((2,), jnp.float32)}
    t0 = {"w": torch.zeros(2)}
    jstate, tstate = jclient.init_client_state(j0), client.init_client_state(t0)
    for e, (vl, va) in enumerate(zip(loss_seq, acc_seq)):
        jp = {"w": jnp.full((2,), e + 1, jnp.float32)}
        tp = {"w": torch.full((2,), float(e + 1))}
        jstate, jrow = jclient._epoch_update(jcfg, jstate, jp, jstate.opt, jnp.float32(vl),
                                             jnp.float32(va), True)
        tstate, trow = client._epoch_update(tcfg, tstate, tp, tstate.opt, np.float32(vl),
                                            np.float32(va), track_best_acc=True)
        np.testing.assert_array_equal(trow, np.asarray(jrow))
        for name in ("params", "best_params", "best_loss_params"):
            np.testing.assert_array_equal(getattr(tstate, name)["w"].numpy(),
                                          np.asarray(getattr(jstate, name)["w"]), err_msg=name)
        for name in ("best_val_acc", "best_val_loss", "wait_es", "wait_plateau", "stopped"):
            assert getattr(tstate, name) == np.asarray(getattr(jstate, name)), (e, name)
    assert tstate.stopped and tstate.best_params["w"][0].item() == 3.0


# --- models --------------------------------------------------------------------------


def test_logreg_forward_matches_jax():
    module, jparams = jcreate_model("logreg", rng=jax.random.key(3))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    model = _port_model(jparams, LogReg)
    assert count_params(model) == sum(a.size for a in jax.tree_util.tree_leaves(jparams)) == 7850
    x = np.random.default_rng(2).random((16, 28, 28, 1), dtype=np.float32)
    want = np.asarray(module.apply({"params": jparams}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert "logreg" in cli.build_parser()._option_string_actions["--model"].choices


# --- presets -------------------------------------------------------------------------


def _assert_same_config(port, ref, path="cfg"):
    """Every field of `port` equals `ref`'s (dataclasses recursively), and
    every field only `ref` has is at its default."""
    if not dataclasses.is_dataclass(ref):
        assert port == ref, path
        return
    assert dataclasses.is_dataclass(port), path
    names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        sub = f"{path}.{f.name}"
        if f.name not in names:
            default = (f.default if f.default is not dataclasses.MISSING
                       else f.default_factory())
            assert getattr(ref, f.name) == default, f"{sub} is off its default"
        else:
            _assert_same_config(getattr(port, f.name), getattr(ref, f.name), sub)
    assert names <= {f.name for f in dataclasses.fields(ref)}, path


@pytest.mark.parametrize("name", ["mnist-plain", "mnist-enc", "medical-8", "medical-skew",
                                  "hhe-smoke", "cifar-resnet16", "fusion-smoke"])
def test_presets_equal_jax_field_by_field(name):
    _assert_same_config(presets.PRESETS[name], jpresets.PRESETS[name], name)


def test_preset_names_cover_the_jax_presets():
    assert presets.BASELINE_PRESET_NAMES == jpresets.BASELINE_PRESET_NAMES
    assert set(presets.PRESETS) | set(presets.UNPORTED_PRESETS) == set(jpresets.PRESETS)
    assert not set(presets.PRESETS) & set(presets.UNPORTED_PRESETS)


def test_chaos_smoke_preset_builds_the_jax_fields():
    # Its FaultConfig field by field too; no preset is refused any more.
    port, ref = presets.PRESETS["chaos-smoke"], jpresets.PRESETS["chaos-smoke"]
    _assert_same_config(port, ref, "chaos-smoke")
    assert isinstance(port.faults, FaultConfig) and port.train.on_overflow == "exclude"
    assert presets.UNPORTED_PRESETS == {}
    with pytest.raises(KeyError, match="unknown preset"):
        presets.PRESETS["no-such-preset"]


# --- the driver against the JAX driver -----------------------------------------------

KINDS = {
    "encrypted": {},
    "plaintext_label_skew": dict(encrypted=False, partition="label_skew", rounds=1),
    "centralized": dict(centralized=True, rounds=1),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_run_experiment_matches_jax_schema(kind, monkeypatch):
    kw = KINDS[kind]
    if kind == "encrypted":
        monkeypatch.setattr(janalysis, "check_experiment", lambda *a, **k: None)
    jcfg, tcfg = _tiny(_J, **kw), _tiny(_T, **kw)
    want = jexp.run_experiment(jcfg, verbose=False)
    got = experiment.run_experiment(tcfg, verbose=False, device="cpu")
    assert len(got["history"]) == len(want["history"]) == jcfg.rounds
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        assert g["round"] == w["round"] and g["phases"].keys() == w["phases"].keys()
        assert g["phase_roofline"].keys() == w["phase_roofline"].keys()
        for phase, stats in g["phase_roofline"].items():
            assert set(stats) == {"seconds", "flops", "mfu", "images_per_s"} <= set(
                w["phase_roofline"][phase])
            assert stats["seconds"] is not None
        assert len(g["val_loss"]) == len(w["val_loss"]) and len(g["val_acc"]) == len(w["val_acc"])
        assert g.get("encode_overflow") == w.get("encode_overflow")
        assert all(0.0 <= g[k] <= 1.0 for k in ("accuracy", "precision", "recall", "f1"))
    assert {"history", "final_metrics", "params"} <= set(want)
    for key in ("packing", "stream", "hhe"):
        assert got[key] is None and want.get(key) is None
    if not tcfg.centralized:
        # What the run ran: the JAX records' keys, the port's values.
        for key in ("augment_backend", "client_fusion", "he_backend", "mesh"):
            assert got[key].keys() == want[key].keys(), key
        assert got["mesh"] == {"axes": ["clients"], "clients": 1, "ct": 1}
        assert got["he_backend"]["backend"] == "plain"
        assert got["augment_backend"]["backend"] == "gather"
        assert got["client_fusion"]["backend"] in ("fused", "vmap")
    assert got["final_metrics"] is got["history"][-1]
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=3, n_train=64, n_test=32)
    if not tcfg.centralized:
        for g, w in zip(experiment._partition(tcfg, y), jexp._partition(jcfg, y)):
            np.testing.assert_array_equal(g, w)
    want_params = convert.from_flax(jax.tree_util.tree_map(np.asarray, want["params"]))
    assert want_params.keys() == got["params"].keys()
    assert all(torch.isfinite(v).all() for v in got["params"].values())
    if kind == "encrypted":
        assert (PackSpec.for_params(got["params"], 256).n_ct
                == JPackSpec.for_params(want["params"], 256).n_ct == 55 * 16)


def test_tiny_round_decrypts_within_yardstick_of_its_plain_mean():
    cfg = _tiny(_T)
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=cfg.seed, n_train=64, n_test=4)
    xs, ys = (torch.from_numpy(a) for a in partition.stack_federated(
        x, y, experiment._partition(cfg, y)))
    model = create_model("smallcnn", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    ctx = cfg.he.build()
    gen = torch.Generator().manual_seed(cfg.seed)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    ct_sum, _, overflow, ref = secure.secure_fedavg_round(
        model, cfg.train, ctx, pk, params, xs, ys, gen, with_plain_reference=True)
    avg = secure.decrypt_average(ctx, sk, ct_sum, 2, PackSpec.for_params(params, ctx.n))
    assert overflow.tolist() == [0, 0]
    assert max((avg[k] - ref[k]).abs().max().item() for k in ref) <= 5e-6


@pytest.mark.parametrize("mode", ["float", "packed"])
def test_driver_rounds_decrypt_within_yardstick_of_their_plain_mean(mode, monkeypatch):
    # run_experiment's own rounds, each asked for its plaintext mean
    # (with_plain_reference): every round's decrypted average, as the
    # driver computes it, sits within the yardstick of that mean — 5e-6 for
    # float uploads, the packed spec's error budget for packed ones.
    real_round, real_decrypt = experiment.secure_fedavg_round, experiment.decrypt_average
    refs, pairs = [], []

    def round_with_reference(*a, **k):
        ct_sum, mets, overflow, ref = real_round(*a, with_plain_reference=True, **k)
        refs.append((ref, k.get("packing")))
        return ct_sum, mets, overflow

    def decrypt(*a, **k):
        avg = real_decrypt(*a, **k)
        pairs.append((*refs[-1], avg))
        return avg

    monkeypatch.setattr(experiment, "secure_fedavg_round", round_with_reference)
    monkeypatch.setattr(experiment, "decrypt_average", decrypt)
    kw = dict(rounds=2) if mode == "float" else dict(
        rounds=1, num_clients=3, packing=experiment.PackingConfig(bits=8))
    out = experiment.run_experiment(_tiny(_T, **kw), verbose=False, device="cpu")
    assert len(pairs) == len(out["history"]) == kw["rounds"]
    for ref, pspec, avg in pairs:
        assert (pspec is None) == (mode == "float")
        limit = 5e-6 if pspec is None else pspec.error_budget
        assert _max_diff(avg, ref) <= limit
    assert pairs[-1][2] is out["params"]


def test_fusion_smoke_preset_runs_on_the_cpu():
    # The fused backend pinned by the preset, through the driver: two
    # plaintext rounds of 8 clients.
    out = experiment.run_experiment(presets.PRESETS["fusion-smoke"], verbose=False, device="cpu")
    assert out["client_fusion"]["backend"] == "fused" and len(out["history"]) == 2
    for rec in out["history"]:
        assert len(rec["val_loss"]) == 8 and np.isfinite(rec["val_loss"]).all()
        assert "encode_overflow" not in rec and 0.0 <= rec["accuracy"] <= 1.0
    assert all(torch.isfinite(v).all() for v in out["params"].values())


def test_tiny_cifar_resnet16_decrypts_within_yardstick(monkeypatch):
    # cifar-resnet16's configuration (16 clients, fused, encrypted) with a
    # small ResNet-20 (one block a stage, widths 8/16/16), N = 256, 1 round
    # of 1 epoch: the driver's decrypted average within 5e-6 of the plaintext
    # mean of the same trained weights.
    import functools

    from hefl_tpu_torch import models

    small = functools.partial(models.ResNet20, stage_sizes=(1, 1, 1), widths=(8, 16, 16))
    monkeypatch.setitem(models.MODEL_REGISTRY, "resnet20", (small, 10, (32, 32, 3)))
    real_round, real_decrypt = experiment.secure_fedavg_round, experiment.decrypt_average
    pairs = []

    def round_with_reference(*a, **k):
        ct_sum, mets, overflow, ref = real_round(*a, with_plain_reference=True, **k)
        pairs.append([ref])
        return ct_sum, mets, overflow

    def decrypt(*a, **k):
        pairs[-1].append(real_decrypt(*a, **k))
        return pairs[-1][-1]

    monkeypatch.setattr(experiment, "secure_fedavg_round", round_with_reference)
    monkeypatch.setattr(experiment, "decrypt_average", decrypt)
    base = presets.PRESETS["cifar-resnet16"]
    cfg = dataclasses.replace(base, rounds=1, n_train=16 * 8, n_test=16,
                              he=experiment.HEConfig(n=256),
                              train=dataclasses.replace(base.train, epochs=1,
                                                        client_fusion="fused"))
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    (ref, avg), = pairs
    assert _max_diff(avg, ref) <= 5e-6
    assert out["history"][0]["encode_overflow"] == [0] * 16
    assert out["client_fusion"]["backend"] == "fused"
    assert "BasicBlock_2.Conv_2.weight" in out["params"]


def test_hhe_smoke_preset_runs_on_the_cpu():
    out = experiment.run_experiment(dataclasses.replace(presets.PRESETS["hhe-smoke"], rounds=1),
                                    verbose=False, device="cpu")
    (rec,) = out["history"]
    assert rec["encode_overflow"] == [0] * 8 and rec["stream"]["committed"]
    assert rec["robust"]["surviving"] == 8 and rec["robust"]["round_retries"] == 0
    assert rec["packing"] == out["packing"] and out["packing"]["bits"] == 8
    assert rec["hhe"] == out["hhe"] and out["hhe"]["expansion_hhe"] <= 1.1
    assert out["stream"]["upload_kind"] == "hhe"


@pytest.mark.parametrize("policy", ["warn", "raise"])
def test_on_overflow_warns_or_raises(policy, capsys):
    # scale 2**50 puts the encode envelope at |w| < 2**-4: trained weights saturate.
    cfg = _tiny(_T, rounds=1, he=experiment.HEConfig(n=256, scale=2.0**50),
                train=TrainConfig(**TINY_TRAIN, on_overflow=policy))
    if policy == "raise":
        with pytest.raises(RuntimeError, match="on_overflow='raise'"):
            experiment.run_experiment(cfg, verbose=False, device="cpu")
        return
    out = experiment.run_experiment(cfg, device="cpu")
    assert sum(out["history"][0]["encode_overflow"]) > 0
    assert "WARNING: round 0 clipped" in capsys.readouterr().out


def test_round_retry_reruns_the_round_with_its_first_draws(monkeypatch):
    # One injected runtime failure: the retried round redraws the first
    # attempt's randomness, so the run equals the one that never failed.
    clean = experiment.run_experiment(_tiny(_T, rounds=1, encrypted=False), verbose=False,
                                      device="cpu")
    real, calls = fedavg.fedavg_round, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected device loss")
        return real(*a, **k)

    monkeypatch.setattr(experiment, "fedavg_round", flaky)
    cfg = _tiny(_T, rounds=1, encrypted=False, max_round_retries=1, retry_backoff_s=0.0)
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    assert len(calls) == 2
    assert all(torch.equal(out["params"][k], clean["params"][k]) for k in clean["params"])
    with pytest.raises(RuntimeError, match="injected"):
        calls.clear()
        experiment.run_experiment(dataclasses.replace(cfg, max_round_retries=0), verbose=False,
                                  device="cpu")


def test_round_retry_auto_resumes_from_the_round_checkpoint(tmp_path, monkeypatch, capsys):
    # A failure in round 1 of a checkpointed run (the path given without
    # its .npz suffix): the retry reloads round 1's entry state from the
    # checkpoint and the run equals the one that never failed.
    clean = experiment.run_experiment(_tiny(_T, encrypted=False), verbose=False, device="cpu")
    real, calls = fedavg.fedavg_round, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device loss")
        return real(*a, **k)

    monkeypatch.setattr(experiment, "fedavg_round", flaky)
    cfg = _tiny(_T, encrypted=False, max_round_retries=1, retry_backoff_s=0.0,
                checkpoint_path=str(tmp_path / "ck"))
    out = experiment.run_experiment(cfg, device="cpu")
    assert len(calls) == 3 and (tmp_path / "ck.npz").exists()
    assert f"auto-resumed round-1 state from {cfg.checkpoint_path}" in capsys.readouterr().out
    assert all(torch.equal(out["params"][k], clean["params"][k]) for k in clean["params"])


# --- robust and private rounds ---------------------------------------------------------

ROBUST_FAULTS = dict(seed=1, drop_fraction=0.25, nan_clients=1, huge_clients=1,
                     straggler_fraction=0.25, straggler_delay_s=0.05, fail_rounds=(1,))


def _robust(pkg, faults_cls, dp_cls):
    """A tiny 8-client encrypted run under a fault schedule with DP: the
    derived noise floor is 8 - (2 + 1 + 1) = 4, which the round meets."""
    train = pkg.TrainConfig(**TINY_TRAIN, on_overflow="exclude")
    return _tiny(pkg, num_clients=8, n_train=128, train=train, faults=faults_cls(**ROBUST_FAULTS),
                 dp=dp_cls(clip_norm=1.0, noise_multiplier=1.0), max_round_retries=1,
                 retry_backoff_s=0.0)


def test_robust_dp_run_matches_the_jax_drivers_records(monkeypatch, capsys):
    # The robust records (participation, surviving, exclusions by cause,
    # retries, injected faults) and the epsilon spent are equal; the
    # decrypted models are not compared (jax.random streams).
    monkeypatch.setattr(janalysis, "check_experiment", lambda *a, **k: None)
    want = jexp.run_experiment(_robust(_J, jfaults.FaultConfig, jdp.DpConfig), verbose=False)
    got = experiment.run_experiment(_robust(_T, FaultConfig, DpConfig), device="cpu")
    out = capsys.readouterr().out
    assert "dp: noise shares recalibrated to a surviving-cohort floor of 4/8 clients" in out
    assert "round 1 failed (DeviceLost: fault injection: scheduled device loss at round 1)" in out
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        assert g["robust"] == w["robust"]
        assert g["dp_epsilon"] == w["dp_epsilon"] == epsilon_spent(g["round"] + 1, 1.0, 1e-5)
        assert g["robust"]["surviving"] == 4
        assert g["robust"]["round_retries"] == (1 if g["round"] == 1 else 0)
        assert g["phases"]["train+encrypt+aggregate"] >= g["robust"]["faults"]["straggler_s"]
    assert all(torch.isfinite(v).all() for v in got["params"].values())


def test_plaintext_masked_run_keeps_the_model_when_nobody_survives(capsys):
    # Every client dropped (drop_fraction 1.0): each round keeps the
    # previous global model; the records say so.
    cfg = _tiny(_T, encrypted=False, rounds=1, faults=FaultConfig(drop_fraction=1.0))
    out = experiment.run_experiment(cfg, device="cpu", verbose=False)
    init = {k: v.detach() for k, v in create_model("smallcnn", device="cpu").named_parameters()}
    assert all(torch.equal(out["params"][k], init[k]) for k in init)
    rob = out["history"][0]["robust"]
    assert rob["surviving"] == 0 and rob["excluded"]["scheduled"] == 2


def test_encrypted_round_with_nobody_surviving_keeps_the_model(capsys):
    cfg = _tiny(_T, rounds=1, faults=FaultConfig(drop_fraction=1.0))
    out = experiment.run_experiment(cfg, device="cpu")
    assert "round 0: every client excluded" in capsys.readouterr().out
    init = {k: v.detach() for k, v in create_model("smallcnn", device="cpu").named_parameters()}
    assert all(torch.equal(out["params"][k], init[k]) for k in init)


def test_chaos_smoke_rounds_equal_the_committed_gate():
    # The preset cut to 3 rounds (its retried round 2 included): each
    # round's surviving count, exclusions and retries are CHAOS_SMOKE.json's
    # (the JAX run's record), every non-finite per-client metric belongs to
    # an excluded client, and the final parameters are finite.
    gate = json.loads((REPO / "CHAOS_SMOKE.json").read_text())
    cfg = dataclasses.replace(presets.PRESETS["chaos-smoke"], rounds=3)
    out = experiment.run_experiment(cfg, verbose=False, device="cpu")
    for rec, ref in zip(out["history"], gate["rounds"][:3]):
        rob = rec["robust"]
        assert rec["round"] == ref["round"]
        assert rob["surviving"] == ref["surviving"] == 5
        assert {k: rob["excluded"][k] for k in ref["excluded"]} == ref["excluded"]
        assert not any(v for k, v in rob["excluded"].items() if k not in ref["excluded"])
        assert rob["round_retries"] == ref["retries"]
        bad = [c for c, (lo, ac) in enumerate(zip(rec["val_loss"], rec["val_acc"]))
               if not (np.isfinite(lo) and np.isfinite(ac))]
        assert all(rob["participation"][c] == 0 for c in bad)
    assert len(out["history"]) == 3
    assert all(torch.isfinite(v).all() for v in out["params"].values())


REFUSED = [
    ("data_dir", dict(data_dir="images")),
    ("profile_dir", dict(profile_dir="prof")),
    ("mesh_ct", dict(mesh_ct=2)),
]


def test_exact_final_decode_runs_through_run_experiment(monkeypatch):
    # exact_final_decode: the last round decrypts through the exact host
    # CRT (the native decode), the earlier rounds through the float32 one;
    # the final parameters sit within the 5e-6 encrypted-average yardstick
    # of the float-decoded twin's.
    calls = []
    real = experiment.decrypt_average

    def decrypt(*a, **k):
        calls.append(k.get("exact"))
        return real(*a, **k)

    monkeypatch.setattr(experiment, "decrypt_average", decrypt)
    exact = experiment.run_experiment(_tiny(_T, exact_final_decode=True), verbose=False,
                                      device="cpu")
    assert calls == [False, True]
    plain = experiment.run_experiment(_tiny(_T), verbose=False, device="cpu")
    assert calls == [False, True, False, False]
    assert _max_diff(exact["params"], plain["params"]) <= 5e-6


@pytest.mark.parametrize("field,kw", REFUSED, ids=[f for f, _ in REFUSED])
def test_unported_fields_are_refused_by_name(field, kw):
    with pytest.raises(ValueError, match=rf"ExperimentConfig\.\S*{field}.*ROADMAP"):
        experiment.run_experiment(_tiny(_T, **kw), verbose=False, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(encrypted=False, packing=experiment.PackingConfig(bits=8)),
    dict(centralized=True, stream=experiment.StreamConfig()),
    dict(hhe=experiment.HheConfig()),
    dict(dp=DpConfig(), stream=experiment.StreamConfig(staleness_rounds=1)),
    dict(journal_path="j.wal"),
    dict(crash=experiment.CrashConfig(), stream=experiment.StreamConfig()),
    dict(packing=experiment.PackingConfig(bits=4, error_feedback=True)),
    dict(packing=experiment.PackingConfig(bits=4, error_feedback=True), dp=DpConfig(),
         stream=experiment.StreamConfig()),
    dict(dp=DpConfig(), stream=experiment.StreamConfig(num_hosts=2, host_staleness_rounds=1)),
], ids=["packing_plaintext", "stream_centralized", "hhe_without_stream", "dp_staleness",
        "journal_without_stream", "crash_without_journal", "ef_without_stream", "ef_with_dp",
        "dp_host_staleness"])
def test_config_checks_are_the_jax_drivers(kw):
    jkw = {k: _jtype(k)(**dataclasses.asdict(v)) if dataclasses.is_dataclass(v) else v
           for k, v in kw.items()}
    with pytest.raises(ValueError) as jerr:
        jexp.run_experiment(_tiny(_J, **jkw), verbose=False)
    with pytest.raises(ValueError) as terr:
        experiment.run_experiment(_tiny(_T, **kw), verbose=False, device="cpu")
    assert str(terr.value) == str(jerr.value)


def _jtype(field):
    from hefl_tpu import fl

    from hefl_tpu.fl import dp, faults

    return {"packing": fl.PackingConfig, "stream": fl.StreamConfig, "hhe": fl.HheConfig,
            "dp": dp.DpConfig, "crash": faults.CrashConfig}[field]


# --- the CLI -------------------------------------------------------------------------

ARGV = [
    ["--model", "smallcnn", "--dataset", "cifar10", "--num-clients", "8", "--rounds", "3",
     "--plaintext", "--partition", "label_skew", "--skew-alpha", "0.3", "--prox-mu", "0.1",
     "--he-n", "2048", "--no-augment", "--seed", "4", "--checkpoint", "ck.npz"],
    ["--centralized", "--no-save-model", "--n-train", "40", "--epochs", "2"],
    ["--save-model", "m.npz", "--pack-bits", "8", "--hhe", "--hhe-key-seed", "2", "--lr", "0.01"],
    [],
    ["--client-fusion", "fused", "--max-round-retries", "2", "--retry-backoff", "0.1",
     "--model", "resnet20", "--dataset", "cifar10", "--num-clients", "16"],
    ["--num-clients", "8", "--dp-noise", "1.1", "--dp-clip", "0.5", "--dp-delta", "1e-6",
     "--dp-min-surviving", "3", "--on-overflow", "exclude", "--max-update-norm", "50",
     "--drop-fraction", "0.25", "--nan-clients", "1", "--huge-clients", "1",
     "--straggler-delay", "0.2", "--fail-rounds", "1,3", "--fault-seed", "7"],
    ["--straggler-delay", "0.5", "--on-overflow", "raise"],
    ["--num-clients", "8", "--cohort-size", "6", "--quorum", "0.375", "--deadline", "2",
     "--stream-retries", "1", "--stream-backoff", "0.5", "--stream-seed", "3", "--staleness", "1",
     "--full-cohort-train", "--arrival-delay", "0.5", "--duplicate-clients", "1",
     "--transient-clients", "1", "--permanent-clients", "1", "--serve", "--journal-path",
     "j.wal", "--fsync-policy", "always", "--crash-round", "1", "--crash-at", "mid_append",
     "--crash-after-folds", "2", "--events", "e.jsonl", "--span-trace", "s.json.gz"],
    ["--stream", "--no-events", "--dp-noise", "1.0"],
]


@pytest.mark.parametrize("argv", ARGV, ids=["plaintext_skew", "centralized", "hhe", "defaults",
                                            "fusion_retries", "dp_faults", "stragglers",
                                            "streaming_service", "stream_dp_no_events"])
def test_cli_flags_map_to_the_jax_config(argv):
    port = cli.config_from_args(cli.parse_args(argv + ["--device", "cpu"]))
    ref = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    _assert_same_config(port, ref)


def test_cli_flags_map_to_config():
    cfg = cli.config_from_args(cli.parse_args(ARGV[0] + ["--device", "cpu"]))
    assert cfg.encrypted is False and cfg.partition == "label_skew"
    assert cfg.train.prox_mu == 0.1 and cfg.train.augment is False
    assert cfg.train.num_classes == 10 and cfg.he.n == 2048
    assert cfg.checkpoint_path == "ck.npz" and cfg.save_model_path == "agg_model.npz"
    args = cli.parse_args(["--resume", "--device", "cpu"])
    assert args.resume and cli.config_from_args(args).faults is None


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_cli_preset_yields_the_preset(name):
    args = cli.parse_args(["--preset", name, "--epochs", "1", "--device", "cpu"])
    assert cli.config_from_args(args) == presets.PRESETS[name]


# --- the package boundary ------------------------------------------------------------


def test_cli_refuses_a_dp_floor_without_dp(capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--dp-min-surviving", "3", "--device", "cpu"])
    assert "--dp-min-surviving has no effect without --dp-noise" in capsys.readouterr().err


@pytest.mark.parametrize("rel", ["hefl_tpu_torch/experiment.py", "hefl_tpu_torch/presets.py",
                                 "hefl_tpu_torch/utils/__init__.py",
                                 "hefl_tpu_torch/utils/checkpoint.py",
                                 "hefl_tpu_torch/utils/timers.py",
                                 "hefl_tpu_torch/fl/fusion.py",
                                 "hefl_tpu_torch/models/folded.py",
                                 "hefl_tpu_torch/models/resnet.py",
                                 "hefl_tpu_torch/fl/faults.py", "hefl_tpu_torch/fl/dp.py",
                                 "hefl_tpu_torch/utils/serialization.py",
                                 "hefl_tpu_torch/fl/journal.py", "hefl_tpu_torch/fl/server.py",
                                 "hefl_tpu_torch/fl/load.py", "hefl_tpu_torch/obs/metrics.py",
                                 "hefl_tpu_torch/obs/events.py", "hefl_tpu_torch/obs/spans.py",
                                 "hefl_tpu_torch/obs/scopes.py"])
def test_new_modules_are_scanned_and_import_no_jax(rel):
    path = REPO / rel
    assert path in sorted((REPO / "hefl_tpu_torch").rglob("*.py"))
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                       "hefl_tpu")}


@pytest.mark.parametrize("twin", ["duplicate-storm", "regional-outage"])
def test_chaos_smoke_hierarchical_twin_is_the_flat_twin(twin):
    # run_chaos_smoke.sh's hierarchical legs: the chaos-smoke streaming
    # schedule (cut to 256 images; 2 rounds under the storm, whose round 1
    # folds carried uploads through the tiers, 1 under the outage) flat and
    # through 4 host tiers; CHAOS_SMOKE.json's hier_check commits every round.
    gate = json.loads((REPO / "CHAOS_SMOKE.json").read_text())["hier_check"][twin]
    rounds = 2 if twin == "duplicate-storm" else 1
    cfg = presets.PRESETS["chaos-smoke"]
    faults = dataclasses.replace(cfg.faults, straggler_fraction=0.25, straggler_delay_s=6.0,
                                 arrival_delay_s=0.5, duplicate_clients=1,
                                 transient_fail_clients=1, fail_rounds=())
    faults = (dataclasses.replace(faults, duplicate_clients=3, arrival_delay_s=0.5)
              if twin == "duplicate-storm" else
              dataclasses.replace(faults, drop_fraction=0.0, nan_clients=0, duplicate_clients=0,
                                  outage_hosts=1, num_hosts=4))
    stream = experiment.StreamConfig(quorum=0.375, deadline_s=2.0, max_retries=1,
                                     staleness_rounds=1, seed=0)
    runs = {}
    for hosts in (0, 4):
        runs[hosts] = experiment.run_experiment(dataclasses.replace(
            cfg, rounds=rounds, n_train=256, faults=faults, events_path="",
            stream=dataclasses.replace(stream, num_hosts=hosts)), verbose=False, device="cpu")
    flat, hier = runs[0], runs[4]
    assert all(torch.equal(flat["params"][k], hier["params"][k]) for k in flat["params"])
    for rf, rh in zip(flat["history"], hier["history"]):
        st = dict(rh["stream"])
        hosts = st.pop("hosts")
        assert st == rf["stream"] and "hosts" not in rf["stream"]
        assert hosts["landed"] and hosts["missed"] == [] and hosts["nonempty"] == len(
            hosts["landed"])
    committed = [rec["round"] for rec in hier["history"] if rec["stream"]["committed"]]
    assert committed == gate["rounds_committed"][:rounds] == list(range(rounds))
