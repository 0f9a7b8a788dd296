"""The chunk-resume pieces and the port's evidence drivers.

`utils.checkpoint.save_pytree` / `load_pytree` round-trip a `ClientState`;
`fl.client.local_train_epochs` run in chunks (1 + 1 + rest, checkpointed
through `save_pytree` between chunks) equals the unchunked `local_train`
bitwise (the JAX package's `tests/test_fl.py` chunking test, on the port),
and on the JAX package's streams it agrees with the JAX `local_train`
within `tests/test_torch_train.py`'s tolerances. `fidelity_check`,
`mfu_probe --smoke` and `flagship_acc --smoke` run to their records on the
CPU, each with the root script's fields; a flagship run stopped after one
epoch, evaluated early (`--finish-now`) and resumed ends bitwise where the
unchunked run ends, which is the secure round's own result.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.fl import client as jclient
from hefl_tpu.fl import config as jconfig
from hefl_tpu.data import synthetic as jsyn
from hefl_tpu.models import create_model as jcreate_model

from hefl_tpu_torch import convert, fidelity_check, flagship_acc, mfu_probe
from hefl_tpu_torch.data import synthetic
from hefl_tpu_torch.fl import client
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.models import SmallCNN, create_model
from hefl_tpu_torch.utils import CheckpointError, load_pytree, save_pytree
from hefl_tpu_torch.utils.checkpoint import _atomic_savez, _read_npz

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CHUNK_CFG = dict(epochs=4, batch_size=16, num_classes=10, val_fraction=0.25, plateau_patience=1,
                 es_patience=3)


def _client_data(n: int = 96, seed: int = 5):
    (x, y), _, _ = synthetic.make_dataset("mnist", seed=seed, n_train=n, n_test=4)
    return torch.from_numpy(x), torch.from_numpy(y)


def _model():
    model = create_model("smallcnn", gen=torch.Generator().manual_seed(7), device="cpu")
    return model, {k: v.detach() for k, v in model.named_parameters()}


def _assert_same_state(a, b, path="state"):
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same_state(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_state(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


def _trained_state(epochs: int = 2):
    model, params = _model()
    x, y = _client_data()
    cfg = TrainConfig(**{**CHUNK_CFG, "epochs": epochs})
    streams = client.epoch_index_streams(cfg, torch.Generator().manual_seed(3), len(y))
    state, _ = client.local_train_epochs(model, cfg, params, x, y, client.init_client_state(params),
                                         client.split_epoch_streams(streams, epochs))
    return state, params


def test_save_load_pytree_roundtrips_a_client_state(tmp_path):
    state, params = _trained_state()
    assert state.opt.step > 0 and isinstance(state.lr_scale, np.float32)
    save_pytree(str(tmp_path / "s"), [state, state], meta={"epochs_done": 2, "curve": [[1.5]]})
    template = [client.init_client_state(params) for _ in range(2)]
    got, meta = load_pytree(str(tmp_path / "s"), template)
    assert meta == {"epochs_done": 2, "curve": [[1.5]]}
    assert isinstance(got, list) and len(got) == 2
    for g in got:
        _assert_same_state(g, state)


def _tamper(path):
    arrays = _read_npz(str(path))
    key = next(k for k in arrays if k.endswith("opt/step"))
    arrays[key] = arrays[key] + 1
    _atomic_savez(str(path), **arrays)


def _drop_leaf(path):
    arrays = _read_npz(str(path))
    _atomic_savez(str(path), **{k: v for k, v in arrays.items() if not k.endswith("wait_es")})


@pytest.mark.parametrize("damage", [_tamper, _drop_leaf,
                                    lambda p: p.write_bytes(b"PK\x03\x04torn")],
                         ids=["tampered", "leaf_removed", "truncated"])
def test_load_pytree_refuses_a_damaged_file(tmp_path, damage):
    state, params = _trained_state(1)
    save_pytree(str(tmp_path / "s"), state)
    damage(tmp_path / "s.npz")
    with pytest.raises(CheckpointError):
        load_pytree(str(tmp_path / "s"), client.init_client_state(params))


def test_load_pytree_refuses_another_structure(tmp_path):
    state, params = _trained_state(1)
    save_pytree(str(tmp_path / "s"), state)
    other = SmallCNN(num_classes=3)
    other_params = {k: v.detach() for k, v in other.named_parameters()}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(str(tmp_path / "s"), client.init_client_state(other_params))
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(str(tmp_path / "s"), {"extra": torch.zeros(1)})


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("chunks", [(1, 1, 2), (3, 1), (2, 2)], ids=["1+1+rest", "3+1", "2+2"])
def test_chunked_local_train_epochs_equal_unchunked_bitwise(tmp_path, augment, chunks):
    # The flagship chunk-resume primitive: the chunks, with the state
    # checkpointed through save_pytree / load_pytree between them, end with
    # the single 4-epoch local_train's upload and metric rows.
    model, params = _model()
    x, y = _client_data()
    cfg = TrainConfig(**CHUNK_CFG, augment=augment)
    gen_seed = 11
    want_params, want_mets = client.local_train(model, cfg, params, x, y,
                                                gen=torch.Generator().manual_seed(gen_seed))
    epochs = client.split_epoch_streams(client.epoch_index_streams(
        cfg, torch.Generator().manual_seed(gen_seed), len(y)), cfg.epochs)
    template = client.init_client_state(params)
    state, rows, done = template, [], 0
    for size in chunks:
        state, mets = client.local_train_epochs(model, cfg, params, x, y, state,
                                                epochs[done:done + size])
        done += size
        rows.append(mets)
        save_pytree(str(tmp_path / "state"), state, meta={"epochs_done": done})
        state, meta = load_pytree(str(tmp_path / "state"), template)
        assert meta["epochs_done"] == done
    got = client.client_shipped_params(state)
    assert torch.equal(torch.cat(rows), want_mets)
    for k in want_params:
        assert torch.equal(got[k], want_params[k]), k


def test_local_train_epochs_takes_no_epoch_as_a_no_op():
    model, params = _model()
    x, y = _client_data()
    state0 = client.init_client_state(params)
    state, mets = client.local_train_epochs(model, TrainConfig(**CHUNK_CFG), params, x, y,
                                            state0, [])
    assert state is state0 and tuple(mets.shape) == (0, 4)


def test_chunked_epochs_on_jax_streams_match_the_jax_local_train():
    # The port's chunks fed the JAX package's index stream agree with the
    # JAX local_train on it (tests/test_torch_train.py's tolerances: val
    # loss within 1e-2, val acc within one validation sample, the callback
    # columns equal).
    module, jparams = jcreate_model("smallcnn", rng=jax.random.key(31))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    (x, y), _, _ = jsyn.make_dataset("mnist", seed=11, n_train=40, n_test=4)
    kw = dict(epochs=2, batch_size=8, augment=False, num_classes=10, plateau_patience=1)
    jcfg = jconfig.TrainConfig(**kw)
    key = jax.random.key(12)
    perms, aug_keys = jclient.epoch_index_streams(jcfg, key[None], len(y))
    jtrain = jax.jit(jclient.local_train, static_argnums=(0, 1))
    _, jmets = jtrain(module, jcfg, jparams, jnp.asarray(x), jnp.asarray(y), key,
                      streams=(perms[0], aug_keys[0]))
    model = SmallCNN()
    model.load_state_dict(convert.from_flax(jparams))
    params = convert.from_flax(jparams)
    cfg = TrainConfig(**kw)
    epochs = client.split_epoch_streams(
        (torch.from_numpy(np.asarray(perms[0]).astype(np.int64)), None), 2)
    state = client.init_client_state(params)
    rows = []
    for e in range(2):
        state, mets = client.local_train_epochs(model, cfg, params, torch.from_numpy(x),
                                                torch.from_numpy(y), state, epochs[e:e + 1])
        rows.append(mets)
    tmets, jmets = torch.cat(rows).numpy(), np.asarray(jmets)
    n_val = len(y) - client.train_batch_geometry(cfg, len(y))[0]
    np.testing.assert_allclose(tmets[:, 0], jmets[:, 0], rtol=0, atol=1e-2)
    np.testing.assert_allclose(tmets[:, 1], jmets[:, 1], rtol=0, atol=1.0 / n_val + 1e-6)
    np.testing.assert_array_equal(tmets[:, 2:], jmets[:, 2:])


# --- the drivers ---------------------------------------------------------------------


def test_fidelity_check_writes_the_root_record(tmp_path):
    out = tmp_path / "fidelity_check_torch.json"
    assert fidelity_check.main(["--device", "cpu", "--seeds", "0", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    root = json.loads((REPO / "fidelity_check.json").read_text())
    assert set(root) <= set(rec) and {"power_limit", "he_backend"} <= set(rec)
    assert [r["seed"] for r in rec["rows"]] == [0, 1]
    assert set(root["rows"][0]) <= set(rec["rows"][0])
    assert (rec["n_ct"], rec["n"], rec["num_primes"], rec["num_clients"]) == (55, 4096, 3, 2)
    assert rec["device"] == "cpu" and rec["he_backend"] == "plain" and rec["pass"] is True
    assert all(r["encode_overflow"] == 0 for r in rec["rows"])
    assert rec["worst_max_abs_diff"] <= 5e-6
    assert all(r["max_abs_diff_exact_decode"] <= 5e-6 for r in rec["rows"])


@pytest.mark.parametrize("driver", [fidelity_check, mfu_probe, flagship_acc])
def test_drivers_refuse_to_run_without_a_card_unless_asked(monkeypatch, tmp_path, driver):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main([])
    assert list(tmp_path.iterdir()) == []


def test_mfu_probe_smoke_writes_its_record(tmp_path, monkeypatch):
    from hefl_tpu_torch.models.cnn import MedCNN
    from hefl_tpu_torch.utils import roofline

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "mfu_probe_torch.json"
    assert mfu_probe.main(["--smoke", "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert {"device", "power_limit", "peak_flops", "peak_is_placeholder", "augment_backend",
            "rows", "verdict", "flops_counter"} <= set(rec)
    assert rec["flops_counter"] == "torch.utils.flop_counter" and rec["peak_is_placeholder"]
    assert [r["batch"] for r in rec["rows"]] == [2, 4]
    narrow = MedCNN(input_shape=(256, 256, 3), **mfu_probe.SMOKE_WIDTH)
    for r in rec["rows"]:
        assert set(r) == {"batch", "step_ms", "images_per_s", "flops", "mfu"}
        assert r["flops"] == 3 * roofline.model_flops(narrow, (r["batch"], 256, 256, 3))
        assert r["step_ms"] > 0 and r["images_per_s"] > 0
    assert rec["verdict"].startswith(("latency-bound", "compute-bound"))


def test_train_step_is_the_loops_first_step():
    # `client.train_step`, which mfu_probe times, from fresh Adam state at
    # lr_scale 1 equals local_train's first step on the same batch and
    # affine draw (augment on).
    from hefl_tpu_torch.fl.optimizer import adam_init

    model, params = _model()
    x, y = _client_data(n=40)
    cfg = TrainConfig(epochs=1, batch_size=30, num_classes=10, val_fraction=0.25)
    perms, aug = client.epoch_index_streams(cfg, torch.Generator().manual_seed(2), len(y))
    state, _ = client.local_train_epochs(model, cfg, params, x, y,
                                         client.init_client_state(params),
                                         [(perms, aug)])
    n_val = len(y) - client.train_batch_geometry(cfg, len(y))[0]
    idx = perms[0]
    onehot = torch.nn.functional.one_hot(y[n_val:][idx].long(), 10).float()
    got, _ = client.train_step(model, cfg, params, adam_init(params), np.float32(1.0),
                               x[n_val:][idx], onehot, tuple(a[0] for a in aug), params)
    for k in got:
        assert torch.equal(got[k], state.params[k]), k


def _flagship(tmp_path, monkeypatch, *argv):
    monkeypatch.chdir(tmp_path)
    return flagship_acc.run(*argv)


def test_flagship_acc_smoke_resumes_to_the_unchunked_result(tmp_path, monkeypatch):
    # Killed after one epoch (chunk_epochs=1), evaluated early
    # (--finish-now: a partial record, the checkpoint kept), resumed: the
    # final record and model are the unchunked run's, and the unchunked
    # run's model is the secure round's own on the same generators.
    whole, chunked = tmp_path / "whole", tmp_path / "chunked"
    whole.mkdir()
    chunked.mkdir()
    want, want_params = _flagship(whole, monkeypatch, 0, True, False, 2, 0, "cpu")
    assert not (whole / "flagship_state_torch_smoke_0.npz").exists()
    assert _flagship(chunked, monkeypatch, 0, True, False, 2, 1, "cpu") == (None, None)
    assert (chunked / "flagship_state_torch_smoke_0.npz").exists()
    assert not (chunked / "flagship_acc_torch_smoke_0.json").exists()
    partial, _ = _flagship(chunked, monkeypatch, 0, True, True, 2, 0, "cpu")
    assert partial["finish_reason"] == "budget_cutoff" and partial["partial"] is True
    assert partial["epochs_run"] == 1 and partial["val_curve"] == want["val_curve"][:1]
    assert (chunked / "flagship_state_torch_smoke_0.npz").exists()
    got, got_params = _flagship(chunked, monkeypatch, 0, True, False, 2, 0, "cpu")
    assert not (chunked / "flagship_state_torch_smoke_0.npz").exists()
    assert json.loads((chunked / "flagship_acc_torch_smoke_0.json").read_text()) == got
    for key in ("val_curve", "accuracy", "precision", "recall", "f1", "params_sha256",
                "finish_reason", "epochs_run", "encode_overflow_count"):
        assert got[key] == want[key], key
    assert got["finish_reason"] == "completed" and got["epochs_run"] == 2
    for k in want_params:
        assert torch.equal(got_params[k], want_params[k]), k
    # The unchunked run is the flagship round 0 of bench.py under "vmap".
    from hefl_tpu_torch.ckks.keys import keygen
    from hefl_tpu_torch.ckks.packing import PackSpec
    from hefl_tpu_torch.data import iid_contiguous, stack_federated
    from hefl_tpu_torch.fl.secure import decrypt_average, secure_fedavg_round
    from hefl_tpu_torch.flagship import flagship_keygen_gen, flagship_round_gen, flagship_setup

    setup = flagship_setup(0, smoke=True, device="cpu")
    cfg = dataclasses.replace(setup["cfg"], epochs=2, client_fusion="vmap")
    (x, y), ctx = setup["train"], setup["ctx"]
    xs, ys = stack_federated(x, y, iid_contiguous(len(x), 2))
    sk, pk = keygen(ctx, flagship_keygen_gen(), device="cpu")
    ct_sum, _, _ = secure_fedavg_round(setup["module"], cfg, ctx, pk, setup["params"],
                                       torch.from_numpy(xs), torch.from_numpy(ys),
                                       flagship_round_gen(0, 0))
    ref = decrypt_average(ctx, sk, ct_sum, 2, PackSpec.for_params(setup["params"], ctx.n))
    assert flagship_acc.params_sha256(ref) == want["params_sha256"]


def test_flagship_acc_record_has_the_root_fields(tmp_path, monkeypatch):
    rec, _ = _flagship(tmp_path, monkeypatch, 1, True, False, None, 0, "cpu")
    root = json.loads((REPO / "flagship_acc_0.json").read_text())
    assert set(root) - {"platform_pinned", "partial"} <= set(rec)
    assert {"power_limit", "note", "params_sha256", "he_backend"} <= set(rec)
    assert rec["local_epochs"] == 1 and rec["seed"] == 1 and rec["encrypted"] is True
    assert "synthetic" in rec["note"] and rec["device"] == "cpu"
    assert abs(rec["acc_vs_reference"] - (rec["accuracy"] - 0.8425)) <= 1e-4   # both rounded
    assert (tmp_path / "flagship_acc_torch_smoke_1.json").exists()


def test_flagship_acc_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no epoch checkpoint"):
        _flagship(tmp_path, monkeypatch, 0, True, True, 2, 0, "cpu")
    assert _flagship(tmp_path, monkeypatch, 0, True, False, 3, 1, "cpu") == (None, None)
    # A checkpoint of a 3-epoch run does not resume a 2-epoch one.
    with pytest.raises(RuntimeError, match="remove it to restart"):
        _flagship(tmp_path, monkeypatch, 0, True, False, 2, 0, "cpu")
