"""The port's checkpoint files against the JAX package's, and resume.

Params files move between the packages bitwise in both directions (same
`param:Layer/leaf` keys, JAX layout, same content digest); a damaged round
checkpoint raises CheckpointError; a JAX round checkpoint (a jax.random key)
is refused by name; and on the CPU a resumed run is bitwise the
uninterrupted one.
"""

import time
import zipfile

import numpy as np
import jax
import pytest
import torch

from hefl_tpu.models import create_model as jcreate_model
from hefl_tpu.utils import checkpoint as jck

from hefl_tpu_torch import convert
from hefl_tpu_torch.experiment import ExperimentConfig, HEConfig, run_experiment
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.utils import PhaseTimer, checkpoint

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams():
    _, params = jcreate_model("smallcnn", rng=jax.random.key(7))
    return jax.tree_util.tree_map(np.asarray, params)


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_jax_params_file_loads_in_the_port_bitwise(tmp_path, jparams):
    path = str(tmp_path / "jax.npz")
    jck.save_params(path, jparams)
    template = {k: torch.zeros_like(v) for k, v in convert.from_flax(jparams).items()}
    _same(checkpoint.load_params(path, template), convert.from_flax(jparams))


def test_port_params_file_loads_in_jax_bitwise(tmp_path, jparams):
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, convert.from_flax(jparams))
    loaded = jck.load_params(path, jparams)
    for (kp, got), want in zip(jax.tree_util.tree_leaves_with_path(loaded),
                               jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(kp))


def test_both_packages_write_the_same_params_arrays(tmp_path, jparams):
    jck.save_params(str(tmp_path / "j.npz"), jparams)
    checkpoint.save_params(str(tmp_path / "t.npz"), convert.from_flax(jparams))
    ja, ta = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    assert ja.keys() == ta.keys() and all(k.startswith("param:") for k in ja)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, k
        np.testing.assert_array_equal(ja[k], ta[k])
    assert jck._content_sha256(ja) == checkpoint._content_sha256(ta)


def test_round_checkpoint_roundtrips_params_round_and_generator(tmp_path, jparams):
    params = convert.from_flax(jparams)
    gen = torch.Generator().manual_seed(11)
    torch.randint(0, 10, (5,), generator=gen)
    path = str(tmp_path / "ck")                  # the .npz suffix is added
    checkpoint.save_checkpoint(path, params, 3, gen, meta={"model": "smallcnn"})
    want = torch.randint(0, 2**62, (4,), generator=gen)
    got_params, rnd, state, meta = checkpoint.load_checkpoint(path, params)
    _same(got_params, params)
    assert rnd == 3 and meta == {"model": "smallcnn"}
    resumed = torch.Generator()
    resumed.set_state(state)
    assert torch.equal(torch.randint(0, 2**62, (4,), generator=resumed), want)


def _rewrite(path, arrays: dict) -> None:
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("damage", ["flip_payload_byte", "altered_array", "truncated"])
def test_damaged_round_checkpoint_raises_checkpoint_error(tmp_path, jparams, damage):
    params = convert.from_flax(jparams)
    path = tmp_path / "ck.npz"
    checkpoint.save_checkpoint(str(path), params, 1, torch.Generator().manual_seed(0))
    if damage == "flip_payload_byte":
        # One byte inside a stored (uncompressed) member: the zip CRC fails.
        arrays = _npz(path)
        np.savez(path, **arrays)
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo("param:Dense_1/kernel.npy")
        raw = bytearray(path.read_bytes())
        raw[info.header_offset + 30 + len(info.filename) + 200] ^= 0x01
        path.write_bytes(bytes(raw))
    elif damage == "altered_array":
        # A payload that decompresses cleanly but is not what was written:
        # only the header's content sha256 catches it.
        arrays = _npz(path)
        arrays["param:Dense_1/bias"] = arrays["param:Dense_1/bias"] + np.float32(1.0)
        _rewrite(path, arrays)
    else:
        path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.load_checkpoint(str(path), params)


def test_missing_checkpoint_is_file_not_found(tmp_path, jparams):
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none.npz"), convert.from_flax(jparams))


def test_jax_round_checkpoint_is_refused_naming_the_rng(tmp_path, jparams):
    path = str(tmp_path / "jax_round.npz")
    jck.save_checkpoint(path, jparams, 2, jax.random.key(5))
    with pytest.raises(ValueError, match="jax.random streams cannot be reproduced in torch"):
        checkpoint.load_checkpoint(path, convert.from_flax(jparams))
    # Its weights still load as a params file.
    _same(checkpoint.load_params(path, convert.from_flax(jparams)), convert.from_flax(jparams))


def _tiny(**kw) -> ExperimentConfig:
    base = dict(model="smallcnn", dataset="mnist", num_clients=2, rounds=2,
                train=TrainConfig(epochs=1, batch_size=8, num_classes=10, augment=False,
                                  val_fraction=0.25),
                he=HEConfig(n=256), n_train=64, n_test=32, seed=3)
    base.update(kw)
    return ExperimentConfig(**base)


@pytest.mark.parametrize("encrypted", [True, False])
def test_resume_equals_the_uninterrupted_run_bitwise(tmp_path, encrypted):
    full = run_experiment(_tiny(encrypted=encrypted), verbose=False, device="cpu")
    path = str(tmp_path / "ck.npz")
    first = run_experiment(_tiny(encrypted=encrypted, rounds=1, checkpoint_path=path),
                           verbose=False, device="cpu")
    saved, rnd, _, _ = checkpoint.load_checkpoint(path, first["params"])
    assert rnd == 1
    _same(saved, first["params"])
    resumed = run_experiment(_tiny(encrypted=encrypted, checkpoint_path=path), resume=True,
                             verbose=False, device="cpu")
    assert [r["round"] for r in resumed["history"]] == [1]
    _same(resumed["params"], full["params"])
    drop = ("phases", "phase_roofline")
    assert ({k: v for k, v in resumed["history"][0].items() if k not in drop}
            == {k: v for k, v in full["history"][1].items() if k not in drop})


def test_save_model_artifact_roundtrips(tmp_path):
    path = str(tmp_path / "agg.npz")
    out = run_experiment(_tiny(rounds=1, save_model_path=path), verbose=False, device="cpu")
    _same(checkpoint.load_params(path, out["params"]), out["params"])


def test_phase_timer_accumulates_phases_in_order():
    t = PhaseTimer("cpu")
    for name in ("train", "decrypt", "train", "evaluate"):
        with t.phase(name):
            time.sleep(0.01)
    s = t.summary()
    assert list(s) == ["train", "decrypt", "evaluate", "total"]
    assert s["train"] >= 0.02 and s["evaluate"] >= 0.01
    assert s["total"] == pytest.approx(s["train"] + s["decrypt"] + s["evaluate"], abs=2e-4)
