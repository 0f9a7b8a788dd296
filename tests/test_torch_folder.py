"""The port's image-folder loader (`data.folder`) against the JAX package's.

A tiny tree of PNG and JPEG files written to a temporary directory loads
into bitwise the arrays, labels and class names of `hefl_tpu.data.folder`,
in both layouts (Train/Test in any casing, or one folder split 80/20),
with the same errors. A folder-fed `run_experiment` trains on bitwise the
arrays the JAX driver trains on, with the same class names, class count,
model input shape and record schema; each package's decrypted averages
sit within 5e-6 of their own plaintext means (the two drivers draw
different random streams, so their numbers are not compared).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import hefl_tpu.analysis as janalysis
from hefl_tpu import experiment as jexp
from hefl_tpu.data import folder as jfolder
from hefl_tpu.fl import config as jconfig

from hefl_tpu_torch import cli, experiment
from hefl_tpu_torch.data import folder
from hefl_tpu_torch.fl.config import TrainConfig

torch.set_num_threads(2)

ERR_LIMIT = 5e-6


def _write_class_tree(root: Path, classes, per_class: int, seed: int, sizes=(16, 32)):
    """`per_class` images a class under root/<class>/, of random sizes in
    `sizes`, modes RGB, L and RGBA, saved as PNG (and every third as JPEG),
    plus a text file the extension filter must skip."""
    rng = np.random.default_rng(seed)
    for ci, name in enumerate(classes):
        d = root / name
        d.mkdir(parents=True)
        (d / "notes.txt").write_text("not an image")
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(sizes[0], sizes[1] + 1, 2))
            mode = ("RGB", "L", "RGBA")[i % 3]
            ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
            arr = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
            img = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
            ext = ".JPG" if i % 3 == 2 else ".png"
            if ext == ".JPG":
                img = img.convert("RGB")
            img.save(d / f"img_{ci}_{i:03d}{ext}")


def _assert_same_splits(got, want):
    (x, y), (xt, yt), names = got
    (jx, jy), (jxt, jyt), jnames = want
    assert names == jnames
    for a, b in ((x, jx), (y, jy), (xt, jxt), (yt, jyt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train_name,test_name", [("Train", "Test"), ("train", "TEST")])
@pytest.mark.parametrize("size", [(24, 24), (20, 28)])
def test_train_test_layout_loads_the_jax_arrays_bitwise(tmp_path, train_name, test_name, size):
    _write_class_tree(tmp_path / train_name, ["NORMAL", "PNEUMONIA", "covid"], 5, seed=1)
    _write_class_tree(tmp_path / test_name, ["NORMAL", "PNEUMONIA", "covid"], 2, seed=2)
    got = folder.load_folder_splits(str(tmp_path), image_size=size, seed=7)
    _assert_same_splits(got, jfolder.load_folder_splits(str(tmp_path), image_size=size, seed=7))
    (x, y), (xt, yt), names = got
    assert x.shape == (15, *size, 3) and xt.shape == (6, *size, 3)
    assert names == ["NORMAL", "PNEUMONIA", "covid"]
    # The training split is shuffled, the test split keeps the scan order.
    assert yt.tolist() == [0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("test_fraction", [0.2, 0.5])
def test_flat_layout_splits_as_the_jax_loader(tmp_path, seed, test_fraction):
    _write_class_tree(tmp_path, ["a", "b"], 6, seed=3)
    got = folder.load_folder_splits(str(tmp_path), (16, 16), seed, test_fraction)
    _assert_same_splits(got, jfolder.load_folder_splits(str(tmp_path), (16, 16), seed,
                                                        test_fraction))
    n_test = int(round(12 * test_fraction))
    assert len(got[1][0]) == n_test and len(got[0][0]) == 12 - n_test


@pytest.mark.parametrize("shuffle", [True, False])
def test_scan_and_load_match_the_jax_functions(tmp_path, shuffle):
    _write_class_tree(tmp_path, ["x", "y", "z"], 4, seed=4)
    paths, labels, names = folder.scan_image_folder(str(tmp_path), shuffle, seed=5)
    jpaths, jlabels, jnames = jfolder.scan_image_folder(str(tmp_path), shuffle, seed=5)
    assert paths == jpaths and names == jnames and labels.dtype == jlabels.dtype == np.int32
    np.testing.assert_array_equal(labels, jlabels)
    assert len(paths) == 12 and not any(p.endswith(".txt") for p in paths)
    imgs, lab, _ = folder.load_image_dataset(str(tmp_path), (18, 22), shuffle, seed=5)
    jimgs, jlab, _ = jfolder.load_image_dataset(str(tmp_path), (18, 22), shuffle, seed=5)
    assert imgs.shape == (12, 18, 22, 3) and imgs.dtype == np.uint8
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(lab, jlab)


def _mismatch(root: Path):
    _write_class_tree(root / "Train", ["a", "b"], 2, seed=5)
    _write_class_tree(root / "Test", ["a", "c"], 2, seed=6)


def _train_only(root: Path):
    _write_class_tree(root / "Train", ["a", "b"], 2, seed=5)


def _test_only(root: Path):
    _write_class_tree(root / "test", ["a", "b"], 2, seed=5)


def _empty(root: Path):
    (root / "a").mkdir()
    (root / "b").mkdir()


def _unsplittable(root: Path):
    _write_class_tree(root, ["a"], 1, seed=5)


@pytest.mark.parametrize("make", [_mismatch, _train_only, _test_only, _empty, _unsplittable],
                         ids=["class_mismatch", "train_only", "test_only", "no_images",
                              "unsplittable"])
def test_errors_are_the_jax_loaders(tmp_path, make):
    make(tmp_path)
    with pytest.raises(ValueError) as jerr:
        jfolder.load_folder_splits(str(tmp_path), (16, 16))
    with pytest.raises(ValueError) as terr:
        folder.load_folder_splits(str(tmp_path), (16, 16))
    assert str(terr.value) == str(jerr.value)


# --- a folder-fed run through both drivers ------------------------------------------

TINY_TRAIN = dict(epochs=1, batch_size=8, num_classes=10, augment=False, val_fraction=0.25)


def _folder_cfg(pkg_exp, pkg_train, data_dir: str, **kw):
    return pkg_exp.ExperimentConfig(
        model="smallcnn", data_dir=data_dir, image_size=(28, 28), num_clients=2, rounds=2,
        train=pkg_train(**TINY_TRAIN), he=pkg_exp.HEConfig(n=256), seed=3, **kw)


def _spy(monkeypatch, module, seen: dict):
    """Record what a driver module trains on and builds, and each decrypted
    round's distance from its plaintext mean."""
    real_stack, real_create = module.stack_federated, module.create_model
    real_round, real_decrypt = module.secure_fedavg_round, module.decrypt_average
    refs = []

    def stack_federated(x, y, parts):
        seen["x"], seen["y"] = np.asarray(x).copy(), np.asarray(y).copy()
        return real_stack(x, y, parts)

    def create_model(name, **k):
        seen["model"] = (name, k["num_classes"], tuple(k["input_shape"]))
        return real_create(name, **k)

    def round_with_reference(*a, **k):
        *outs, ref = real_round(*a, with_plain_reference=True, **k)
        refs.append(ref)
        return tuple(outs)

    def decrypt(*a, **k):
        avg = real_decrypt(*a, **k)
        got, ref = _flat_leaves(avg), _flat_leaves(refs[-1])
        assert got.keys() == ref.keys()
        seen.setdefault("errs", []).append(max(
            float(np.max(np.abs(np.asarray(got[k]) - np.asarray(ref[k])))) for k in ref))
        return avg

    monkeypatch.setattr(module, "stack_federated", stack_federated)
    monkeypatch.setattr(module, "create_model", create_model)
    monkeypatch.setattr(module, "secure_fedavg_round", round_with_reference)
    monkeypatch.setattr(module, "decrypt_average", decrypt)


def _flat_leaves(tree) -> dict:
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = node
    walk("", tree)
    return out


def test_folder_fed_run_trains_on_the_jax_drivers_arrays(tmp_path, monkeypatch):
    _write_class_tree(tmp_path / "Train", ["NORMAL", "PNEUMONIA"], 12, seed=8)
    _write_class_tree(tmp_path / "Test", ["NORMAL", "PNEUMONIA"], 4, seed=9)
    monkeypatch.setattr(janalysis, "check_experiment", lambda *a, **k: None)
    jseen, tseen = {}, {}
    _spy(monkeypatch, jexp, jseen)
    _spy(monkeypatch, experiment, tseen)
    want = jexp.run_experiment(_folder_cfg(jexp, jconfig.TrainConfig, str(tmp_path)),
                               verbose=False)
    got = experiment.run_experiment(_folder_cfg(experiment, TrainConfig, str(tmp_path),
                                                events_path=""), verbose=False, device="cpu")
    assert tseen["x"].shape == (24, 28, 28, 3) and tseen["x"].dtype == np.uint8
    np.testing.assert_array_equal(tseen["x"], jseen["x"])
    np.testing.assert_array_equal(tseen["y"], jseen["y"])
    # The folder's 2 classes replace TrainConfig's 10; the model takes the
    # decoded images' shape.
    assert tseen["model"] == jseen["model"] == ("smallcnn", 2, (28, 28, 3))
    assert len(tseen["errs"]) == len(jseen["errs"]) == 2
    assert max(tseen["errs"]) <= ERR_LIMIT and max(jseen["errs"]) <= ERR_LIMIT
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys() and g["phases"].keys() == w["phases"].keys()
        assert g["encode_overflow"] == w["encode_overflow"] == [0, 0]
    for key in ("augment_backend", "client_fusion", "he_backend", "mesh"):
        assert got[key].keys() == want[key].keys(), key
    jshapes = sorted(tuple(np.shape(v)) for v in _flat_leaves(want["params"]).values())
    assert sum(int(np.prod(s)) for s in jshapes) == sum(v.numel() for v in got["params"].values())
    assert min(v.numel() for v in got["params"].values()) == min(
        int(np.prod(s)) for s in jshapes) == 2          # the 2-class head's bias


def test_cli_trains_on_a_folder(tmp_path, monkeypatch):
    # The CLI's --data-dir / --image-size reach run_experiment: a flat
    # folder of 3 classes gives a 3-class model at 24x24x3.
    _write_class_tree(tmp_path / "data", ["a", "b", "c"], 10, seed=10)
    seen = {}
    real_create = experiment.create_model

    def create_model(name, **k):
        seen["model"] = (name, k["num_classes"], tuple(k["input_shape"]))
        return real_create(name, **k)

    monkeypatch.setattr(experiment, "create_model", create_model)
    args = cli.parse_args(["--model", "smallcnn", "--data-dir", str(tmp_path / "data"),
                           "--image-size", "24", "--epochs", "1", "--batch-size", "8",
                           "--he-n", "256", "--no-augment", "--no-save-model", "--no-events",
                           "--device", "cpu"])
    history = cli.run(args, verbose=False)
    assert seen["model"] == ("smallcnn", 3, (24, 24, 3))
    assert len(history) == 1 and history[0]["encode_overflow"] == [0, 0]
    assert 0.0 <= history[0]["accuracy"] <= 1.0


def test_centralized_run_reads_the_folder(tmp_path):
    # A centralized run reads the folder too (the JAX driver's branch
    # order: the data before the centralized branch).
    _write_class_tree(tmp_path, ["a", "b"], 10, seed=11)
    cfg = _folder_cfg(experiment, TrainConfig, str(tmp_path), events_path="")
    out = experiment.run_experiment(dataclasses.replace(cfg, centralized=True, rounds=1),
                                    verbose=False, device="cpu")
    assert len(out["history"]) == 1 and 0.0 <= out["final_metrics"]["accuracy"] <= 1.0
