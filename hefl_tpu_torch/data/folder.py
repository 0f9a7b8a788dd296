"""Image-folder scanning and loading: the reference's `prep_df` input.

Counterpart of `hefl_tpu.data.folder` (the same names, errors and bits).
The reference scans `image/Train` and `image/Test`, each subdirectory a
class, into a DataFrame of (Path, Label) and lets Keras decode and resize
(FLPyfhelin.py:38-55). Here the scan returns plain lists and the load
decodes with PIL into one dense uint8 array, once, up front: the driver
copies the whole set to the card once, as it does the synthetic data.

The shuffle is numpy's `default_rng(seed).permutation` and the decode is
PIL's `convert("RGB").resize((w, h))` at its default resampling, the JAX
module's calls in its order, so both packages load the same folder into
the same arrays bit for bit.
"""

from __future__ import annotations

import os

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def scan_image_folder(folder: str, shuffle: bool = True, seed: int = 42):
    """-> (paths: list[str], labels: int32[n], class_names: list[str]).

    One subdirectory per class (sorted), the image files of each sorted,
    then one global shuffle when `shuffle`."""
    class_names = sorted(
        d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d))
    )
    paths: list[str] = []
    labels: list[int] = []
    for ci, cname in enumerate(class_names):
        cdir = os.path.join(folder, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    labels_arr = np.asarray(labels, np.int32)
    if shuffle:
        perm = np.random.default_rng(seed).permutation(len(paths))
        paths = [paths[i] for i in perm]
        labels_arr = labels_arr[perm]
    return paths, labels_arr, class_names


def load_image_dataset(
    folder: str,
    image_size: tuple[int, int] = (256, 256),
    shuffle: bool = True,
    seed: int = 42,
):
    """Scan and decode a class-per-subdirectory image folder.

    -> (images uint8[n, H, W, 3], labels int32[n], class_names): every
    image decoded to RGB at `image_size` = (H, W), as the reference's
    `target_size=image_size` generators (FLPyfhelin.py:63-70)."""
    from PIL import Image

    paths, labels, class_names = scan_image_folder(folder, shuffle, seed)
    h, w = image_size
    out = np.empty((len(paths), h, w, 3), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            out[i] = np.asarray(im.convert("RGB").resize((w, h)), np.uint8)
    return out, labels, class_names


def load_folder_splits(
    data_dir: str,
    image_size: tuple[int, int] = (256, 256),
    seed: int = 42,
    test_fraction: float = 0.2,
):
    """A reference-layout dataset directory -> train and test arrays.

    With `Train/` and `Test/` subfolders (any casing), each a
    class-per-subdirectory folder, those are the splits (the training set
    shuffled, the test set in scan order); otherwise `data_dir` itself is
    scanned as one such folder, shuffled, and split
    (1 - test_fraction) / test_fraction, the test images first.

    -> ((x uint8[n, H, W, 3], y int32[n]), (xt, yt), class_names)
    """
    subdirs = {
        d.lower(): os.path.join(data_dir, d)
        for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d))
    }
    train_dir, test_dir = subdirs.get("train"), subdirs.get("test")
    if train_dir and test_dir:
        x, y, names = load_image_dataset(train_dir, image_size, True, seed)
        xt, yt, names_t = load_image_dataset(test_dir, image_size, False, seed)
        if names_t != names:
            raise ValueError(f"Train/Test class mismatch: {names} vs {names_t}")
        return (x, y), (xt, yt), names
    if train_dir or test_dir:
        raise ValueError(
            f"{data_dir} has a {'Train' if train_dir else 'Test'} subfolder "
            "but not its counterpart; provide both Train/ and Test/ (any "
            "casing) or a flat class-per-subdir folder"
        )
    x, y, names = load_image_dataset(data_dir, image_size, True, seed)
    if len(x) == 0:
        raise ValueError(
            f"no images found under {data_dir} (subdirectories scanned as "
            f"classes: {names}); expected one subdirectory per class "
            "containing image files"
        )
    n_test = int(round(len(x) * test_fraction))
    if n_test == 0 or n_test == len(x):
        raise ValueError(
            f"cannot split {len(x)} images with test_fraction={test_fraction}"
        )
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test]), names
