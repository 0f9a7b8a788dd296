"""Checkpoint / resume in the JAX package's file format (`hefl_tpu.utils.checkpoint`).

Two artifacts, both plain `.npz`, written atomically (tmp + rename):

  * params file — the parameters under `param:<Layer>/<leaf>` keys in the
    JAX package's layout (flax scope paths and names, HWIO / (in, out)
    kernels, through `convert`), so a params file written by either
    package loads in the other with the same bits.
  * round checkpoint — params + round index + the run's `torch.Generator`
    state (`rng_state`) + a JSON header with a content sha256 over every
    array: enough to resume a multi-round run exactly. A JAX round
    checkpoint holds a jax.random key (`rng_key`) instead, whose streams
    cannot be reproduced in torch, so the port refuses to resume from one.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from hefl_tpu_torch import convert


def npz_path(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths on write; normalize so
    save and load agree on the filename either way."""
    return path if path.endswith(".npz") else path + ".npz"


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be read back. Every writer here is
    atomic, so a corrupt or truncated file means damage after the write, and
    resume fails loudly rather than restore half a state."""


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of an npz, read eagerly; unreadable archives raise
    CheckpointError, a missing file stays FileNotFoundError."""
    target = npz_path(path)
    try:
        with np.load(target) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, zlib.error) as e:
        raise CheckpointError(
            f"checkpoint {target!r} is corrupt or truncated ({e}); every "
            "writer here is atomic, so this file was damaged after the "
            "write — delete it and resume from an older checkpoint"
        ) from e


def _content_sha256(arrays: dict[str, np.ndarray]) -> str:
    """Digest of a checkpoint's arrays: (name, dtype, shape, bytes) in
    sorted-name order — the JAX package's, so both packages agree on it."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _named(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's parameter dict -> {"param:Layer/leaf": JAX-layout array},
    Layer the scope path ("BasicBlock_0/Conv_0"), as the JAX package names
    its leaves."""
    return {f"param:{layer}/{leaf}": convert.flax_leaf(
                layer, leaf, params[convert.torch_name(layer, leaf)].detach()).cpu().contiguous().numpy()
            for layer, leaf in convert.ravel_order(params)}


def _restore_into(template: dict[str, torch.Tensor], arrays: dict[str, np.ndarray]) -> dict:
    """JAX-layout arrays -> a parameter dict shaped and placed like `template`."""
    named = {}
    for layer, leaf in convert.ravel_order(template):
        key = f"param:{layer}/{leaf}"
        if key not in arrays:
            raise KeyError(f"checkpoint missing parameter {key[len('param:'):]!r}")
        named[layer, leaf] = arrays[key]
    device = next(iter(template.values())).device
    out = convert.from_named(named, device=device)
    for name, t in template.items():
        if tuple(out[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name!r}: checkpoint "
                             f"{tuple(out[name].shape)} vs model {tuple(t.shape)}")
    return out


def _atomic_savez(path: str, **arrays) -> None:
    """npz write via tmp + rename: a kill mid-write never leaves a truncated
    file for the next resume."""
    target = npz_path(path)
    tmp = target + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, target)


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    """Parameter dict -> npz keyed `param:Layer/leaf`, JAX layout."""
    _atomic_savez(path, **_named(params))


def load_params(path: str, template: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A params file (of either package) -> a dict shaped and placed like
    `template`."""
    return _restore_into(template, _read_npz(path))


def _parse_header(path: str, arrays: dict[str, np.ndarray]) -> dict:
    try:
        return json.loads(bytes(arrays["header"]).decode())
    except (KeyError, ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"checkpoint {npz_path(path)!r} has a missing/unreadable "
            f"header ({e}) — the file is damaged or not a checkpoint"
        ) from e


def save_checkpoint(path: str, params: dict[str, torch.Tensor], round_index: int,
                    gen: torch.Generator, meta: dict | None = None) -> None:
    """Resumable state: (global params, next round, generator state, meta),
    with a content sha256 over every array in the header."""
    arrays = {"rng_state": gen.get_state().numpy(), **_named(params)}
    header = json.dumps({
        "round": int(round_index),
        "meta": meta or {},
        "version": 1,
        "sha256": _content_sha256(arrays),
    })
    _atomic_savez(path, header=np.frombuffer(header.encode(), dtype=np.uint8), **arrays)


def load_checkpoint(path: str, template: dict[str, torch.Tensor]):
    """-> (params, round_index, generator state uint8 tensor, meta).

    Raises CheckpointError when the file is corrupt, truncated or its arrays
    do not match the header's sha256, and ValueError for a JAX round
    checkpoint (a jax.random key, not a generator state)."""
    z = _read_npz(path)
    header = _parse_header(path, z)
    if "rng_key" in z and "rng_state" not in z:
        raise ValueError(
            f"checkpoint {npz_path(path)!r} is a hefl_tpu (JAX) round checkpoint: "
            "its rng_key is a jax.random key, and jax.random streams cannot be "
            "reproduced in torch, so the run cannot resume from it; load its "
            "weights with load_params instead"
        )
    if "rng_state" not in z or "round" not in header:
        raise CheckpointError(
            f"checkpoint {npz_path(path)!r} is missing its rng_state/round "
            "record — not a round checkpoint (or damaged)"
        )
    want = header.get("sha256")
    got = _content_sha256({k: v for k, v in z.items() if k != "header"})
    if want != got:
        raise CheckpointError(
            f"checkpoint {npz_path(path)!r} content hash mismatch "
            f"(header {str(want)[:12]}..., arrays {got[:12]}...) — the payload "
            "was altered after the write; resume must not proceed from it"
        )
    params = _restore_into(template, z)
    return params, int(header["round"]), torch.from_numpy(z["rng_state"]), header.get("meta", {})
