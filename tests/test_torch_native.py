"""The port's exact CRT decode (`hefl_tpu_torch.native`, `csrc/crt.cpp`)
held against the Python-bignum plain version and the JAX package.

The native Garner CRT, the port's bignum path (`decode_exact_plain`) and the
JAX package's `decode_exact(prefer_native=False)` must agree bit for bit on
any canonical residues, values near +-q/2 and non-power-of-two scales
included; `decrypt_average(exact=True)` must equal the JAX package's exact
decode of the same ciphertext. A library that does not build raises: there
is no fallback.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jencoding
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.ckks.packing import PackSpec as JPackSpec
from hefl_tpu.ckks.packing import pack_pytree as jpack_pytree
from hefl_tpu.fl import secure as jsecure

from hefl_tpu_torch import convert, native
from hefl_tpu_torch.ckks import encoding, keys
from hefl_tpu_torch.ckks.ntt import NTTContext
from hefl_tpu_torch.ckks.packing import PackSpec
from hefl_tpu_torch.ckks.primes import find_ntt_primes
from hefl_tpu_torch.fl import secure

SCALES = (1.0, 2.0**30, 3 * 2.0**30, 5 * 2.0**44)


def _residues(p, shape, seed, targets=()):
    """Random canonical residues [*shape, L, N] with `targets` (exact
    integers) written into the first coefficients of the first row."""
    rng = np.random.default_rng(seed)
    res = np.stack([rng.integers(0, int(pi), size=shape, dtype=np.uint32) for pi in p], axis=-2)
    for k, t in enumerate(targets):
        res.reshape(-1, len(p), shape[-1])[0, :, k] = [t % int(pi) for pi in p]
    return res


def _edge_targets(p):
    q = int(np.prod([int(pi) for pi in p], dtype=object))
    return (q // 2, q // 2 + 1, q // 2 - 1, 0, 1, q - 1, q // 3, 2**53 + 1, 2**54 + 2,
            2**54 + 6, 2**60 + 2**7)


@pytest.mark.parametrize("num_primes,n", [(1, 256), (2, 256), (3, 1024), (5, 512), (8, 256)])
def test_native_equals_bignum_plain_version(num_primes, n):
    ctx = NTTContext.build(find_ntt_primes(num_primes, 27, 2 * n), n)
    p = np.asarray(ctx.p)[:, 0]
    res = _residues(p, (3, n), num_primes, _edge_targets(p))
    for scale in SCALES:
        got = encoding.decode_exact(ctx, res, scale)
        want = encoding.decode_exact_plain(ctx, res, scale)
        assert got.dtype == np.float64 and got.shape == (3, n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_primes,n", [(3, 128), (5, 512)])
def test_native_bignum_and_jax_decode_exact_agree_bitwise(num_primes, n):
    jctx = jkeys.CkksContext.create(n=n, num_primes=num_primes)
    tctx = keys.CkksContext.create(n=n, num_primes=num_primes)
    p = np.asarray(jctx.ntt.p)[:, 0]
    res = _residues(p, (7, n), 10 + num_primes, _edge_targets(p))
    for scale in SCALES:
        want = jencoding.decode_exact(jctx.ntt, res, scale, prefer_native=False)
        np.testing.assert_array_equal(encoding.decode_exact(tctx.ntt, res, scale), want)
        np.testing.assert_array_equal(encoding.decode_exact_plain(tctx.ntt, res, scale), want)


def test_native_rejects_bad_input():
    ctx = NTTContext.build(find_ntt_primes(3, 27, 512), 256)
    p = np.asarray(ctx.p)[:, 0]
    res = _residues(p, (2, 256), 3)
    res[1, 2, 5] = p[2]                                 # one residue == its prime
    with pytest.raises(ValueError, match="not canonical"):
        encoding.decode_exact(ctx, res, 1.0)
    with pytest.raises(ValueError, match="primes for residues"):
        native.crt_decode_exact(res, p[:2], 1.0)
    with pytest.raises(ValueError, match="prime count"):
        native.crt_decode_exact(np.zeros((1, 9, 8), np.uint32), np.full(9, 97, np.uint32), 1.0)


def test_native_build_failure_raises_no_fallback(tmp_path, monkeypatch):
    broken = tmp_path / "crt.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    ctx = NTTContext.build(find_ntt_primes(3, 27, 512), 256)
    with pytest.raises(RuntimeError, match="failed building"):
        encoding.decode_exact(ctx, _residues(np.asarray(ctx.p)[:, 0], (1, 256), 4), 1.0)
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_library_is_keyed_by_its_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libhefl_crt_")
    native.load_library()
    assert path.exists()


def test_decrypt_average_exact_matches_jax_exact_decode():
    # One encrypted block of weights decrypted as a 3-client average (scale
    # * 3, not a power of two): the exact decode is the JAX package's bit
    # for bit, and within one float32 ulp-scale of the float path.
    jctx, tctx = jkeys.CkksContext.create(n=256), keys.CkksContext.create(n=256)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(1))
    sk, _ = convert.keys_from_jax(jsk, jpk)
    rng = np.random.default_rng(2)
    tree = {"Dense_0": {"bias": rng.normal(0, 0.2, (10,)).astype(np.float32),
                        "kernel": rng.normal(0, 0.2, (40, 10)).astype(np.float32)}}
    jspec = JPackSpec.for_params(tree, 256)
    m = jencoding.encode(jctx.ntt, jpack_pytree(tree, 256), jctx.scale)
    jct = jops.encrypt(jctx, jpk, m, jax.random.key(3))
    want = jsecure.decrypt_average(jctx, jsk, jct, 3, jspec, exact=True)
    params = convert.from_flax(tree)
    spec = PackSpec.for_params(params, 256)
    ct = convert.ciphertext_from_jax(jct)
    got = secure.decrypt_average(tctx, sk, ct, 3, spec, exact=True)
    flat = convert.to_flax(got)
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            np.testing.assert_array_equal(flat[layer][leaf], np.asarray(w))
            np.testing.assert_allclose(flat[layer][leaf], tree[layer][leaf] / 3, atol=5e-6)
    floated = secure.decrypt_average(tctx, sk, ct, 3, spec)
    assert max((floated[k] - got[k]).abs().max().item() for k in got) <= 1e-6
    assert all(v.dtype == torch.float32 for v in got.values())
    assert jnp.asarray(m).shape == (jspec.n_ct, 3, 256)
