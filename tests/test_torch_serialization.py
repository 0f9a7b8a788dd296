"""The port's wire files (`hefl_tpu_torch.utils.serialization`) against the
JAX package's (`hefl_tpu.utils.serialization`).

Each kind (public material, secret, relin and Galois keys, ciphertext) is
written by one package and read by the other, both ways: every array
bitwise (the port's int32 residues are the JAX package's uint32 words), the
context's tables and scalars equal. A wrong magic or kind raises. A
ciphertext that goes through a file decrypts bitwise as the one in memory.
"""

import json

import numpy as np
import jax
import pytest
import torch

from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops
from hefl_tpu.utils import serialization as jser

from hefl_tpu_torch import convert
from hefl_tpu_torch.ckks import encoding, keys, ops
from hefl_tpu_torch.utils import serialization as ser

torch.set_num_threads(2)

NTT_FIELDS = ("p", "pinv_neg", "r2", "psi_rev", "psi_inv_rev", "n_inv_mont")


@pytest.fixture(scope="module")
def material():
    """The same keys and ciphertext in both packages (JAX-made, converted)."""
    jctx = jkeys.CkksContext.create(n=256)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(1))
    jrlk = jkeys.gen_relin_key(jctx, jsk, jax.random.key(2))
    jgk = jkeys.gen_galois_key(jctx, jsk, jax.random.key(3), 5)
    tctx = keys.CkksContext.create(n=256)
    sk, pk = convert.keys_from_jax(jsk, jpk)
    w = np.random.default_rng(0).normal(0, 0.1, (2, 256)).astype(np.float32)
    gen = torch.Generator().manual_seed(4)
    m_res = encoding.encode(tctx.ntt, torch.from_numpy(w)[None], tctx.scale)
    ct = ops.encrypt_batch(tctx, pk, m_res, [gen])
    jct = jops.Ciphertext(c0=jax.numpy.asarray(ct.c0.numpy().view(np.uint32)),
                          c1=jax.numpy.asarray(ct.c1.numpy().view(np.uint32)), scale=ct.scale)
    return dict(
        public=((jctx, jpk), (tctx, pk)),
        secret=(jsk, sk),
        relin=(jrlk, convert.relin_key_from_jax(jrlk)),
        galois=(jgk, convert.galois_keys_from_jax({5: jgk})[5]),
        ciphertext=(jct, ct),
    )


SAVE = {"public": "save_public_material", "secret": "save_secret_key",
        "relin": "save_relin_key", "galois": "save_galois_key", "ciphertext": "save_ciphertext"}
LOAD = {k: v.replace("save_", "load_") for k, v in SAVE.items()}
ARRAYS = {"public": ("b_mont", "a_mont"), "secret": ("s_mont",), "relin": ("b_mont", "a_mont"),
          "galois": ("b_mont", "a_mont"), "ciphertext": ("c0", "c1")}


def _obj_arrays(kind, obj):
    """{name: uint32 array} of a key/ciphertext object of either package."""
    if kind == "public":
        ctx, obj = obj
    out = {}
    for name in ARRAYS[kind]:
        a = getattr(obj, name)
        out[name] = (a.numpy().view(np.uint32) if isinstance(a, torch.Tensor)
                     else np.asarray(a, dtype=np.uint32))
    if kind == "public":
        out.update({f: np.asarray(getattr(ctx.ntt, f), dtype=np.uint32) for f in NTT_FIELDS})
    return out


def _scalars(kind, obj):
    if kind == "public":
        ctx = obj[0]
        return (ctx.n, ctx.scale, ctx.sigma)
    if kind == "galois":
        return (obj.g,)
    if kind == "ciphertext":
        return (obj.scale,)
    return ()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("kind", list(SAVE))
def test_wire_files_move_between_the_packages_bitwise(material, kind, direction, tmp_path):
    jobj, tobj = material[kind]
    path = str(tmp_path / f"{kind}.npz")
    writer, reader = (ser, jser) if direction == "port_to_jax" else (jser, ser)
    src = tobj if direction == "port_to_jax" else jobj
    args = src if kind == "public" else (src,)
    getattr(writer, SAVE[kind])(path, *args)
    loaded = getattr(reader, LOAD[kind])(path)
    if direction == "jax_to_port":
        obj = loaded if kind != "public" else loaded[1]
        for name in ARRAYS[kind]:
            t = getattr(obj, name)
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32, name
    want = _obj_arrays(kind, jobj if direction == "port_to_jax" else tobj)
    got = _obj_arrays(kind, loaded)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert _scalars(kind, loaded) == _scalars(kind, src)
    # The file itself: the same members and header in both packages.
    with np.load(path) as z:
        assert set(z.files) == {"header", *ARRAYS[kind], *(NTT_FIELDS if kind == "public"
                                                             else ())}
        header = json.loads(bytes(z["header"]).decode())
    assert header["magic"] == "hefl-tpu-wire-v1" and header["kind"] == kind


def test_ciphertext_through_a_file_decrypts_bitwise(material, tmp_path):
    (_, _), (tctx, _) = material["public"]
    _, sk = material["secret"]
    _, ct = material["ciphertext"]
    ser.save_secret_key(str(tmp_path / "sk.npz"), sk)
    ser.save_ciphertext(str(tmp_path / "ct.npz"), ct)
    sk2 = ser.load_secret_key(str(tmp_path / "sk.npz"))
    ct2 = ser.load_ciphertext(str(tmp_path / "ct.npz"))
    assert torch.equal(ops.decrypt(tctx, sk2, ct2), ops.decrypt(tctx, sk, ct))


@pytest.mark.parametrize("fault", ["magic", "kind"])
def test_wrong_magic_or_kind_raises(material, fault, tmp_path):
    _, sk = material["secret"]
    path = str(tmp_path / "sk.npz")
    if fault == "kind":
        ser.save_secret_key(path, sk)
        with pytest.raises(ValueError, match="expected kind='ciphertext', got 'secret'"):
            ser.load_ciphertext(path)
        return
    header = json.dumps({"magic": "not-hefl", "kind": "secret"}).encode()
    np.savez_compressed(path, header=np.frombuffer(header, dtype=np.uint8),
                        s_mont=sk.s_mont.numpy().view(np.uint32))
    with pytest.raises(ValueError, match="not a hefl-tpu-wire-v1 file"):
        ser.load_secret_key(path)
