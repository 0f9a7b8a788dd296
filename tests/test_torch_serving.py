"""The port's encrypted-inference serving path held against the JAX package.

The JAX package makes the keys and encrypts the queries; both go to the port
through `hefl_tpu_torch.convert`, and both packages score the same
ciphertexts with the same Galois/relin keys. Every output is a canonical
residue, so the port's ciphertexts must be BITWISE equal to the JAX
package's, in every rotation mode; the decrypted scores sit within 0.05 of
the plaintext model, the JAX tests' tolerance. The JAX side runs its XLA
path, the default off-TPU.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from hefl_tpu import he_inference as jhei
from hefl_tpu.ckks import keys as jkeys
from hefl_tpu.ckks import ops as jops

from hefl_tpu_torch import he_inference as hei
from hefl_tpu_torch.ckks import cuda_ntt, encoding, keys, ops
from hefl_tpu_torch.convert import (
    ciphertext_from_jax,
    galois_keys_from_jax,
    keys_from_jax,
    relin_key_from_jax,
)

torch.set_num_threads(2)

D, K = 20, 3            # features, classes: a ragged diagonal window at 128 slots


def _same(got, want) -> None:
    """Bitwise equality of a port Ciphertext and a JAX one."""
    for g, w in ((got.c0, want.c0), (got.c1, want.c1)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.contiguous().numpy().view(np.uint32), np.asarray(w))
    assert got.scale == want.scale


@pytest.fixture(scope="module")
def setup():
    """n=256 (128 slots), L=3; JAX keys for every step of the (d=20, K=3)
    plan, converted to the port."""
    jctx = jkeys.CkksContext.create(n=256)
    tctx = keys.CkksContext.create(n=256)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(100))
    sk, pk = keys_from_jax(jsk, jpk)
    plan = jhei.bsgs_plan(128, D, K)
    assert dataclasses.astuple(plan) == dataclasses.astuple(hei.bsgs_plan(128, D, K))
    jgks = jhei.gen_rotation_keys_for_steps(jctx, jsk, jax.random.key(101), plan.rotation_steps_needed)
    rng = np.random.default_rng(102)
    model = rng.normal(0, 0.3, (K, D)), rng.normal(0, 0.2, K)
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, jpk=jpk, sk=sk, pk=pk, jgks=jgks,
                gks=galois_keys_from_jax(jgks), model=model, rng=rng)


def _query(s, x, seed):
    jct = jhei.encrypt_features(s["jctx"], s["jpk"], x, jax.random.key(seed))
    return jct, ciphertext_from_jax(jct)


def test_ct_rotate_bitwise(setup):
    s = setup
    x = s["rng"].normal(0, 0.5, 128)
    jct, ct = _query(s, x, 103)
    rot = jax.jit(jops.ct_rotate, static_argnums=(0, 3))
    for step in (1, 5):
        got = ops.ct_rotate(s["tctx"], ct, s["gks"][step], step)
        _same(got, rot(s["jctx"], jct, s["jgks"][step], step))
        z = encoding.decode_slots(
            s["tctx"].ntt, ops.decrypt(s["tctx"], s["sk"], got).numpy().view(np.uint32), got.scale)
        np.testing.assert_allclose(np.real(z), np.roll(x, -step), atol=0.01)
    with pytest.raises(ValueError, match="needs g="):
        ops.ct_rotate(s["tctx"], ct, s["gks"][1], 2)


def test_hoisted_rotations_bitwise(setup):
    # Hoisted == its unhoisted reference in the port, and both == JAX.
    s = setup
    jct, ct = _query(s, s["rng"].normal(0, 0.5, 128), 104)
    steps = (1, 2, 5)
    got = ops.hoisted_rotations(s["tctx"], ct, steps, s["gks"])
    ref = ops.hoisted_rotations_reference(s["tctx"], ct, steps, s["gks"])
    assert torch.equal(got.c0, ref.c0) and torch.equal(got.c1, ref.c1)
    jops.hoisted_rotation_tables(s["jctx"], s["jgks"], steps)   # host tables, outside jit
    want = jax.jit(jops.hoisted_rotations, static_argnums=(0, 2))(s["jctx"], jct, steps, s["jgks"])
    _same(got, want)


def test_ct_mul_and_rescale_bitwise(setup):
    # ct x ct with relinearization (K5's eval-input mode on the CPU), then
    # two rescales down to one limb: bitwise vs JAX at every step.
    s = setup
    jctx, tctx = s["jctx"], s["tctx"]
    jrlk = jkeys.gen_relin_key(jctx, s["jsk"], jax.random.key(105))
    rlk = relin_key_from_jax(jrlk)
    ja, a = _query(s, s["rng"].normal(0, 0.5, 128), 106)
    jb, b = _query(s, s["rng"].normal(0, 0.5, 128), 107)
    cuda_ntt.reset_launch_counts()
    got = ops.ct_mul(tctx, a, b, rlk)
    want = jax.jit(jops.ct_mul, static_argnums=0)(jctx, ja, jb, jrlk)
    _same(got, want)
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)
    jcur, cur, jc, c = jctx, tctx, want, got
    for level in (2, 1):
        jcur, jc = jops.rescale(jcur, jc)
        cur, c = ops.rescale(cur, c)
        assert cur.num_primes == jcur.num_primes == level
        assert cur.ksk_digit_bits == jcur.ksk_digit_bits
        _same(c, jc)
    with pytest.raises(ValueError, match="last level"):
        ops.rescale(cur, c)


@pytest.mark.parametrize("mode", ["hoisted", "unhoisted", "legacy"])
def test_bsgs_linear_scorer_bitwise_vs_jax(setup, mode):
    # One query (score) and a packed batch (score_many: q=2 queries per
    # ciphertext, 3 ciphertexts padded to the bucket of 4): the port's
    # output ciphertexts are bitwise the JAX scorer's, and decrypt within
    # 0.05 of x @ W.T + b.
    s = setup
    W, b = s["model"]
    tctx, jctx = s["tctx"], s["jctx"]
    x = s["rng"].normal(0, 0.5, D)
    jct, ct = _query(s, x, 108)
    scorer = hei.BsgsLinearScorer(tctx, W, b, s["gks"], rotation_mode=mode, device="cpu")
    jscorer = jhei.BsgsLinearScorer(jctx, W, b, s["jgks"], rotation_mode=mode)
    assert dataclasses.astuple(scorer.plan) == dataclasses.astuple(jscorer.plan)
    assert scorer.plan.num_keyswitches == 8
    assert (scorer.hoisted_ntts, scorer.unhoisted_ntts) == (jscorer.hoisted_ntts, jscorer.unhoisted_ntts)
    out = scorer.score(ct)
    _same(out, jscorer.score(jct))
    got = hei.decrypt_class_scores(tctx, s["sk"], out, K)
    np.testing.assert_allclose(got, x @ W.T + b, atol=0.05)

    xs = s["rng"].normal(0, 0.5, (3, 2, D))
    jcts = jhei.encrypt_query_block(jctx, s["jpk"], xs, jax.random.key(109), 2)
    packed = hei.BsgsLinearScorer(tctx, W, b, s["gks"], queries_per_ct=2,
                                  rotation_mode=mode, device="cpu")
    jpacked = jhei.BsgsLinearScorer(jctx, W, b, s["jgks"], queries_per_ct=2, rotation_mode=mode)
    out = packed.score_many(ciphertext_from_jax(jcts))
    _same(out, jpacked.score_many(jcts))
    got = hei.decrypt_class_scores(tctx, s["sk"], out, K, queries_per_ct=2)
    assert got.shape == (3, 2, K)
    np.testing.assert_allclose(got, xs @ W.T + b, atol=0.05)


def test_serving_client_side_and_shapes(setup):
    # The port's own client side: its encryption decrypts to the features
    # in the slots, the scorer rejects wrong shapes and scales, and the
    # batch bucket is the next power of two.
    s = setup
    tctx = s["tctx"]
    gen = torch.Generator().manual_seed(110)
    x = s["rng"].normal(0, 0.5, D)
    ct = hei.encrypt_features(tctx, s["pk"], x, gen)
    z = encoding.decode_slots(tctx.ntt, ops.decrypt(tctx, s["sk"], ct).numpy().view(np.uint32), ct.scale)
    np.testing.assert_allclose(np.real(z[:D]), x, atol=1e-5)
    np.testing.assert_allclose(np.real(z[D:]), 0, atol=1e-5)
    W, b = s["model"]
    scorer = hei.BsgsLinearScorer(tctx, W, b, s["gks"], device="cpu")
    got = hei.decrypt_class_scores(tctx, s["sk"], scorer.score(ct), K)
    np.testing.assert_allclose(got, x @ W.T + b, atol=0.05)
    with pytest.raises(ValueError, match="one sample"):
        scorer.score(ops.Ciphertext(ct.c0[None], ct.c1[None], ct.scale))
    with pytest.raises(ValueError, match="batched"):
        scorer.score_many(ct)
    with pytest.raises(ValueError, match="scale"):
        scorer.score(ops.Ciphertext(ct.c0, ct.c1, 2.0))
    with pytest.raises(ValueError, match="rotation keys missing"):
        hei.BsgsLinearScorer(tctx, W, b, {1: s["gks"][1]}, device="cpu")
    with pytest.raises(ValueError, match="rotation_mode"):
        hei.BsgsLinearScorer(tctx, W, b, s["gks"], rotation_mode="fast", device="cpu")
    assert [hei.serving_batch_bucket(n) for n in (1, 2, 3, 4, 5, 16, 17)] == [1, 2, 4, 4, 8, 16, 32]
    assert hei.ladder_keyswitches(128, K) == jhei.ladder_keyswitches(128, K)
    sub = hei.mlp_sub_context(keys.CkksContext.create(n=256, num_primes=5), 2)
    assert sub.num_primes == 3 and sub.ntt == keys.CkksContext.create(n=256, num_primes=5).ntt.slice_limbs(0, 3)


@pytest.mark.slow
def test_bsgs_mlp_scorer_bitwise_vs_jax():
    # The depth-2 MLP (d=16, H=4, K=3) at n=512, L=5, the geometry of
    # tests/test_hoisted.py: layer-1 BSGS, square with relinearization, two
    # rescales, layer-2 BSGS; bitwise vs the JAX scorer and within 0.05 of
    # the plaintext circuit. Slow tier: the JAX side compiles the whole
    # chain and generates keys per Galois element (minutes on one core).
    jctx = jkeys.CkksContext.create(n=512, num_primes=5)
    tctx = keys.CkksContext.create(n=512, num_primes=5)
    jsk, jpk = jkeys.keygen(jctx, jax.random.key(120))
    sk, _ = keys_from_jax(jsk, jpk)
    jrlk = jkeys.gen_relin_key(jctx, jsk, jax.random.key(121))
    rng = np.random.default_rng(122)
    d, hidden, num_classes = 16, 4, 3
    x = rng.normal(0, 0.4, d)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (num_classes, hidden)), rng.normal(0, 0.2, num_classes)
    plan1, plan2 = jhei.bsgs_mlp_plans(256, d, hidden, num_classes)
    jsub = jhei.mlp_sub_context(jctx, 2)
    jsub_sk = jhei.slice_secret_key(jsk, jsub.num_primes)
    jg1 = jhei.gen_rotation_keys_for_steps(jctx, jsk, jax.random.key(123), plan1.rotation_steps_needed)
    jg2 = jhei.gen_rotation_keys_for_steps(jsub, jsub_sk, jax.random.key(124), plan2.rotation_steps_needed)
    jct = jhei.encrypt_features(jctx, jpk, x, jax.random.key(125))
    jscorer = jhei.BsgsMlpScorer(jctx, w1, b1, w2, b2, jg1, jrlk, jg2)
    scorer = hei.BsgsMlpScorer(tctx, w1, b1, w2, b2, galois_keys_from_jax(jg1),
                               relin_key_from_jax(jrlk), galois_keys_from_jax(jg2), device="cpu")
    assert [dataclasses.astuple(p) for p in (scorer.plan1, scorer.plan2)] == [
        dataclasses.astuple(p) for p in (plan1, plan2)]
    assert scorer.num_keyswitches == jscorer.num_keyswitches
    out = scorer.score(ciphertext_from_jax(jct))
    _same(out, jscorer.score(jct))
    got = hei.decrypt_class_scores(scorer.sub_ctx, hei.slice_secret_key(sk, 3), out, num_classes)
    want = ((x @ w1.T + b1) ** 2) @ w2.T + b2
    np.testing.assert_allclose(got, want, atol=0.05)
    assert np.argmax(got) == np.argmax(want)


def test_bsgs_mlp_scorer_port_modes_agree():
    # The port's MLP alone (its own keys, n=512, L=5): hoisted and
    # unhoisted bitwise equal, the scores within 0.05 of the circuit.
    ctx = keys.CkksContext.create(n=512, num_primes=5)
    gen = torch.Generator().manual_seed(130)
    sk, pk = keys.keygen(ctx, gen, device="cpu")
    rlk = keys.gen_relin_key(ctx, sk, gen)
    rng = np.random.default_rng(131)
    d, hidden, num_classes = 16, 4, 3
    x = rng.normal(0, 0.4, d)
    w1, b1 = rng.normal(0, 0.3, (hidden, d)), rng.normal(0, 0.2, hidden)
    w2, b2 = rng.normal(0, 0.3, (num_classes, hidden)), rng.normal(0, 0.2, num_classes)
    plan1, plan2 = hei.bsgs_mlp_plans(256, d, hidden, num_classes)
    sub = hei.mlp_sub_context(ctx, 2)
    sub_sk = hei.slice_secret_key(sk, sub.num_primes)
    g1 = hei.gen_rotation_keys_for_steps(ctx, sk, 132, plan1.rotation_steps_needed)
    g2 = hei.gen_rotation_keys_for_steps(sub, sub_sk, 133, plan2.rotation_steps_needed)
    ct = hei.encrypt_features(ctx, pk, x, gen)
    outs = [hei.BsgsMlpScorer(ctx, w1, b1, w2, b2, g1, rlk, g2, rotation_mode=m,
                              device="cpu").score(ct) for m in ("hoisted", "unhoisted")]
    assert torch.equal(outs[0].c0, outs[1].c0) and torch.equal(outs[0].c1, outs[1].c1)
    got = hei.decrypt_class_scores(sub, sub_sk, outs[0], num_classes)
    np.testing.assert_allclose(got, ((x @ w1.T + b1) ** 2) @ w2.T + b2, atol=0.05)
