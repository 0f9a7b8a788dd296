"""The port's DP-FedAvg (`hefl_tpu_torch.fl.dp`) against the JAX package's.

The accountant is plain Python `math` in both packages: `epsilon_spent` is
held exactly over rounds, sigma, delta and sample rate. The float pieces on
the same trees: `global_l2_norm` and `clip_by_global_norm` within 1e-6
relative (the two sum in different orders), `dp_sanitize`'s deterministic
core fed the JAX package's own noise draws (`jax.random.split(key,
n_leaves)`, one key a leaf in tree order) within 1e-6 absolute. The port's
own sampler (torch generators) cannot reproduce jax.random; it is held by
its moments over >= 10^5 coordinates: the noise's standard deviation within
2 % of the share sigma*C/sqrt(K), its mean within 4 standard errors of 0.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.fl import dp as jdp

from hefl_tpu_torch import convert
from hefl_tpu_torch.fl import dp

torch.set_num_threads(2)


@pytest.mark.parametrize("sample_rate", [1.0, 0.75, 0.25, 0.01, 0.0])
@pytest.mark.parametrize("sigma", [0.3, 1.0, 4.0])
def test_epsilon_spent_equals_jax_exactly(sigma, sample_rate):
    for rounds in (0, 1, 3, 50):
        for delta in (1e-5, 1e-3):
            got = dp.epsilon_spent(rounds, sigma, delta, sample_rate=sample_rate)
            want = jdp.epsilon_spent(rounds, sigma, delta, sample_rate=sample_rate)
            assert got == want, (rounds, delta)


def test_accountant_edges_equal_jax():
    assert dp.epsilon_spent(3, 0.0) == jdp.epsilon_spent(3, 0.0) == float("inf")
    for a in (2, 5, 32):
        assert dp._subsampled_gaussian_rdp(0.1, 1.3, a) == jdp._subsampled_gaussian_rdp(
            0.1, 1.3, a)
    with pytest.raises(ValueError, match="sample_rate"):
        dp.epsilon_spent(1, 1.0, sample_rate=1.5)


@pytest.mark.parametrize("floor,clients", [(0, 8), (6, 8), (12, 8), (1, 1)])
def test_calibration_clients_and_config_equal_jax(floor, clients):
    tcfg, jcfg = dp.DpConfig(min_surviving=floor), jdp.DpConfig(min_surviving=floor)
    assert dp.calibration_clients(tcfg, clients) == jdp.calibration_clients(jcfg, clients)
    with pytest.raises(ValueError) as terr:
        dp.DpConfig(min_surviving=-1)
    with pytest.raises(ValueError) as jerr:
        jdp.DpConfig(min_surviving=-1)
    assert str(terr.value) == str(jerr.value)


SHAPES = {"Conv_0": {"bias": (8,), "kernel": (3, 3, 1, 8)},
          "Dense_0": {"bias": (10,), "kernel": (200, 10)},
          "Dense_1": {"bias": (3,), "kernel": (10, 3)}}


def _tree(rng, scale):
    return {layer: {leaf: rng.normal(0, scale, shape).astype(np.float32)
                    for leaf, shape in leaves.items()} for layer, leaves in SHAPES.items()}


@pytest.mark.parametrize("delta_scale", [0.001, 0.01, 1.0])
def test_norm_and_clip_match_jax(delta_scale):
    rng = np.random.default_rng(2)
    tree = _tree(rng, delta_scale)
    jclipped, jnorm = jdp.clip_by_global_norm(tree, 1.0)
    clipped, norm = dp.clip_by_global_norm(convert.from_flax(tree), 1.0)
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert abs(float(dp.global_l2_norm(convert.from_flax(tree))) - float(jnorm)) <= 1e-6 * float(
        jnorm)
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, jclipped))
    for k in want:
        scale = max(float(want[k].abs().max()), 1e-30)
        assert float((clipped[k] - want[k]).abs().max()) <= 1e-6 * scale, k
    assert (float(norm) > 1.0) == (delta_scale == 1.0)   # clipped only when over the bound


@pytest.mark.parametrize("clients,sigma", [(8, 1.0), (6, 0.5), (1, 2.0)])
def test_dp_sanitize_core_on_jax_noise_matches_jax(clients, sigma):
    rng = np.random.default_rng(3)
    gp = _tree(rng, 0.2)
    trained = jax.tree_util.tree_map(lambda g: (g + rng.normal(0, 0.05, g.shape)).astype(
        np.float32), gp)
    cfg_kw = dict(clip_norm=0.5, noise_multiplier=sigma, delta=1e-5)
    key = jax.random.key(11)
    want, jnorm = jdp.dp_sanitize(key, gp, trained, jdp.DpConfig(**cfg_kw), clients)
    leaves, treedef = jax.tree_util.tree_flatten(trained)
    keys = jax.random.split(key, len(leaves))
    noise = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.normal(k, x.shape, jnp.float32)) for x, k in zip(leaves, keys)])
    got, norm = dp.dp_sanitize_core(convert.from_flax(gp), convert.from_flax(trained),
                                    dp.DpConfig(**cfg_kw), clients, convert.from_flax(noise))
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
    want = convert.from_flax(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert float((got[k] - want[k]).abs().max()) <= 1e-6, k


def test_port_sampler_moments():
    # 2 x 100,000 coordinates of pure noise (trained == global: a zero
    # delta), share sigma*C/sqrt(K) = 1.5 * 2 / sqrt(4).
    gp = {"a.weight": torch.zeros(100_000), "b.weight": torch.full((50, 2_000), 0.25)}
    cfg = dp.DpConfig(clip_norm=2.0, noise_multiplier=1.5)
    gen = torch.Generator().manual_seed(5)
    out, norm = dp.dp_sanitize(gen, gp, gp, cfg, 4)
    assert float(norm) == 0.0
    noise = torch.cat([(out[k] - gp[k]).flatten() for k in gp]).to(torch.float64)
    share = 1.5 * 2.0 / math.sqrt(4)
    std = float(noise.std())
    assert abs(std - share) <= 0.02 * share
    assert abs(float(noise.mean())) <= 4 * share / math.sqrt(noise.numel())
    # Leaf by leaf in the packing order: the same generator state draws the
    # same noise, and another seed other noise.
    again, _ = dp.dp_sanitize(torch.Generator().manual_seed(5), gp, gp, cfg, 4)
    assert all(torch.equal(again[k], out[k]) for k in gp)
    other, _ = dp.dp_sanitize(torch.Generator().manual_seed(6), gp, gp, cfg, 4)
    assert not torch.equal(other["a.weight"], out["a.weight"])


def test_noise_is_added_in_float32_then_cast():
    # A bf16 leaf keeps its dtype: the share is added to the clipped delta
    # in float32 and the SUM cast back (JAX's order), so a share of 0.006
    # on a zero delta survives as bf16(0.006) instead of being quantized
    # with the leaf first.
    gp = {"w.weight": torch.ones(4096, dtype=torch.bfloat16)}
    noise = {"w.weight": torch.full((4096,), 1.0)}
    cfg = dp.DpConfig(clip_norm=1.0, noise_multiplier=0.006)
    got, _ = dp.dp_sanitize_core(gp, gp, cfg, 1, noise)
    assert got["w.weight"].dtype == torch.bfloat16
    want = gp["w.weight"] + torch.full((4096,), np.float32(0.006)).to(torch.bfloat16)
    assert torch.equal(got["w.weight"], want)
