"""ResNet-20 and nested parameter trees, held against the JAX package.

The JAX module's parameters are made from its `jax.eval_shape` tree and
numpy draws (a full flax init of the network costs tens of seconds on the
CPU), carried across by `convert`, and both forwards run on the same
numpy-made images. A small configuration (one block a stage, widths 8, 16,
16, 16x16x3 input) keeps the JAX side fast and still has what the full
network has: a stride-2 block with a projection shortcut where the width
changes (8 -> 16) and one where only the stride does (16 -> 16). The full
ResNet-20 is checked in torch alone (parameter count, flax names, ciphertext
count), its JAX tree only through `jax.eval_shape`.

Nested trees (ResNet's `BasicBlock_i/Conv_j`, GroupNorm's `scale`, convs
without bias) convert, pack and save bitwise as the JAX package does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks import encoding as jenc
from hefl_tpu.ckks import ntt as jntt
from hefl_tpu.ckks.packing import PackSpec as JPackSpec
from hefl_tpu.ckks.packing import pack_pytree
from hefl_tpu.models import ResNet20 as JResNet20
from hefl_tpu.utils import checkpoint as jck

from hefl_tpu_torch import convert
from hefl_tpu_torch.ckks import encoding, ntt
from hefl_tpu_torch.ckks.packing import PackSpec, flat_params, pack_params, unpack_blocks
from hefl_tpu_torch.ckks.primes import find_ntt_primes
from hefl_tpu_torch.models import ResNet20, count_params, create_model
from hefl_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1, 1), widths=(8, 16, 16))
HW = (16, 16, 3)


def _jax_params(module, shape, seed):
    """Random flax params of `module` at input `shape`: the eval_shape tree
    filled with numpy draws (GroupNorm scales around 1)."""
    tree = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1,) + shape))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if str(path[-1].key) == "scale" else 0.0
        return (base + rng.normal(0, 0.3, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def small():
    module = JResNet20(**SMALL)
    params = _jax_params(module, HW, 1)
    model = ResNet20(**SMALL, input_shape=HW)
    model.load_state_dict(convert.from_flax(params))
    return module, params, model


def test_small_resnet_forward_matches_jax(small):
    # Tolerance 2e-2 absolute on logits of magnitude ~1: the same bf16
    # convolutions, f32 GroupNorms and bf16 head, where one bf16 rounding
    # (2**-8 relative) may land differently when the two libraries
    # accumulate a conv in another order. (On this CPU they agree bitwise.)
    module, params, model = small
    x = np.random.default_rng(2).random((2,) + HW, dtype=np.float32)
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    projections = [i for i, b in enumerate(model.blocks()) if b.projects]
    assert projections == [1, 2] and [b.stride for b in model.blocks()] == [1, 2, 2]


def test_small_resnet_folded_apply_matches_jax_folded_apply(small):
    # The client-folded forwards of the two packages on three clients'
    # distinct weights: the JAX tap-GEMM convs against the port's grouped
    # convs, the same tolerance as the per-client forward.
    module, params, model = small
    c, b = 3, 2
    stacked = jax.tree_util.tree_map(
        lambda a: np.stack([a * (1 + 0.05 * i) for i in range(c)]), params)
    x = np.random.default_rng(3).random((c * b,) + HW, dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, xx: module.folded_apply(p, xx, num_clients=c))(
        stacked, jnp.asarray(x)))
    port_stacked = {k: torch.stack([v * (1 + 0.05 * i) for i in range(c)])
                    for k, v in convert.from_flax(params).items()}
    got = model.folded_apply(port_stacked, torch.from_numpy(x), c).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_full_resnet20_names_count_and_ciphertexts():
    # 272,474 parameters under flax's scope names (the JAX module's tree by
    # eval_shape, nothing computed), 67 ciphertexts at N = 4096.
    model = create_model("resnet20", device="cpu")
    params = {k: v.detach() for k, v in model.named_parameters()}
    assert count_params(model) == 272_474
    jtree = jax.eval_shape(JResNet20().init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    want = {("/".join(str(k.key) for k in path[:-1]), str(path[-1].key)): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    got = {(layer, leaf): tuple(convert.flax_leaf(layer, leaf, params[convert.torch_name(
        layer, leaf)]).shape) for layer, leaf in convert.ravel_order(params)}
    assert got == want
    assert list(got) == list(want)          # ravel order: keys sorted at every level
    assert PackSpec.for_params(params, 4096).n_ct == 67
    assert "BasicBlock_8.GroupNorm_1.weight" in params and "Conv_0.bias" not in params


def test_resnet_init_is_flax_init():
    # LeCun-normal kernels (std 1/sqrt(fan_in), truncated at 2 std), GroupNorm
    # scale 1 and bias 0, zero Dense bias.
    model = create_model("resnet20", device="cpu", gen=torch.Generator().manual_seed(4))
    p = dict(model.named_parameters())
    for name, t in p.items():
        if "GroupNorm" in name:
            assert torch.equal(t, torch.ones_like(t) if name.endswith("weight") else
                               torch.zeros_like(t)), name
    assert torch.equal(p["Dense_0.bias"], torch.zeros(10))
    w = p["BasicBlock_8.Conv_1.weight"]
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / fan_in ** 0.5 / 0.87962566103423978 + 1e-6


def test_nested_tree_roundtrips_bitwise(small):
    _, params, _ = small
    back = convert.to_flax(convert.from_flax(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_nested_tree_packs_and_encodes_as_jax(small):
    # The flat ravel order, the coefficient blocks and the encoded residues
    # are the JAX package's, word for word; unpacking inverts packing.
    _, params, _ = small
    tparams = convert.from_flax(params)
    np.testing.assert_array_equal(pack_params(tparams, 256).numpy(),
                                  np.asarray(pack_pytree(params, 256)))
    spec, jspec = PackSpec.for_params(tparams, 256), JPackSpec.for_params(params, 256)
    assert (spec.total, spec.n_ct) == (jspec.total, jspec.n_ct)
    back = unpack_blocks(pack_params(tparams, 256), spec)
    assert all(torch.equal(back[k], tparams[k]) for k in tparams)
    primes = find_ntt_primes(3, 27, 512)
    tctx, jctx = ntt.NTTContext.build(primes, 256), jntt.NTTContext.build(primes, 256)
    blocks = pack_params(tparams, 256)
    got = encoding.encode(tctx, blocks, 2.0**20).numpy().view(np.uint32)
    want = np.asarray(jenc.encode(jctx, jnp.asarray(blocks.numpy()), 2.0**20))
    np.testing.assert_array_equal(got, want)
    assert flat_params(tparams).numel() == spec.total


def test_nested_params_files_load_both_ways_bitwise(tmp_path, small):
    _, params, _ = small
    tparams = convert.from_flax(params)
    jck.save_params(str(tmp_path / "j.npz"), params)
    template = {k: torch.zeros_like(v) for k, v in tparams.items()}
    loaded = checkpoint.load_params(str(tmp_path / "j.npz"), template)
    assert all(torch.equal(loaded[k], tparams[k]) for k in tparams)
    checkpoint.save_params(str(tmp_path / "t.npz"), tparams)
    jloaded = jck.load_params(str(tmp_path / "t.npz"), params)
    for a, b in zip(jax.tree_util.tree_leaves(jloaded), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert set(jz.files) == set(tz.files)
        assert "param:BasicBlock_1/GroupNorm_2/scale" in tz.files
        for k in jz.files:
            np.testing.assert_array_equal(jz[k], tz[k])
