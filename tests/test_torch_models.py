"""The port's models, layout conversion and packing held against the JAX package.

Packing is compared BITWISE (it only moves float32 words). Logits are
compared within a bf16 tolerance: both packages compute in bfloat16 with
float32 parameters, but XLA and oneDNN accumulate the convolutions in
different orders and round at different points, so the last bf16 bits of
intermediate activations differ.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.ckks.packing import pack_pytree
from hefl_tpu.models import count_params as jcount_params
from hefl_tpu.models import create_model as jcreate_model

from hefl_tpu_torch import convert
from hefl_tpu_torch.ckks.packing import PackSpec, pack_params, unpack_blocks
from hefl_tpu_torch.models import MedCNN, SmallCNN, count_params, create_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def medcnn_jax():
    module, params = jcreate_model("medcnn", rng=jax.random.key(3))
    return module, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def smallcnn_jax():
    module, params = jcreate_model("smallcnn", rng=jax.random.key(4))
    return module, jax.tree_util.tree_map(np.asarray, params)


def _load(model_cls, jparams, **kw):
    model = model_cls(**kw)
    model.load_state_dict(convert.from_flax(jparams))
    return model


def test_pack_params_bitwise_full_medcnn(medcnn_jax):
    # Bitwise: same words in the same ravel order and layout, 55 rows.
    _, jparams = medcnn_jax
    params = convert.from_flax(jparams)
    spec = PackSpec.for_params(params, 4096)
    assert spec.total == jcount_params(jparams) == 222_722 and spec.n_ct == 55
    got = pack_params(params, 4096)
    want = np.asarray(pack_pytree(jparams, 4096))
    assert got.shape == (55, 4096)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    back = unpack_blocks(got, spec)
    assert back.keys() == params.keys()
    for k in params:
        assert torch.equal(back[k], params[k])


def test_convert_round_trips_exactly(medcnn_jax):
    _, jparams = medcnn_jax
    params = convert.from_flax(jparams)
    again = convert.to_flax(params)
    assert sorted(again) == sorted(jparams)
    for layer, leaves in jparams.items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(again[layer][leaf], arr)
    model = _load(MedCNN, jparams)
    assert count_params(model) == 222_722
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in params.items()
    }


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _assert_logits_close(got, want, tol):
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def test_medcnn_logits_match_flax(medcnn_jax):
    # Tolerance 3e-2 of the logit scale: six bf16 conv stages with 8-bit
    # mantissas (relative step 2**-8 ~ 4e-3 per rounding) compound across
    # layers where the two backends round differently.
    module, jparams = medcnn_jax
    x = _images((2, 256, 256, 3), 5)
    want = np.asarray(module.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(MedCNN, jparams)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 2)
    _assert_logits_close(got, want, 3e-2)


def test_smallcnn_logits_match_flax(smallcnn_jax):
    # Tolerance 2e-2 of the logit scale: two bf16 conv stages and two dense
    # layers (see test_medcnn_logits_match_flax).
    module, jparams = smallcnn_jax
    x = _images((8, 28, 28, 1), 6)
    want = np.asarray(module.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(SmallCNN, jparams)(torch.from_numpy(x)).numpy()
    _assert_logits_close(got, want, 2e-2)
    np.testing.assert_array_equal(got.argmax(-1)[np.abs(np.diff(np.sort(want, -1)[:, -2:], axis=-1))[:, 0] > 0.1],
                                  want.argmax(-1)[np.abs(np.diff(np.sort(want, -1)[:, -2:], axis=-1))[:, 0] > 0.1])


def test_flatten_is_nhwc_order(smallcnn_jax):
    # The most likely silent mismatch: a CHW flatten would scramble Dense_0's
    # rows. Zero every conv bias and all but one Dense_0 input row, and the
    # logits must still agree with flax (tolerance as for SmallCNN).
    module, jparams = smallcnn_jax
    jp = jax.tree_util.tree_map(np.array, jparams)
    keep = np.zeros(jp["Dense_0"]["kernel"].shape[0], bool)
    keep[37] = True                                  # an off-channel-0 position
    jp["Dense_0"]["kernel"] = np.where(keep[:, None], jp["Dense_0"]["kernel"] * 50, 0.0)
    x = _images((4, 28, 28, 1), 7)
    want = np.asarray(module.apply({"params": jp}, jnp.asarray(x)))
    with torch.no_grad():
        got = _load(SmallCNN, jp)(torch.from_numpy(x)).numpy()
    _assert_logits_close(got, want, 2e-2)


def test_create_model_matches_flax_initialization():
    # flax init: LeCun-normal truncated at 2 std (rescaled to unit variance),
    # zero biases. Std within 5% (over >= 4608 draws per conv/dense kernel
    # checked), and every draw inside the truncation bound.
    model = create_model("medcnn", device="cpu", gen=torch.Generator().manual_seed(8))
    jmodule, jparams = jcreate_model("medcnn", rng=jax.random.key(8))
    assert count_params(model) == jcount_params(jparams)
    for name, t in model.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(t) == 0
            continue
        fan_in = t[0].numel()
        std = (1.0 / fan_in) ** 0.5
        if t.numel() >= 4608:
            assert abs(t.std().item() / std - 1) < 0.05, name
        assert t.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
