"""The port's fault model (`hefl_tpu_torch.fl.faults`) against the JAX
package's.

The schedules are host numpy on the same PRNG streams, so they are held
bitwise over a grid of seeds, rounds, client counts, fractions and outages;
`FaultConfig`'s validation gives the same messages and
`max_scheduled_exclusions` the same values. The in-round halves (poison,
exclusion bits) run on the same stacked weight trees: the poisoned weights
bitwise (NaN where NaN), the bits exactly. Update norms sit far from the
bound, since the two packages sum a norm in different orders (the norms
themselves agree within 1e-6 relative).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hefl_tpu.fl import config as jconfig
from hefl_tpu.fl import dp as jdp
from hefl_tpu.fl import faults as jfaults
from hefl_tpu.parallel import host_of_clients as jhost_of_clients

from hefl_tpu_torch import convert
from hefl_tpu_torch.fl import dp, faults
from hefl_tpu_torch.fl.config import TrainConfig

torch.set_num_threads(2)

# Fault configurations (kwargs of FaultConfig) and the client counts each
# is drawn at: dropout, poison, stragglers, device loss, arrival faults,
# regional outages and DCN link faults.
CONFIGS = [
    dict(),
    dict(drop_fraction=0.25, nan_clients=1, fail_rounds=(2,)),
    dict(drop_fraction=0.5, nan_clients=2, huge_clients=1, straggler_fraction=0.25,
         straggler_delay_s=0.2, fail_rounds=(0, 3)),
    dict(drop_fraction=0.9, nan_clients=3, huge_clients=3),
    dict(straggler_fraction=1.0, straggler_delay_s=1.5, arrival_delay_s=0.7,
         duplicate_clients=2, transient_fail_clients=1, permanent_fail_clients=1),
    dict(drop_fraction=0.125, outage_hosts=1, num_hosts=4, nan_clients=1),
    dict(outage_hosts=2, num_hosts=3, huge_clients=1, arrival_delay_s=0.1),
    dict(num_hosts=4, link_loss_hosts=1, link_dark_hosts=1, link_delay_s=0.5,
         link_dup_hosts=1, drop_fraction=0.25),
]
CLIENTS = [4, 5, 8, 16]


def _arrays(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same(got, want):
    g, w = _arrays(got), _arrays(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("clients", CLIENTS)
@pytest.mark.parametrize("kw", CONFIGS, ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_schedules_bitwise_equal_jax(kw, clients):
    for seed in (0, 3, 17):
        tcfg = faults.FaultConfig(seed=seed, **kw)
        jcfg = jfaults.FaultConfig(seed=seed, **kw)
        for r in (0, 1, 2, 5):
            _assert_same(faults.schedule_for_round(tcfg, r, clients),
                         jfaults.schedule_for_round(jcfg, r, clients))
            _assert_same(faults.schedule_arrivals(tcfg, r, clients),
                         jfaults.schedule_arrivals(jcfg, r, clients))
            _assert_same(faults.schedule_links(tcfg, r), jfaults.schedule_links(jcfg, r))
            np.testing.assert_array_equal(
                faults.schedule_for_round(tcfg, r, clients).participation(),
                jfaults.schedule_for_round(jcfg, r, clients).participation())
        assert tcfg.max_scheduled_exclusions(clients) == jcfg.max_scheduled_exclusions(clients)


@pytest.mark.parametrize("clients,hosts", [(8, 1), (8, 3), (16, 4), (5, 5), (4, 8)])
def test_host_of_clients_equals_jax(clients, hosts):
    if hosts > clients:
        for fn in (faults.host_of_clients, jhost_of_clients):
            with pytest.raises(ValueError, match="empty host rows"):
                fn(clients, hosts)
        return
    np.testing.assert_array_equal(faults.host_of_clients(clients, hosts),
                                  jhost_of_clients(clients, hosts))


BAD = [
    dict(drop_fraction=-0.1),
    dict(nan_clients=-1),
    dict(link_delay_s=-1.0),
    dict(outage_hosts=1),
    dict(outage_hosts=3, num_hosts=3),
    dict(link_dup_hosts=1),
    dict(link_dark_hosts=2, num_hosts=2),
]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) + str(i) for i, k in enumerate(BAD)])
def test_fault_config_validation_messages_equal_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultConfig(**kw)
    with pytest.raises(ValueError) as terr:
        faults.FaultConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_round_meta_records_equal_jax():
    bits = np.array([0, 1, 2, 4, 8, 3, 0, 16, 128, 1024], np.int64)
    for t, j in ((faults.RoundMeta.from_bits(bits), jfaults.RoundMeta.from_bits(bits)),
                 (faults.RoundMeta.full_participation(6),
                  jfaults.RoundMeta.full_participation(6))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.record() == j.record()
    assert faults.EXCLUSION_CAUSES == jfaults.EXCLUSION_CAUSES
    assert (faults.POISON_NONE, faults.POISON_NAN, faults.POISON_HUGE) == (
        jfaults.POISON_NONE, jfaults.POISON_NAN, jfaults.POISON_HUGE)


# --- poison and the sanitizing predicates --------------------------------------------

SHAPES = {"Conv_0": {"bias": (4,), "kernel": (3, 3, 2, 4)},
          "Dense_0": {"bias": (10,), "kernel": (300, 10)}}
# Per client: (delta scale, poison code); 8 clients, the last scheduled out.
CLIENT_PLAN = [(0.01, 0), (0.5, 0), (0.01, 1), (0.01, 2), (0.02, 0), (0.3, 1), (0.01, 0),
               (0.01, 0)]
MASK = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.int32)


def _trees(seed: int = 5):
    """Global weights and 8 clients' trained weights (flax layout)."""
    rng = np.random.default_rng(seed)
    gp = {layer: {leaf: rng.normal(0, 0.2, shape).astype(np.float32)
                  for leaf, shape in leaves.items()} for layer, leaves in SHAPES.items()}
    clients = [jax.tree_util.tree_map(
        lambda g, s=s: (g + rng.normal(0, s, g.shape)).astype(np.float32), gp)
        for s, _ in CLIENT_PLAN]
    return gp, clients


def _norms(gp, clients):
    return [float(jdp.global_l2_norm(jax.tree_util.tree_map(lambda t, g: t - g, c, gp)))
            for c in clients]


@pytest.mark.parametrize("max_update_norm,on_overflow", [
    (0.0, "warn"), (5.0, "warn"), (0.0, "exclude"), (5.0, "exclude")])
def test_poison_and_exclusion_bits_equal_jax(max_update_norm, on_overflow):
    gp, clients = _trees()
    norms = _norms(gp, clients)
    # Clean clients' update norms are far from the bound on both sides of it.
    assert all(abs(n - 5.0) > 1.0 for n in norms)
    codes = np.array([c for _, c in CLIENT_PLAN], np.int32)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *clients)
    jpoisoned = jax.vmap(jfaults.poison_tree)(stacked, jnp.asarray(codes))
    overflow = np.array([0, 0, 0, 5, 0, 0, 3, 0], np.int32)
    jcfg = jconfig.TrainConfig(max_update_norm=max_update_norm, on_overflow=on_overflow)
    jbits = np.asarray(jfaults.exclusion_bits(jcfg, gp, jpoisoned, jnp.asarray(MASK),
                                              jnp.asarray(overflow)))

    tgp = convert.from_flax(gp)
    tpoisoned = [faults.poison_tree(convert.from_flax(c), int(code))
                 for c, code in zip(clients, codes)]
    for c, tp in enumerate(tpoisoned):
        want = convert.from_flax(jax.tree_util.tree_map(lambda a: np.asarray(a)[c], jpoisoned))
        for k in want:
            np.testing.assert_array_equal(tp[k].numpy(), want[k].numpy(), err_msg=k)
    cfg = TrainConfig(max_update_norm=max_update_norm, on_overflow=on_overflow)
    bits = faults.exclusion_bits(cfg, tgp, tpoisoned, MASK, torch.from_numpy(overflow))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), jbits)
    assert bits[7] & faults.EXCLUDED_SCHEDULED and bits[2] & faults.EXCLUDED_NONFINITE
    assert bool(bits[1] & faults.EXCLUDED_NORM) == (max_update_norm > 0)
    assert bool(bits[6] & faults.EXCLUDED_OVERFLOW) == (on_overflow == "exclude")
    # NaN clients are never also counted under the norm bound.
    assert not bits[2] & faults.EXCLUDED_NORM and not bits[5] & faults.EXCLUDED_NORM


def test_poison_none_is_bit_identical_and_codes_poison():
    _, clients = _trees()
    prm = convert.from_flax(clients[0])
    same = faults.poison_tree(prm, faults.POISON_NONE)
    assert all(torch.equal(same[k], prm[k]) for k in prm)
    assert all(torch.isnan(v).all() for v in faults.poison_tree(prm, faults.POISON_NAN).values())
    huge = faults.poison_tree(prm, torch.tensor(faults.POISON_HUGE))
    assert all(torch.equal(huge[k], prm[k] + torch.tensor(1e15, dtype=torch.float32))
               for k in prm)


def test_update_norms_agree_with_jax_within_1e6_relative():
    gp, clients = _trees()
    tgp = convert.from_flax(gp)
    for c, want in zip(clients, _norms(gp, clients)):
        tc = convert.from_flax(c)
        got = float(dp.global_l2_norm({k: tc[k] - tgp[k] for k in tc}))
        assert abs(got - want) <= 1e-6 * want
