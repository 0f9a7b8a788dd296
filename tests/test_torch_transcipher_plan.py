"""K7 on the NTT routine: an exact emulation of its index maps.

The fused transcipher (K7) is `ntt_kernel` in csrc/ntt.cu under the
TranscipherRows load policy and the TranscipherStore store policy. The CUDA
kernel cannot run here, so `_emulate_transcipher` replays, in int64 with the
plain versions' modular helpers, every index it computes: TranscipherRows
(row r = b*L + l reads upload row b = r / L of the words and the prime's
Barrett and Montgomery constants, and embeds the word pair at the first
pass's indices), the forward passes (`_emulate_forward` of
tests/test_torch_encdec_plan.py: the cross-block first pass and its scatter,
the in-block passes, the last pass) and TranscipherStore's epilogue
(c0 = NTT(m) - pad0 and c1 = -pad1 on 8 consecutive words). Held bitwise
against `transcipher_fused_plain` at every cluster size and against the JAX
package's XLA transcipher, an index slip shows here before the kernel runs
on a card. The wrapper's host side (cluster size, argument order, the
refusal of unaligned pad rows) is checked with the launch stubbed out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hefl_tpu.ckks import ntt as jntt
from hefl_tpu.hhe import transcipher as jtc

from hefl_tpu_torch.ckks import cuda_ntt
from hefl_tpu_torch.ckks.modular import add_mod, barrett_mod, mont_mul, sub_mod
from hefl_tpu_torch.ckks.primes import find_ntt_primes

from test_torch_encdec_plan import UNSET, WORDS, _ctx, _emulate_forward, _res

torch.set_num_threads(2)


def _k7_inputs(ctx, batch, seed):
    """Word pairs int32[batch, N] below 2**31 (the extremes included) and
    pad residues [batch, L, N], some pad_c1 words zero."""
    rng = np.random.default_rng(seed)
    words = []
    for _ in range(2):
        w = rng.integers(0, 2**31, (batch, ctx.n))
        w[0, :4] = (0, 1, 2**31 - 1, int(ctx.p[0, 0]))
        words.append(torch.from_numpy(w.astype(np.int32)))
    shape = (batch, ctx.num_primes, ctx.n)
    pad0, pad1 = _res(ctx, shape, seed + 1), _res(ctx, shape, seed + 2)
    pad1[0, :, 8:13] = 0
    return (*words, pad0, pad1)


def _emulate_transcipher(ctx, w_hi, w_lo, pad_c0, pad_c1, cluster):
    """K7: TranscipherRows -> one forward transform -> TranscipherStore.
    Words int32 [B, N], pads int32 [B, L, N] -> int32 (c0, c1) [B, L, N]."""
    n, num_l = ctx.n, ctx.num_primes
    rows = pad_c0.numel() // n
    tabs = cuda_ntt.plain_tables(ctx, "cpu")
    mu, sh31 = (c.to(torch.int64) for c in cuda_ntt._transcipher_consts(ctx, "cpu"))
    # TranscipherRows.row(r): upload row r / L, the constants of prime r % L.
    r = torch.arange(rows)
    l_row, b_row = r % num_l, r // num_l
    hi, lo = (w.reshape(-1, n).to(torch.int64)[b_row] for w in (w_hi, w_lo))
    p, m, s, pinv = (t[l_row][:, None] for t in (tabs.p[:, 0], mu, sh31, tabs.pinv_neg[:, 0]))
    loads = add_mod(mont_mul(barrett_mod(hi, p, m), s, p, pinv), barrett_mod(lo, p, m), p)
    v, _, _, p = _emulate_forward(ctx, loads[:, None], cluster)
    # TranscipherStore on words 8M..8M+7 of row r: c0 = M - pad0, c1 = -pad1.
    x = WORDS * torch.arange(n // WORDS)[:, None] + torch.arange(WORDS)         # [N/8, 8]
    pe = p[:, :, None]
    z0, z1 = (t.reshape(rows, n).to(torch.int64)[:, x] for t in (pad_c0, pad_c1))
    outs = []
    for vals in (sub_mod(v[:, 0], z0, pe), torch.where(z1 == 0, 0, pe - z1)):
        out = torch.full((rows, n), UNSET, dtype=torch.int64)
        out[:, x] = vals
        assert bool((out != UNSET).all())
        outs.append(out.reshape(pad_c0.shape).to(torch.int32))
    return tuple(outs)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2048, 4096])
def test_emulated_k7_bitwise_at_every_cluster_size(n, cluster):
    # N = 2048: a short pass of 2 stages; 4096: none. Two upload rows of
    # 3 primes: 6 rows, each upload row's words read by 3 of them.
    ctx = _ctx(n, 3)
    args = _k7_inputs(ctx, 2, n + cluster)
    got = _emulate_transcipher(ctx, *args, cluster)
    want = cuda_ntt.transcipher_fused_plain(ctx, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.all(got[1][0, :, 8:13] == 0)


@pytest.mark.parametrize("n,cluster", [(256, 1), (512, 1), (16384, 2), (16384, 8)])
def test_emulated_k7_bitwise_at_the_smallest_and_largest_rings(n, cluster):
    # The clusters ntt_plan gives these rings: one block a row below 1024,
    # at least two at 16384.
    ctx = _ctx(n, 3)
    args = _k7_inputs(ctx, 2, 3 * n + cluster)
    for g, w in zip(_emulate_transcipher(ctx, *args, cluster),
                    cuda_ntt.transcipher_fused_plain(ctx, *args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cluster", [1, 8])
def test_emulated_k7_bitwise_vs_jax(cluster):
    # The slice's kernel at N = 1024 (the short pass of 1 stage) against the
    # JAX package's XLA transcipher on the same numpy-made inputs.
    ctx = _ctx(1024, 3)
    jctx = jntt.NTTContext.build(find_ntt_primes(3, 27, 2048), 1024)
    args = _k7_inputs(ctx, 3, 90 + cluster)
    j = [jnp.asarray(t.numpy().view(np.uint32)) for t in args]
    want = jtc._transcipher_core_xla(jctx, *j)
    got = _emulate_transcipher(ctx, *args, cluster)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


@pytest.mark.parametrize("rows,n,cluster", [
    (456, 4096, 1),     # the HHE round: 8 clients x 19 packed rows x 3 primes
    (57, 4096, 2),      # one client's 19 packed rows
    (18, 8192, 4),
    (3, 4096, 8),       # one packed row
    (7056, 256, 1),     # hhe-smoke: 8 clients x 294 packed rows at N = 256
])
def test_transcipher_follows_ntt_plan(rows, n, cluster):
    # K7 launches at ntt_plan(B*L, N), as K1-K4 do.
    assert cuda_ntt.ntt_plan(rows, n) == cluster


def _stub_launch(monkeypatch):
    """Route the wrapper past its CPU dispatch to a recorder of the
    launcher's arguments (no kernel runs)."""
    calls = []
    monkeypatch.setattr(cuda_ntt, "_is_cpu", lambda *ts: False)
    monkeypatch.setattr(cuda_ntt, "_launch", lambda ctx, name, device, *args, rows, count=None:
                        calls.append((name, args, rows)))
    return calls


@pytest.mark.parametrize("batch,cluster", [(152, 1), (1, 8)])
def test_wrapper_passes_ntt_plan_to_the_launcher(monkeypatch, batch, cluster):
    # The C launcher's arguments in its order: 12 pointers, then rows = B*L,
    # L, log2 N and the cluster size; _launch appends the stream.
    ctx = _ctx(4096, 3)
    words = torch.zeros((batch, 4096), dtype=torch.int32)
    pads = torch.zeros((batch, 3, 4096), dtype=torch.int32)
    calls = _stub_launch(monkeypatch)
    c0, c1 = cuda_ntt.transcipher_fused(ctx, words, words, pads, pads)
    ((name, args, rows),) = calls
    assert name == "transcipher_fused" and rows == 3 * batch
    assert len(args) + 1 == len(cuda_ntt._SIGNATURES[name])
    assert args[-4:] == (3 * batch, 3, 12, cluster)
    assert tuple(c0.shape) == tuple(c1.shape) == (batch, 3, 4096)


@pytest.mark.parametrize("which", [0, 1])
def test_wrapper_refuses_unaligned_pads_before_launch(monkeypatch, which):
    # The epilogue loads the pad rows as 16-byte vectors: a pad view 4 bytes
    # off is refused, and nothing launches.
    ctx = _ctx(1024, 3)
    w_hi, w_lo, pad0, pad1 = _k7_inputs(ctx, 1, 7)
    bad = _res(ctx, (2, 3, 1024), 8).reshape(-1)[1:1 + 3 * 1024].reshape(1, 3, 1024)
    pads = [pad0, pad1]
    pads[which] = bad
    calls = _stub_launch(monkeypatch)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, *pads)
    assert calls == []


def test_cpu_transcipher_takes_the_plain_version_and_counts_nothing():
    # On CPU tensors the wrapper is the plain version, whatever the pads'
    # alignment, and no launch or launch row is counted.
    ctx = _ctx(1024, 3)
    w_hi, w_lo, pad0, _ = _k7_inputs(ctx, 1, 9)
    pad1 = _res(ctx, (2, 3, 1024), 10).reshape(-1)[1:1 + 3 * 1024].reshape(1, 3, 1024)
    cuda_ntt.reset_launch_counts()
    got = cuda_ntt.transcipher_fused(ctx, w_hi, w_lo, pad0, pad1)
    want = cuda_ntt.transcipher_fused_plain(ctx, w_hi, w_lo, pad0, pad1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)
    assert cuda_ntt.launch_rows() == {}
