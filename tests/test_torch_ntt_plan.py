"""K1/K2's host-side plan and the kernels' C interface, checked on the CPU.

`cuda_ntt.ntt_plan` picks the thread-block cluster size over which K1 and K2
split each row; the C launchers in `csrc/ntt.cu` are called through ctypes
with `cuda_ntt._SIGNATURES`, which no compiler checks here, so the argument
counts are read from the source.
"""

import re

import numpy as np
import pytest
import torch

from hefl_tpu_torch.ckks import cuda_ntt, ntt
from hefl_tpu_torch.ckks.primes import find_ntt_primes


def _extern_c_signatures() -> dict:
    """{name: argument count} of every function defined in ntt.cu's
    `extern "C"` block."""
    src = cuda_ntt.SOURCE.read_text()
    block = src[src.index('extern "C" {'):]
    return {name: len([a for a in args.split(",") if a.strip()])
            for name, args in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block, re.M)}


@pytest.mark.parametrize("n", cuda_ntt.SUPPORTED_N)
def test_ntt_plan_spreads_few_rows_over_clusters(n):
    # The largest C in (1, 2, 4, 8) with rows * C <= 132 SMs: the main
    # paths' 3-, 6-, 18- and 54-row launches get 24 to 108 blocks. Below
    # N = 1024 a row is one block (N/8 threads, one warp at N = 256), and at
    # N = 16384 never fewer than two (one block would need 2048 threads).
    plan = {rows: cuda_ntt.ntt_plan(rows, n) for rows in (1, 3, 6, 18, 54, 66, 1000)}
    if n < 1024:
        assert set(plan.values()) == {1}
    else:
        assert plan == {1: 8, 3: 8, 6: 8, 18: 4, 54: 2, 66: cuda_ntt.MIN_CLUSTER.get(n, 1),
                        1000: cuda_ntt.MIN_CLUSTER.get(n, 1)}
    assert all(n // c // 8 <= 1024 for c in plan.values())      # threads a block


def test_ntt_plan_is_one_block_a_row_from_66_rows():
    for rows in (66, 67, 132, 165, 330, 10_000):
        assert cuda_ntt.ntt_plan(rows, 4096) == 1
    assert cuda_ntt.ntt_plan(65, 4096) == 2
    assert max(cuda_ntt.ntt_plan(r, 8192) for r in range(1, 400)) == 8
    assert all(r * cuda_ntt.ntt_plan(r, 1024) <= 132 for r in range(1, 66))


def test_ntt_plan_follows_the_sm_count():
    assert cuda_ntt.ntt_plan(3, 4096, sms=16) == 4
    assert cuda_ntt.ntt_plan(8, 4096, sms=16) == 1
    assert cuda_ntt.ntt_plan(1, 4096, sms=1000) == 8


def test_ntt_plan_refuses_unsupported_rings():
    # Every power of two from 256 to 16384 is taken; anything else is not.
    assert cuda_ntt.SUPPORTED_N == tuple(1 << k for k in range(8, 15))
    for n in (128, 1000, 32768):
        with pytest.raises(ValueError, match=f"not {n}"):
            cuda_ntt.ntt_plan(3, n)


def test_every_signature_has_a_c_launcher():
    assert set(_extern_c_signatures()) == set(cuda_ntt._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_ntt._SIGNATURES))
def test_signature_matches_the_c_launcher(name):
    # A launcher that gained an argument (K1/K2's cluster size) without its
    # ctypes signature would read garbage for its stream.
    assert _extern_c_signatures()[name] == len(cuda_ntt._SIGNATURES[name])


def test_cpu_ntt_takes_the_plain_versions_and_counts_no_rows():
    ctx = ntt.NTTContext.build(find_ntt_primes(3, 27, 2048), 1024)
    rng = np.random.default_rng(3)
    p = np.asarray(ctx.p).astype(np.int64)
    x = torch.from_numpy((rng.integers(0, 2**40, (6, 3, 1024)) % p).astype(np.int32))
    cuda_ntt.reset_launch_counts()
    assert torch.equal(cuda_ntt.ntt_forward(ctx, x), ntt.ntt_forward_plain(ctx, x))
    assert torch.equal(cuda_ntt.ntt_inverse(ctx, x), ntt.ntt_inverse_plain(ctx, x))
    assert cuda_ntt.launch_rows() == {} and cuda_ntt.LAUNCH_ROWS == {}
    assert cuda_ntt.launch_counts() == dict.fromkeys(cuda_ntt.LAUNCHES, 0)


def test_reset_clears_launch_rows():
    cuda_ntt.LAUNCH_ROWS[("ntt_forward", 3, 4096)] = 2
    snapshot = cuda_ntt.launch_rows()
    cuda_ntt.reset_launch_counts()
    assert snapshot == {("ntt_forward", 3, 4096): 2}
    assert cuda_ntt.launch_rows() == {}
