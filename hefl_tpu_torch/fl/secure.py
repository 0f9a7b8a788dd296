"""Encrypted FedAvg on one device: train, encrypt, sum mod p, owner decrypt.

Counterpart of the synchronous float path of `hefl_tpu.fl.secure`. Each
client's trained weights are packed into [n_ct, N] coefficient blocks and
encoded, and the whole [C*n_ct, L, N] stack goes through ONE encrypt core
call (one fused-encrypt kernel launch on CUDA). The server's aggregation is
the ciphertext sum mod p over the client axis; the 1/C of FedAvg costs
nothing, since the owner's decode divides by scale * C.

Trust split: the round touches only the `PublicKey`; the `SecretKey`
appears only in `decrypt_average`, the model owner's step.
"""

from __future__ import annotations

import torch

from hefl_tpu_torch.ckks import encoding, ops
from hefl_tpu_torch.ckks.keys import CkksContext, PublicKey, SecretKey
from hefl_tpu_torch.ckks.ntt import plain_tables
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.ckks.packing import PackSpec, pack_params, unpack_blocks
from hefl_tpu_torch.fl.config import TrainConfig
from hefl_tpu_torch.fl.fedavg import train_clients


def encode_stack(ctx: CkksContext, p_out: list[dict]) -> torch.Tensor:
    """Per-client pack + encode -> coefficient residues int32[C, n_ct, L, N]."""
    return torch.stack([
        encoding.encode(ctx.ntt, pack_params(prm, ctx.n), ctx.scale) for prm in p_out
    ])


def encrypt_stack(
    ctx: CkksContext, pk: PublicKey, p_out: list[dict], enc_gens=None, samples=None
) -> Ciphertext:
    """Encrypt C clients' parameter dicts into one [C, n_ct, L, N] Ciphertext.

    Sampling is per client (`enc_gens[c]` draws client c's (u, e0, e1)), or
    `samples` = (u, e0, e1) int32[C, n_ct, L, N] are given (a test feeding
    the JAX package's samples). Then ONE encrypt core over the whole stack.
    """
    m_res = encode_stack(ctx, p_out)
    c, n_ct = int(m_res.shape[0]), int(m_res.shape[1])
    if samples is None:
        draws = [ops.encrypt_samples(ctx, g, (n_ct,), m_res.device) for g in enc_gens]
        samples = tuple(torch.stack([d[i] for d in draws]) for i in range(3))
    rows = (c * n_ct, ctx.num_primes, ctx.n)
    u, e0, e1 = (s.reshape(rows).contiguous() for s in samples)
    ct = ops.encrypt_core(ctx, pk, m_res.reshape(rows), u, e0, e1)
    shape = (c, n_ct, ctx.num_primes, ctx.n)
    return Ciphertext(c0=ct.c0.reshape(shape), c1=ct.c1.reshape(shape), scale=ct.scale)


def lazy_sum_mod(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum int32 residues over axis 0 mod p -> canonical int32.

    An int64 sum then one reduction: 2**36 summands below 2**27 fit int64,
    whereas 32 of them already overflow int32. Canonical output, so bitwise
    equal to the JAX package's chunked uint32 `_lazy_sum_mod`."""
    return torch.remainder(torch.sum(x.to(torch.int64), dim=0), p).to(torch.int32)


def aggregate_encrypted(ctx: CkksContext, cts: Ciphertext) -> Ciphertext:
    """Homomorphic sum of a [C, n_ct, L, N] ciphertext stack over clients."""
    p = plain_tables(ctx.ntt, cts.c0.device).p
    return Ciphertext(
        c0=lazy_sum_mod(cts.c0, p), c1=lazy_sum_mod(cts.c1, p), scale=cts.scale
    )


def _client_generators(gen: torch.Generator, count: int, device) -> list[torch.Generator]:
    seeds = torch.randint(0, 2**62, (count,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def secure_fedavg_round(
    model,
    cfg: TrainConfig,
    ctx: CkksContext,
    pk: PublicKey,
    global_params: dict,
    xs: torch.Tensor,
    ys: torch.Tensor,
    gen: torch.Generator,
    with_plain_reference: bool = False,
    streams=None,
):
    """One encrypted FedAvg round on the device of `xs`.

    xs: uint8[C, m, H, W, ch], ys: int[C, m]. `gen` seeds the per-client
    training and encryption generators (made on xs's device); `streams`
    optionally replaces the training streams. -> (Ciphertext sum
    [n_ct, L, N], metrics float32[C, E, 4], encode_overflow int64[C]).

    `with_plain_reference=True` is a MEASUREMENT-ONLY mode that appends the
    plaintext FedAvg mean of the same trained weights: it leaks what the
    encrypted path exists to hide, and exists only to check encode +
    encrypt + sum + decrypt against a plaintext reference in one program.
    """
    num_clients = int(xs.shape[0])
    train_gens = _client_generators(gen, num_clients, xs.device)
    enc_gens = _client_generators(gen, num_clients, xs.device)
    p_out, mets = train_clients(
        model, cfg, global_params, xs, ys,
        gens=None if streams is not None else train_gens, streams=streams,
    )
    overflow = torch.stack([
        encoding.encode_overflow_count(pack_params(prm, ctx.n), ctx.scale) for prm in p_out
    ])
    ct_sum = aggregate_encrypted(ctx, encrypt_stack(ctx, pk, p_out, enc_gens))
    outs = (ct_sum, mets, overflow)
    if with_plain_reference:
        ref = {k: torch.stack([prm[k] for prm in p_out]).mean(dim=0) for k in p_out[0]}
        outs = outs + (ref,)
    return outs


def decrypt_average(
    ctx: CkksContext, sk: SecretKey, ct_sum: Ciphertext, num_clients: int, spec: PackSpec
) -> dict:
    """Owner-side decrypt of the aggregated sum -> averaged parameter dict.
    The division by the client count happens in the decode scale."""
    res = ops.decrypt(ctx, sk, ct_sum)
    blocks = encoding.decode(ctx.ntt, res, ct_sum.scale * int(num_clients))
    return unpack_blocks(blocks, spec)
