"""Streaming aggregation: per-round cohorts folded online into a running sum.

Counterpart of `hefl_tpu.fl.stream`, ported as far as the hybrid-HE round
of the `hhe-smoke` preset runs it: `sample_cohort`, `quorum_count`,
`OnlineAccumulator` (the flat fold), `StreamRoundMeta`, and
`StreamEngine.run_round` for a full cohort, quorum 1.0, no faults, no
journal, no DP, no error feedback and staleness 0. Every other knob of
`StreamConfig` and every other argument is refused by name.

With `upload_kind="hhe"` the clients upload stream-cipher word pairs; the
server provisions the keystream pads (one fused-encrypt launch, K3) and
transciphers every upload into CKKS (one K7 launch) before the fold, so the
fold and the owner's decrypt see ordinary CKKS ciphertexts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hefl_tpu_torch.analysis import ranges
from hefl_tpu_torch.ckks.ops import Ciphertext
from hefl_tpu_torch.fl.config import HheConfig, StreamConfig, TrainConfig
from hefl_tpu_torch.fl.faults import RoundMeta
from hefl_tpu_torch.fl.secure import client_uploads
from hefl_tpu_torch.hhe import cipher, transcipher


def sample_cohort(stream: StreamConfig, round_index: int, num_clients: int) -> np.ndarray:
    """The round's cohort: sorted client indices drawn without replacement
    by a PRNG keyed on (stream.seed, round_index, 2)."""
    size = int(stream.cohort_size)
    if size <= 0 or size >= num_clients:
        return np.arange(num_clients)
    rng = np.random.default_rng([int(stream.seed), int(round_index), 2])
    return np.sort(rng.choice(num_clients, size, replace=False))


def quorum_count(stream: StreamConfig, cohort_size: int) -> int:
    """Fresh arrivals needed to commit: ceil(quorum * cohort), floor 1."""
    return max(1, int(math.ceil(stream.quorum * cohort_size)))


class OnlineAccumulator:
    """Running modular sum of ciphertext uploads, folded one arrival (or one
    batch) at a time, on the device of the uploads.

    Each fold adds canonical residues in int64 and reduces mod p, so the
    running sum is canonical int32 and BITWISE equal to the batched sum over
    the same uploads in any arrival order. Duplicate deliveries are rejected
    idempotently by nonce. Memory is one [n_ct, L, N] residue pair.
    """

    def __init__(self, p):
        self._p_host = np.asarray(p, dtype=np.int64)     # [L, 1]
        self._p: torch.Tensor | None = None
        self._c0: torch.Tensor | None = None
        self._c1: torch.Tensor | None = None
        self._nonces: set = set()
        self.folded = 0
        self.duplicates = 0

    def _mod(self, s: torch.Tensor) -> torch.Tensor:
        if self._p is None or self._p.device != s.device:
            self._p = torch.from_numpy(self._p_host).to(s.device)
        return torch.remainder(s, self._p).to(torch.int32)

    def _add(self, s0: torch.Tensor, s1: torch.Tensor) -> None:
        """Fold int64 sums (already reduced or not) into the accumulator."""
        if self._c0 is not None:
            s0 = s0 + self._c0.to(torch.int64)
            s1 = s1 + self._c1.to(torch.int64)
        self._c0, self._c1 = self._mod(s0), self._mod(s1)

    def fold(self, nonce, c0: torch.Tensor, c1: torch.Tensor) -> bool:
        """Fold one upload; False (and count a duplicate) if its nonce was
        already folded."""
        if nonce in self._nonces:
            self.duplicates += 1
            return False
        self._nonces.add(nonce)
        self._add(c0.to(torch.int64), c1.to(torch.int64))
        self.folded += 1
        return True

    def fold_batch(self, nonces, c0_batch: torch.Tensor, c1_batch: torch.Tensor) -> int:
        """Fold a batch of arrivals with one int64 sum and one reduction;
        duplicate nonces (against the window and within the batch) are
        rejected like `fold`'s, first occurrence wins. -> uploads folded."""
        fresh = []
        for i, nonce in enumerate(nonces):
            if nonce in self._nonces:
                self.duplicates += 1
                continue
            self._nonces.add(nonce)
            fresh.append(i)
        if not fresh:
            return 0
        idx = torch.tensor(fresh, dtype=torch.int64, device=c0_batch.device)
        self._add(c0_batch.index_select(0, idx).to(torch.int64).sum(dim=0),
                  c1_batch.index_select(0, idx).to(torch.int64).sum(dim=0))
        self.folded += len(fresh)
        return len(fresh)

    def value(self, like_shape=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The running sum (canonical int32 residues); zeros of `like_shape`
        when nothing folded (the encryption of zero an empty round yields)."""
        if self._c0 is None:
            if like_shape is None:
                raise ValueError("OnlineAccumulator.value: nothing folded and no shape")
            z = torch.zeros(like_shape, dtype=torch.int32)
            return z, z.clone()
        return self._c0, self._c1


@dataclasses.dataclass(frozen=True)
class StreamRoundMeta:
    """One streaming round's public outcome: the RoundMeta the decoder
    needs (surviving = uploads in the released sum) plus the arrival story."""

    meta: RoundMeta
    round_index: int
    cohort: tuple[int, ...]
    quorum: int
    committed: bool
    degraded_reason: str | None
    fresh: int
    stale_folded: int
    carried: int
    stale_excluded: int
    unreachable: int
    arrivals: int
    duplicates: int
    rejected: int
    retries: int
    commit_s: float

    def record(self) -> dict:
        return {
            "cohort": list(self.cohort),
            "quorum": self.quorum,
            "committed": self.committed,
            "degraded_reason": self.degraded_reason,
            "fresh": self.fresh,
            "stale_folded": self.stale_folded,
            "carried": self.carried,
            "stale_excluded": self.stale_excluded,
            "unreachable": self.unreachable,
            "arrivals": self.arrivals,
            "duplicates": self.duplicates,
            "rejected": self.rejected,
            "retries": self.retries,
            "commit_s": round(self.commit_s, 6),
        }


class StreamEngine:
    """Round engine of streaming aggregation, for the configuration the port
    runs: every client in the cohort, every upload arriving once at time 0,
    the round committing when all have folded. The constructor refuses
    every `StreamConfig` knob away from its default (except `upload_kind`)
    and a fault schedule, naming them."""

    def __init__(self, stream: StreamConfig, faults=None):
        defaults = StreamConfig()
        unported = [f.name for f in dataclasses.fields(StreamConfig)
                    if f.name != "upload_kind"
                    and getattr(stream, f.name) != getattr(defaults, f.name)]
        if unported:
            raise ValueError(
                "StreamEngine: " + ", ".join(f"StreamConfig.{n}" for n in unported)
                + " not ported yet: the port runs the full-cohort, quorum-1.0, "
                "fault-free round"
            )
        if faults is not None:
            raise ValueError("StreamEngine: fault schedules (faults=) are not ported yet")
        self.stream = stream

    def run_round(self, model, cfg: TrainConfig, ctx, pk, global_params, xs, ys,
                  gen: torch.Generator, round_index: int, dp=None, packing=None,
                  num_real_clients=None, session=None, hhe: HheConfig | None = None):
        """Train, upload, (transcipher,) fold and commit one round.

        -> (Ciphertext sum, metrics [C, E, 4], overflow [C], StreamRoundMeta);
        `meta.meta.surviving` is the decode denominator. With upload_kind
        "hhe" the uploads are the packed update under each client's stream
        cipher (keys from `derive_client_keys(hhe.key_seed, C)`, counter
        `round_index`), and the server provisions the pads from the per-client
        encryption generators the direct upload would have used, then
        transciphers every upload in one batch before the fold."""
        for name, value in (("dp", dp), ("num_real_clients", num_real_clients),
                            ("session", session)):
            if value is not None:
                raise ValueError(f"StreamEngine.run_round: {name}= is not ported yet")
        hhe_mode = self.stream.upload_kind == "hhe"
        if hhe_mode and packing is None:
            raise ValueError(
                "upload_kind=hhe ships the PACKED quantized update under the stream "
                "cipher; add a PackingConfig"
            )
        if hhe is not None and not hhe_mode:
            raise ValueError("an HheConfig is given but StreamConfig.upload_kind is not 'hhe'")
        if packing is not None:
            # Round-setup range proof: the geometry the folds rely on, or refuse.
            guard_bits = packing.guard - max(packing.clients - 1, 0).bit_length()
            certify = ranges.certify_transciphering if hhe_mode else ranges.certify_packing
            cert = certify(int(ctx.modulus), packing.bits, packing.k, packing.clients,
                           guard_bits)
            if not cert.ok:
                raise ValueError(
                    f"upload_kind={self.stream.upload_kind} rejected — {cert.summary()}"
                )
        num_clients = int(xs.shape[0])
        cohort = sample_cohort(self.stream, round_index, num_clients)
        qcount = quorum_count(self.stream, len(cohort))
        hhe = (hhe or HheConfig()) if hhe_mode else None
        keys = cipher.derive_client_keys(hhe.key_seed, num_clients) if hhe_mode else None
        uploads, mets, overflow, _, enc_gens, _ = client_uploads(
            model, cfg, ctx, pk, global_params, xs, ys, gen, packing=packing,
            hhe_keys=keys, round_index=round_index,
        )
        if hhe_mode:
            cts, _ = transcipher.transcipher_batch(
                ctx, packing, pk, *uploads, keys, round_index, enc_gens
            )
        else:
            cts = uploads
        # Every upload arrives once, in client order (no fault schedule), so
        # the round commits with every cohort upload folded; the packing's
        # headroom holds them all (`client_uploads` checked C).
        acc = OnlineAccumulator(ctx.ntt.p)
        for c in cohort:
            acc.fold((int(c), int(round_index)), cts.c0[c], cts.c1[c])
        c0, c1 = acc.value()
        smeta = StreamRoundMeta(
            meta=RoundMeta.from_bits(np.zeros(num_clients, np.int64)),
            round_index=int(round_index), cohort=tuple(int(c) for c in cohort),
            quorum=qcount, committed=True, degraded_reason=None, fresh=acc.folded,
            stale_folded=0, carried=0, stale_excluded=0, unreachable=0, arrivals=acc.folded,
            duplicates=acc.duplicates, rejected=0, retries=0, commit_s=0.0,
        )
        return Ciphertext(c0=c0, c1=c1, scale=cts.scale), mets, overflow, smeta
