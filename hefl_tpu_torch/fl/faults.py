"""Round metadata: who made it into a round's released sum.

The part of `hefl_tpu.fl.faults` the port's rounds use: the exclusion-cause
bits and `RoundMeta`, whose `surviving` count is the decode denominator of
`fl.secure.decrypt_average`. Fault schedules are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EXCLUDED_SCHEDULED = 1      # external mask: scheduled dropout or a padding slot
EXCLUDED_NONFINITE = 2      # NaN/Inf anywhere in the trained update
EXCLUDED_NORM = 4           # update norm above the configured bound
EXCLUDED_OVERFLOW = 8       # encode overflow under on_overflow="exclude"
EXCLUDED_STALE = 16         # late upload exceeded the staleness budget
EXCLUDED_TIMEOUT = 32       # upload missed this round's commit
EXCLUDED_UNREACHABLE = 64   # delivery failed, retries exhausted
EXCLUDED_UNSAMPLED = 128    # not in this round's cohort
EXCLUDED_HOST_TIMEOUT = 256
EXCLUDED_HOST_UNREACHABLE = 512
EXCLUDED_HOST_STALE = 1024

EXCLUSION_CAUSES = {
    "scheduled": EXCLUDED_SCHEDULED,
    "nonfinite": EXCLUDED_NONFINITE,
    "norm": EXCLUDED_NORM,
    "overflow": EXCLUDED_OVERFLOW,
    "stale": EXCLUDED_STALE,
    "timeout": EXCLUDED_TIMEOUT,
    "unreachable": EXCLUDED_UNREACHABLE,
    "unsampled": EXCLUDED_UNSAMPLED,
    "host_timeout": EXCLUDED_HOST_TIMEOUT,
    "host_unreachable": EXCLUDED_HOST_UNREACHABLE,
    "host_stale": EXCLUDED_HOST_STALE,
}


@dataclasses.dataclass(frozen=True)
class RoundMeta:
    """Public outcome of one round: the participation mask applied, with
    cause attribution; `surviving` is the decode denominator."""

    num_clients: int
    bits: tuple[int, ...]
    participation: tuple[int, ...]
    surviving: int
    excluded: dict
    sanitized: bool = True

    @classmethod
    def from_bits(cls, bits, sanitized: bool = True) -> "RoundMeta":
        b = np.asarray(bits, dtype=np.int64)
        part = (b == 0).astype(np.int32)
        return cls(
            num_clients=int(b.size),
            bits=tuple(int(v) for v in b),
            participation=tuple(int(v) for v in part),
            surviving=int(part.sum()),
            excluded={name: int(np.count_nonzero(b & flag))
                      for name, flag in EXCLUSION_CAUSES.items()},
            sanitized=sanitized,
        )

    def record(self) -> dict:
        """JSON-ready summary for a round's history record."""
        return {
            "participation": list(self.participation),
            "surviving": self.surviving,
            "excluded": dict(self.excluded),
            "sanitized": self.sanitized,
        }
