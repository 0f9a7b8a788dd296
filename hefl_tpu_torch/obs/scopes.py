"""Phase-scope names, the ones this package's paths use.

Counterpart of the names in `hefl_tpu.obs.scopes`. The JAX package writes
them into its programs as `jax.named_scope`s and host
`jax.profiler.TraceAnnotation`s; here they label `torch.profiler`
ranges (`torch.profiler.record_function`), so a trace of either package
names the same phases. The host span of the streaming engine's
real-time quorum wait (`StreamConfig.time_scale > 0`) is `QUORUM_WAIT`.
"""

from __future__ import annotations

PREFIX = "hefl."

SANITIZE = "hefl.sanitize"            # poison injection + exclusion predicates
ENCRYPT = "hefl.encrypt"              # pack/encode + CKKS encrypt core
TRANSCIPHER = "hefl.transcipher"      # HHE trivial-embed + keystream subtract
AGGREGATE = "hefl.aggregate"          # the ciphertext fold
DECRYPT = "hefl.decrypt"              # c0 + c1*s, iNTT, decode, unpack

# Host-side spans: driver work that owns wall-clock but runs no device op.
STRAGGLER_WAIT = "hefl.straggler_wait"  # driver-side straggler sleep
QUORUM_WAIT = "hefl.quorum_wait"        # streaming engine's wait-for-quorum

PHASES = (SANITIZE, ENCRYPT, TRANSCIPHER, AGGREGATE, DECRYPT)
