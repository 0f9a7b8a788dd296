"""Phase-scope names, and the profiler ranges that carry them.

Counterpart of `hefl_tpu.obs.scopes`, with its names, strings and order. The
JAX package writes them into its programs as `jax.named_scope`s and host
`jax.profiler.TraceAnnotation`s; here they label `torch.profiler` ranges
(`torch.profiler.record_function`, a `user_annotation` event in the trace),
so a trace of either package names the same phases. `obs.trace` attributes
each device op to the innermost phase range open on the thread that
launched it.

Annotation rule: one range per training step, per call or per serving
stage (a sweep of rotations, not each rotation), never per ciphertext row
or per layer: on the H100's host a range cost 7-12 us alone and ~35 us
of a serving score's host time, whether or not a profiler is on. Ranges
nest; the innermost is the attribution (augment inside sgd_core, the
key-switches inside a BSGS rotation sweep).
"""

from __future__ import annotations

import functools
import re

import torch

PREFIX = "hefl."

AUGMENT = "hefl.augment"              # affine-warp data augmentation
SGD_CORE = "hefl.sgd_core"            # fwd/bwd/Adam + batch gather/shuffles
VAL = "hefl.val"                      # per-epoch validation + callbacks
SANITIZE = "hefl.sanitize"            # poison injection + exclusion predicates
ENCRYPT = "hefl.encrypt"              # pack/encode + CKKS encrypt core
TRANSCIPHER = "hefl.transcipher"      # HHE trivial-embed + keystream subtract
PSUM_AGGREGATE = "hefl.psum_aggregate"  # ciphertext masking + lazy sum (the ciphertext fold)
AGGREGATE = "hefl.aggregate"          # plaintext (masked) FedAvg mean
DECRYPT = "hefl.decrypt"              # c0 + c1*s, iNTT, decode, unpack
EVALUATE = "hefl.evaluate"            # test-set forward + softmax
SERVE_SCORE = "hefl.serve_score"      # inference ct x plain mul + bias
SERVE_ROTATE = "hefl.serve_rotate"    # rotation sweep bodies (ladder/BSGS)
SERVE_KEYSWITCH = "hefl.serve_keyswitch"  # gadget key-switch (fused kernel)
SERVE_HOIST = "hefl.serve_hoist"      # hoisted decompose + per-step products

# Host-side spans: driver work that owns wall-clock but runs no device op.
# `obs.trace` reports them as `host_rows`, beside PhaseTimer's
# `hefl.phase.<name>` brackets.
STRAGGLER_WAIT = "hefl.straggler_wait"  # driver-side straggler sleep
QUORUM_WAIT = "hefl.quorum_wait"        # streaming engine's wait-for-quorum

# Canonical ordering for tables; the trace parser buckets ANY "hefl.*"
# range it finds, so adding a scope never requires touching the parser.
PHASES = (
    AUGMENT,
    SGD_CORE,
    VAL,
    SANITIZE,
    ENCRYPT,
    TRANSCIPHER,
    PSUM_AGGREGATE,
    AGGREGATE,
    DECRYPT,
    EVALUATE,
    SERVE_SCORE,
    SERVE_ROTATE,
    SERVE_KEYSWITCH,
    SERVE_HOIST,
)

HOST_SPANS = (STRAGGLER_WAIT, QUORUM_WAIT)
# The range in which `obs.trace.round_profiler` launches a few throwaway
# kernels at the start of a traced window: the profiler has lost the kernel
# events of a window's first launches, and these are the ones it loses.
# `obs.trace` leaves its launches and kernels out of every count.
PROFILER_PRIME = "hefl.profiler_prime"
# PhaseTimer's brackets (`utils.timers`): the port's counterpart of the JAX
# record's per-program `modules`.
MODULE_PREFIX = "hefl.phase."

_SCOPE_RE = re.compile(r"hefl\.[A-Za-z0-9_]+")


def is_phase_scope(component: str) -> bool:
    """Is this name (or op_name path component) one of ours?"""
    return component.startswith(PREFIX)


def scope_of(op_name: str) -> str | None:
    """Deepest hefl.* scope in an op_name path (scopes nest, and the
    innermost is the attribution); path components run outer -> inner, so
    the last match wins."""
    hits = _SCOPE_RE.findall(op_name)
    return hits[-1] if hits else None


def scoped(name: str):
    """Decorator: run the function inside a `record_function(name)` range,
    a fresh one a call (so nested and concurrent calls each get their own)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
