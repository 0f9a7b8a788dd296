"""The JAX certifiers' stand-in for the port's tests (a helper module the
`test_torch_*` files import; not collected).

The JAX certifiers call `jax.experimental.enable_x64()`, which JAX 0.9
removed, and under plain jit `jnp.remainder` traces to a `jit` equation the
JAX interpreter leaves unbounded. The `jax_x64` fixture edits nothing of the
JAX package: `enable_x64` turns x64 on and disables jit while a certifier
traces, so `make_jaxpr` inlines jnp's jitted helpers; `lax.scan` and
`lax.while_loop` stay loop primitives there (JAX runs a scan as a Python
loop under `disable_jit`, which would unroll the probes' folds and lose
their loop reports). It restores the config on exit and clears the JAX
certifiers' caches, so nothing it traced is seen outside it.
"""

import contextlib

import jax
import jax.experimental  # noqa: F401  (the attribute the stand-in sets)
import pytest

from hefl_tpu.analysis import ranges as jranges

JAX_CERTIFIERS = ("certify_packing", "certify_aggregation", "certify_fold_inductive",
                  "certify_fold_tree", "certify_inference", "certify_keyswitch",
                  "certify_transciphering")


def _inlined(fn):
    def run(*args):
        with jax.disable_jit(True):
            return fn(*args)
    return run


def _loop_primitive(orig, n_fns: int):
    """`orig` (lax.scan / lax.while_loop) recorded as its loop primitive even
    under `disable_jit`, its body functions traced with jit still off."""
    def wrapped(*args, **kw):
        if not jax.config.jax_disable_jit:
            return orig(*args, **kw)
        fns = [_inlined(f) for f in args[:n_fns]]
        with jax.disable_jit(False):
            return orig(*fns, *args[n_fns:], **kw)
    return wrapped


@pytest.fixture()
def jax_x64(monkeypatch):
    """The JAX certifiers' `enable_x64` on JAX 0.9 (see the module docstring);
    yields the context manager, for tracing the JAX probes directly."""

    @contextlib.contextmanager
    def enable_x64():
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            with jax.disable_jit():
                yield
        finally:
            jax.config.update("jax_enable_x64", old)

    def clear():
        for name in JAX_CERTIFIERS:
            getattr(jranges, name).cache_clear()

    clear()
    monkeypatch.setattr(jax.experimental, "enable_x64", enable_x64, raising=False)
    monkeypatch.setattr(jax.lax, "scan", _loop_primitive(jax.lax.scan, 1))
    monkeypatch.setattr(jax.lax, "while_loop", _loop_primitive(jax.lax.while_loop, 2))
    try:
        yield enable_x64
    finally:
        clear()


