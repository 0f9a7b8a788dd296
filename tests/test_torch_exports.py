"""The port's subpackages re-export the JAX package's public names.

Each JAX subpackage's `__all__` is read from its `__init__.py` by AST (no
JAX import). Every name the port defines is re-exported by the port's
subpackage of the same name and listed in its `__all__`; the names it does
not define are listed here, each with its reason, and are absent.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("fl", "data", "utils", "obs", "models", "hhe")

UNPORTED = {
    "data": {
        "Batcher": "data/batches.py: no driver path batches through it (ROADMAP, not queued)",
        "one_hot": "data/batches.py: the port calls torch.nn.functional.one_hot (ROADMAP, not "
                   "queued)",
    },
}

# Functions of the JAX `obs/trace.py` that have no counterpart: a
# torch.profiler trace of eager PyTorch carries no compiled program whose
# HLO metadata would hold the scopes (the port joins each kernel to the
# ranges around its launch instead).
TRACE_NOT_APPLICABLE = {
    "hlo_scope_map": "no HLO text: scopes are the ranges around each kernel's launch",
    "hlo_module_name": "no HLO module: the modules are PhaseTimer's hefl.phase.* ranges",
    "metadata_preserving_compile": "no compiled program and no compilation cache",
}


def _jax_all(sub: str) -> list[str]:
    tree = ast.parse((REPO / "hefl_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"hefl_tpu/{sub}/__init__.py has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_every_ported_jax_name(sub):
    port = importlib.import_module(f"hefl_tpu_torch.{sub}")
    names = _jax_all(sub)
    unported = UNPORTED.get(sub, {})
    assert set(unported) <= set(names), "an unported name the JAX package does not export"
    for name in names:
        if name in unported:
            assert not hasattr(port, name), f"{name} is ported now: re-export it"
            continue
        assert hasattr(port, name), f"hefl_tpu_torch.{sub} lacks {name}"
        assert name in port.__all__, f"{name} missing from hefl_tpu_torch.{sub}.__all__"
    assert all(hasattr(port, name) for name in port.__all__)


def test_obs_trace_ports_every_jax_function_that_applies():
    tree = ast.parse((REPO / "hefl_tpu" / "obs" / "trace.py").read_text())
    public = {n.name for n in tree.body
              if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}
    port = importlib.import_module("hefl_tpu_torch.obs.trace")
    assert set(TRACE_NOT_APPLICABLE) <= public
    for name in sorted(public):
        assert hasattr(port, name) != (name in TRACE_NOT_APPLICABLE), name
    from hefl_tpu_torch.obs import TraceParseError, trace, trace_attribution

    assert trace is port and trace_attribution is port.trace_attribution
    assert TraceParseError is port.TraceParseError


def test_jax_subpackage_sizes():
    # The JAX __all__ lists this test reads (47, 13, 16, 10, 7, 11 names).
    assert [len(_jax_all(sub)) for sub in SUBPACKAGES] == [47, 13, 16, 10, 7, 11]


def test_the_round_and_wire_names_import_from_the_subpackages():
    from hefl_tpu_torch.data import make_dataset
    from hefl_tpu_torch.fl import (
        StreamEngine,
        cohort_compare_record,
        decrypt_average,
        encrypt_params,
        encrypt_params_packed,
        secure_fedavg_round,
    )
    from hefl_tpu_torch.fl import secure, stream
    from hefl_tpu_torch.obs import trend
    from hefl_tpu_torch.utils import load_ciphertext, save_ciphertext, serialization

    assert secure_fedavg_round is secure.secure_fedavg_round
    assert decrypt_average is secure.decrypt_average
    assert encrypt_params is secure.encrypt_params
    assert encrypt_params_packed is secure.encrypt_params_packed
    assert StreamEngine is stream.StreamEngine
    assert cohort_compare_record is stream.cohort_compare_record
    assert save_ciphertext is serialization.save_ciphertext
    assert load_ciphertext is serialization.load_ciphertext
    assert callable(make_dataset) and callable(trend.evaluate)
