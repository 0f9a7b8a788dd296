"""The port's scope coverage (`hefl_tpu_torch.analysis.coverage`): every
convolution and matrix product of a round, and every gather of a serving
score, inside a `hefl.*` range of a `torch.profiler` trace.

The round and serving programs run on the CPU here at the JAX gate's tiny
geometry (SmallCNN on `mnist`, 2 clients; serving at n = 256); a card's
trace shape (kernels joined to their launches) is held on hand-built
CUDA-shaped trace events, since the CPU traces carry no kernel events.
"""

import pytest
import torch

from hefl_tpu_torch.analysis import coverage
from hefl_tpu_torch.models import create_model
from hefl_tpu_torch.obs import scopes


@pytest.mark.parametrize("fusion,secure", [("vmap", False), ("fused", False), ("vmap", True)])
def test_round_programs_are_covered(fusion, secure):
    assert coverage.check_round_coverage(fusion=fusion, secure=secure, device="cpu") == []


def test_stream_upload_is_covered():
    assert coverage.check_stream_coverage(fusion="vmap", device="cpu") == []


def test_hhe_programs_are_covered():
    assert coverage.check_hhe_coverage("cpu") == []


def test_serving_programs_are_covered():
    assert coverage.check_inference_coverage("cpu") == []


def test_leaf_sets():
    assert set(coverage.LEAF_PRIMS) == {"aten::convolution", "aten::mm", "aten::addmm",
                                        "aten::bmm", "aten::linear"}
    assert set(coverage.INFERENCE_LEAF_PRIMS) - set(coverage.LEAF_PRIMS) == {
        "aten::index_select", "aten::gather", "aten::take"}


def test_an_unscoped_convolution_is_found():
    torch.manual_seed(0)
    model = create_model("smallcnn", device="cpu")
    x = torch.zeros((2, 28, 28, 1))

    @torch.no_grad()
    def forward(scoped: bool):
        if scoped:
            with torch.profiler.record_function(scopes.EVALUATE):
                return model(x)
        return model(x)

    assert coverage.check_fn_coverage(forward, (True,), "scoped") == []
    found = coverage.check_fn_coverage(forward, (False,), "unscoped")
    assert found and all(f.rule == "missing-scope" for f in found)
    assert any("aten::convolution" in f.message for f in found)


def test_a_trace_without_leaf_ops_or_required_ranges_is_a_finding():
    found = coverage.check_fn_coverage(lambda: torch.ones(3) + 1, (), "empty")
    assert [f.message.startswith("the trace holds no leaf op") for f in found] == [True]
    found = coverage.check_fn_coverage(lambda: torch.ones(3) + 1, (), "ranges", leaf_prims=(),
                                       require_scopes=(scopes.SERVE_HOIST,))
    assert len(found) == 1 and "hefl.serve_hoist" in found[0].message


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def test_kernel_join_on_cuda_shaped_events():
    events = [
        _ev("user_annotation", scopes.SGD_CORE, 0, 100),
        _ev("cpu_op", "aten::convolution", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        _ev("kernel", "implicit_convolve", 40, 5, tid=9, correlation=1),
        # the backward's product, on the autograd thread, while the caller
        # waits inside its range
        _ev("cpu_op", "aten::mm", 50, 10, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 2, tid=2, correlation=2),
        _ev("kernel", "gemm", 60, 5, tid=9, correlation=2),
        # a kernel the profiler recorded no launch for: exempt, counted
        _ev("kernel", "orphan", 70, 5, tid=9, correlation=3),
        # a kernel outside any leaf op: not the rule's business
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 2, correlation=4),
        _ev("kernel", "copy", 310, 5, tid=9, correlation=4),
    ]
    found, stats = coverage.leaf_scope_findings(events, "w")
    assert found == []
    assert stats == {"leaf_ops": 2, "unattributed": 1, "scopes": [scopes.SGD_CORE]}
    # An unscoped product is one finding, whatever its kernels: they
    # resolve to the same (missing) range through obs.trace's join.
    events += [_ev("cpu_op", "aten::addmm", 200, 20),
               _ev("cuda_runtime", "cudaLaunchKernel", 205, 2, correlation=5),
               _ev("kernel", "gemm2", 230, 5, tid=9, correlation=5)]
    found, stats = coverage.leaf_scope_findings(events, "w")
    assert [f.message.split()[0] for f in found] == ["`aten::addmm`"]
    assert stats["leaf_ops"] == 3 and stats["unattributed"] == 1
    from hefl_tpu_torch.obs.trace import _attribute

    phases = {name: phase for name, _, _, phase, _ in _attribute(events)["ops"]}
    assert phases["gemm"] == scopes.SGD_CORE and phases["gemm2"] is None


def test_a_cpu_trace_counts_no_unattributed_kernel():
    events = [_ev("user_annotation", scopes.SGD_CORE, 0, 100),
              _ev("cpu_op", "aten::mm", 10, 20)]
    assert coverage.leaf_scope_findings(events, "w") == (
        [], {"leaf_ops": 1, "unattributed": 0, "scopes": [scopes.SGD_CORE]})
