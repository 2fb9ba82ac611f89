"""Reading a chrome trace: device time to layers through correlation ids
and enclosing host ops, a backward node through its forward op, the busy
union and idle gaps by host op."""

import json

import pytest

from h100_bench import spec, tracing


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


EVENTS = [
    _x("user_annotation", "bench::ConvBN", 0, 100),
    _x("cpu_op", "aten::mm", 10, 20, **{"Sequence number": 5}),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 5, correlation=1),
    _x("cpu_op", "aten::mul", 40, 10, **{"Sequence number": 6}),
    _x("cpu_op", "cl3d::ball_query", 110, 40),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=2),
    _x("cpu_op", "aten::add", 160, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 162, 3, correlation=3),
    _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 200,
       60, tid=2, **{"Sequence number": 6}),
    _x("cpu_op", "aten::mul", 210, 30, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 215, 5, tid=2, correlation=4),
    _x("cpu_op", "autograd::engine::evaluate_function: _PosPoolBackward",
       300, 50, tid=2, **{"Sequence number": 9}),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 5, tid=2, correlation=5),
    _x("kernel", "gemm", 30, 10, tid=7, correlation=1),
    _x("kernel", "ball_query_kernel", 130, 20, tid=7, correlation=2),
    _x("kernel", "add_kernel", 170, 5, tid=7, correlation=3),
    _x("kernel", "mul_kernel", 250, 10, tid=7, correlation=4),
    _x("kernel", "pospool_bwd", 355, 10, tid=7, correlation=5),
    _x("gpu_user_annotation", "not an op", 0, 400, tid=7),
]


@pytest.fixture
def summary(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.read_trace(str(path), spec.layers())


def test_device_time_by_layer(summary):
    got = {k: round(v * 1e6, 6) for k, v in summary["per_layer_s"].items()}
    # the gemm by its aten::mm; the backward mul by its forward op, inside
    # the ConvBN span; the pospool backward by its node's name
    assert got == {"dense": 20.0, "geometry": 20.0, "aggregation": 10.0}
    assert round(summary["unclaimed_s"] * 1e6, 6) == 5.0
    assert summary["device_ops"] == 5


def test_busy_union_and_gaps(summary):
    assert summary["busy_s"] == pytest.approx(55e-6)
    gaps = dict(summary["breakdown"]["idle_gaps"])
    assert gaps["bench::ConvBN"] == pytest.approx(90e-6)
    top = summary["breakdown"]["device_ops"]
    assert top[0] == ["ball_query_kernel", pytest.approx(20e-6)]
