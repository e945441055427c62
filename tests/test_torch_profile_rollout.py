"""The rollout profiler (``tpuflow_torch.tools.profile_rollout``): its
grouping on synthetic kernel tables, its module annotations, and its run
on the CPU at a tiny size (no device kernels there: only the control
flow is checked). Its numbers come from the card."""

import importlib
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpuflow_torch.tools import profile_rollout as tool

torch.set_num_threads(1)

# (kernel name, the launching call's CPU ancestors innermost first, group)
TABLE = [
    ("void (anonymous namespace)::conv3x3_mma_kernel<1>(...)", (), "K2"),
    ("void (anonymous namespace)::ld_reduce_kernel(...)", ("tpf::priors",), "K2"),
    ("void (anonymous namespace)::conv3x3_kernel<float, float, 0>(...)", (), "K2"),
    ("void (anonymous namespace)::affine_logdet_kernel(...)", (), "K2"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", ("aten::cudnn_convolution", "aten::conv2d",
                                            "tpf::conditioning"), "conditioning"),
    ("elementwise_kernel<copy>", ("aten::copy_", "aten::contiguous"), "other"),
    ("sm90_xmma_gemm_f32", ("aten::mm", "aten::matmul", "tpf::inv-1x1"), "inv-1x1"),
    ("elementwise_kernel<mul>", ("aten::mul", "tpf::ActNorm"), "ActNorm"),
    ("philox_kernel", ("aten::normal_", "aten::randn", "tpf::priors"), "priors"),
    ("implicit_convolve_sgemm", ("aten::conv2d", "tpf::conditioning", "tpf::priors"),
     "conditioning"),
    ("reduce_kernel<mean>", ("aten::mean",), "other"),
    ("Memset (Device)", (), "other"),
]


@pytest.mark.parametrize("kernel,stack,group", TABLE)
def test_group_of_synthetic_table(kernel, stack, group):
    assert tool.group_of(kernel, stack) == group


def _events():
    """prof.events() in miniature: device kernels and the runtime calls
    that launched them (same id) under ops and annotations; K2's kernels
    launched by no traced call; an annotation's range on the device
    timeline, which is no kernel."""
    k = SimpleNamespace
    cpu, cuda = SimpleNamespace(name="CPU"), SimpleNamespace(name="CUDA")

    def launch(id_, stack):
        parent = None
        for name in reversed(stack):
            parent = k(device_type=cpu, name=name, id=-1, cpu_parent=parent)
        return k(device_type=cpu, name="cudaLaunchKernel", id=id_, cpu_parent=parent)

    def dev(id_, name, us):
        return k(device_type=cuda, name=name, id=id_,
                 time_range=k(start=100.0, end=100.0 + us))

    inv, act, split = TABLE[6][1], TABLE[7][1], TABLE[8][1]
    return [
        launch(1, inv), launch(2, act), launch(3, act), launch(7, split),
        dev(1, "gemm", 30.0), dev(2, "mul", 10.0), dev(3, "mul", 12.0), dev(7, "philox", 40.0),
        dev(4, "conv3x3_mma_kernel<2>", 200.0), dev(5, "ld_reduce_kernel", 2.0),
        dev(6, "Memset (Device)", 1.0), dev(8, "tpf::priors", 500.0),
    ]


def test_device_time_by_kernel_counts_every_kernel_once():
    rows = tool.device_time_by_kernel(_events())
    assert rows[("inv-1x1", "gemm")] == [0.03, 1]
    assert rows[("ActNorm", "mul")] == pytest.approx([0.022, 2])
    assert rows[("K2", "conv3x3_mma_kernel<2>")] == [0.2, 1]
    assert rows[("priors", "philox")] == [0.04, 1]
    groups = tool.by_group(rows)
    assert list(groups) == list(tool.GROUPS)
    assert groups == pytest.approx({"K2": 0.202, "conditioning": 0.0, "inv-1x1": 0.03,
                                    "priors": 0.04, "ActNorm": 0.022, "other": 0.001})


def test_annotate_labels_each_module_and_restores_it():
    from tpuflow_torch.flows.actnorm import ActNorm

    before = {(m, c, n): getattr(importlib.import_module(m), c).__dict__[n]
              for _, m, c, n in tool.ANNOTATED}
    norm = ActNorm(4)
    with tool.annotate(), profile(activities=[ProfilerActivity.CPU]) as prof:
        norm(torch.ones(2, 3, 3, 4))
    assert "tpf::ActNorm" in {e.name for e in prof.events()}
    after = {(m, c, n): getattr(importlib.import_module(m), c).__dict__[n]
             for _, m, c, n in tool.ANNOTATED}
    assert after == before and {g for g, *_ in tool.ANNOTATED} <= set(tool.GROUPS)


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main would profile it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--steps", "1"])


def test_run_on_the_cpu_at_a_tiny_size(capsys):
    small = ["model.hf_shape=16,32", "model.lf_shape=4,8", "model.n_scales=2",
             "model.n_flow_steps=2", "model.coupling_width=8", "model.growth_rate=4",
             "model.coupling_layers=1", "model.encoder_width=4", "model.lstm_hidden=4",
             "model.cond_channels=4"]
    out = tool.run("backward-step", torch.device("cpu"), 2, overrides=small)
    assert set(out["groups_ms"]) == set(tool.GROUPS) and out["wall_ms"] > 0
    assert "device idle" in capsys.readouterr().out
