"""The multi-GPU measurement tool (``tpuflow_torch.tools.multi_gpu``)
rehearsed on the CPU at a tiny size: the member split over two CPU mesh
entries held to the flat rollout, and the training CLI under torchrun on
one and two gloo processes, the two-process f32 window held to the
one-process window on the same batch."""

import pytest
import torch

from tpuflow_torch.tools import multi_gpu

torch.set_num_threads(1)

TINY_ARGS = ["model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
             "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
             "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
             "model.lf_shape=4,8"]


def test_cpu_rehearsal_holds_split_and_data_parallel():
    res = multi_gpu.main(["--device", "cpu", "--cpu-ranks", "2", "--members", "4",
                          "--steps", "2", "--epochs", "1", *TINY_ARGS])
    assert res["failed"] == []
    (split,) = res["split"]
    assert split["devices"] == 2 and split["members"] == 4 and split["non_finite"] == 0
    assert split["max_rel_err"] <= multi_gpu.SPLIT_TOL
    assert len(split["steps_per_sec_flat"]) == len(split["steps_per_sec_split"]) == 2
    train = res["train"]
    assert train["f32_bpd_rel_err"][0] <= multi_gpu.DP_TOL["bpd"]
    assert train["f32_grad_norm_rel_err"][0] <= multi_gpu.DP_TOL["grad_norm"]
    for key in ("procs1_batch8", "procs2_batch8", "procs2_batch16"):
        assert train[key]["windows_per_sec"] > 0
    # Same global batch and seed: the same epoch, averaged over the ranks.
    assert train["procs2_batch8"]["mean_bpd"] == pytest.approx(
        train["procs1_batch8"]["mean_bpd"], rel=1e-4)


def test_split_check_refuses_a_disagreeing_split(monkeypatch):
    """A split whose chunks compute something else fails the tool."""
    from tpuflow_torch.configs import load_case, parse_cli_overrides
    from tpuflow_torch.eval import rollout as rollout_mod

    real = rollout_mod.make_ensemble_rollout

    def skewed(model, n, temperature=1.0, *a, mesh=None, **k):
        run = real(model, n, temperature, *a, mesh=mesh, **k)
        if mesh is None:
            return run
        return lambda *x, **kw: {key: v + 1.0 for key, v in run(*x, **kw).items()}

    monkeypatch.setattr("tpuflow_torch.eval.make_ensemble_rollout", skewed)
    cfg = load_case("backward-step", parse_cli_overrides(TINY_ARGS)).model
    with pytest.raises(SystemExit, match="disagrees with the flat rollout"):
        multi_gpu.split_rollout(cfg, [torch.device("cpu")] * 2, 4, 2, 0.85)
