from tpuflow_torch.eval.rollout import make_ensemble_rollout

__all__ = ["make_ensemble_rollout"]
