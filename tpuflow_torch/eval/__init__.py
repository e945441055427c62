from tpuflow_torch.eval.rollout import make_ensemble_rollout, make_nll_eval

__all__ = ["make_ensemble_rollout", "make_nll_eval"]
