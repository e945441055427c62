from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.eval.rollout import (
    make_batched_ensemble_rollout,
    make_ensemble_rollout,
    make_nll_eval,
)

__all__ = [
    "load_eval_bundle",
    "make_batched_ensemble_rollout",
    "make_ensemble_rollout",
    "make_nll_eval",
    "resolve_temperature",
]
