"""Windowed-BPTT NLL loss, the optimizer, and the train steps.

Counterpart of ``tpuflow/train/step.py``. Per window: run the model over
time carrying the ConvLSTM state, take the mean over the window of the
mean bits/dim, backpropagate through the whole window, clip the global
gradient norm, and take an Adam step. Truncation: the state *value*
carries across windows, its gradient does not (the state is detached at
every window boundary), as the JAX package's per-window
``value_and_grad`` does. The time loop is a Python loop; with ``remat``
each timestep runs under ``torch.utils.checkpoint`` (the counterpart of
``jax.checkpoint``), so the backward recomputes that timestep's
activations instead of keeping the whole window's.

The optimizer matches the JAX package's optax chain
``clip_by_global_norm -> [add_decayed_weights] -> adam(schedule)``:

* the clip is optax's form, g if norm < max else g / norm * max, and is
  applied here by :func:`clip_by_global_norm_` (``clip_grad_norm_``
  divides by norm + 1e-6 and does not match);
* ``torch.optim.Adam``'s ``weight_decay`` adds wd * param to the clipped
  gradient before the moments, as ``add_decayed_weights`` does;
* the learning rate decays continuously, lr * decay ** (step / 100)
  (optax's ``exponential_decay`` without staircase), through
  ``LambdaLR``; the stepped ``ExponentialLR`` would not match.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from tpuflow_torch.data.dataset import TrajectoryDataset
from tpuflow_torch.models.tmglow import LSTMState, TMGlow, init_lstm_state


def remat_step(fn: Callable, remat: bool) -> Callable:
    """``fn`` itself, or with ``remat`` ``fn`` under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes
    its forward. The recompute restores the global RNG but not an
    explicit ``torch.Generator``, so a checkpointed function must take
    its random draws as arguments."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def window_bpd_fn(
    model: TMGlow, remat: bool = False
) -> Callable[..., tuple[torch.Tensor, LSTMState]]:
    """Build loss(lf_win, hf_win, state) -> (mean bits/dim over the
    window, final state); lf_win/hf_win are batch-major (B, W, ...).
    ``remat`` recomputes each timestep in the backward pass."""

    def step(hf_t, lf_t, state):
        bpd, state = model.nll_step(hf_t, lf_t, state)
        return bpd.mean(), state

    step = remat_step(step, remat)

    def loss_fn(lf_win: torch.Tensor, hf_win: torch.Tensor, state: LSTMState):
        bpds = []
        for t in range(lf_win.shape[1]):
            bpd, state = step(hf_win[:, t], lf_win[:, t], state)
            bpds.append(bpd)
        return torch.stack(bpds).mean(), state

    return loss_fn


def make_optimizer(
    params,
    lr: float,
    lr_decay: float,
    weight_decay: float = 0.0,
    decay_every: int = 100,
) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (betas 0.9/0.999, eps 1e-8) with the continuous decay
    lr * lr_decay ** (step / decay_every); call ``scheduler.step()``
    after every ``optimizer.step()``. The gradient clip is
    :func:`clip_by_global_norm_`, applied before the step."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_decay ** (step / decay_every)
    )
    return opt, sched


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: g is kept if the global
    norm is below ``max_norm``, else replaced by g / norm * max_norm.
    Returns the unclipped norm (a 0-d tensor; nothing waits for it)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(
    model: TMGlow,
    optimizer: torch.optim.Optimizer,
    scheduler,
    grad_clip: float,
    lf_win: torch.Tensor,
    hf_win: torch.Tensor,
    state: LSTMState,
    remat: bool = False,
) -> tuple[LSTMState, dict[str, torch.Tensor]]:
    """One window: loss, backward, clip, Adam step. Returns the final
    state (detached: its value carries, its gradient does not) and
    {"bpd", "grad_norm"} (the norm before the clip), as 0-d tensors."""
    params = [p for p in model.parameters() if p.requires_grad]
    loss, state = window_bpd_fn(model, remat)(lf_win, hf_win, state)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    norm = clip_by_global_norm_(list(grads), grad_clip)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    scheduler.step()
    state = tuple((h.detach(), c.detach()) for h, c in state)
    return state, {"bpd": loss.detach(), "grad_norm": norm}


def trajectory_train_step(
    model: TMGlow,
    optimizer: torch.optim.Optimizer,
    scheduler,
    grad_clip: float,
    window: int,
    lf_traj: torch.Tensor,
    hf_traj: torch.Tensor,
    remat: bool = False,
) -> dict[str, torch.Tensor]:
    """Every BPTT window of a trajectory batch (B, T, ...) in order, the
    semantics of the JAX package's ``make_trajectory_train_step``: the
    state starts at zero, carries its value across windows with the
    gradient cut, the trailing partial window is dropped, and zero
    windows raise. Returns {"bpd", "grad_norm"} per window, shape
    (n_windows,)."""
    state = init_lstm_state(model.cfg, lf_traj.shape[0], lf_traj.device)
    bpds, norms = [], []
    for lf_win, hf_win in TrajectoryDataset.windows(lf_traj, hf_traj, window):
        state, m = train_step(model, optimizer, scheduler, grad_clip, lf_win, hf_win, state,
                              remat)
        bpds.append(m["bpd"])
        norms.append(m["grad_norm"])
    return {"bpd": torch.stack(bpds), "grad_norm": torch.stack(norms)}
