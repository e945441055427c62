"""Sample-path fine-tuning: dispersion and spectral shape in the loop.

Counterpart of ``tpuflow/train/finetune.py``. A converged NLL-trained
model is fine-tuned on a composite objective evaluated on actual
generative draws every window:

    loss = mean bpd                          (NLL anchor: keeps density)
         + lambda_crps * fair ensemble CRPS  (dispersion in the loop)
         + lambda_spec * log-spectrum MSE    (member fluctuation spectra
                                              against converged
                                              reference targets)
         + lambda_disp * spread-skill MSE    (ensemble variance against
                                              the squared ensemble-mean
                                              error, pointwise)
         + bound                             (always on: zero while
                                              |member| <= 8)

optionally with a learned per-scale sampling temperature ``log_tau``,
optimized jointly with the parameters and deployed through the
checkpoint meta's ``learned_tau`` (``eval/loading.resolve_temperature``).

Each timestep runs ``TMGlow.nll_and_sample_step``: the teacher-forced
NLL and ``n_members`` draws per example under one conditioning pass, so
the fused coupling runs forward at batch B and in reverse at B x
n_members, both under autograd. Draws are standard-normal ``eps`` made
before each timestep runs (from a ``torch.Generator``, or handed in),
so a timestep recomputed under ``remat`` samples the same members.

The optimizer is the JAX package's optax chain over (params, log_tau):
the global-norm clip over every gradient and log_tau's, Adam, updates
outside the scope zeroed, log_tau's update scaled by ``tau_lr_scale``
(0 without ``learn_tau``). For Adam, scaling an update is scaling its
learning rate, so here it is one ``torch.optim.Adam`` whose parameter
groups have lr, 0 (outside the scope) and lr x tau_lr_scale (log_tau).

A window whose loss or gradient norm is not finite changes nothing (no
parameter, no log_tau, no Adam moment or step count): the step reads the
window's finiteness on the host, one wait on the device per window, and
skips ``optimizer.step()``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from tpuflow_torch.data.dataset import TrajectoryDataset
from tpuflow_torch.eval.stats import energy_spectrum, ensemble_crps
from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state, latent_shapes
from tpuflow_torch.train.step import clip_by_global_norm_, remat_step

# Hard ceiling of the learned temperature: tau >= ~1.15 puts the bulk of
# the latent distribution outside the coupling nets' domain and rollouts
# diverge regardless of clipping; the optimizer must not walk there.
_TAU_MAX = 1.1

_SPEC_EPS = 1e-14

# Per window: the loss terms the trajectory step averages over finite
# windows, in the order of its metrics.
_TERMS = ("loss", "bpd", "crps", "spec", "disp", "bound", "grad_norm")


def member_log_spectra(members: torch.Tensor) -> torch.Tensor:
    """Per-trajectory log radial spectra of member fluctuations.

    members: (W, B, M, H, Wd, C) sampled fields (normalized space).
    Velocity channels only; fluctuations remove the (window x member)
    mean per trajectory; index-space bins with the Hann taper. Returns
    (B, nbins-1)."""
    w, b, m = members.shape[:3]
    mem = members.movedim(1, 0).reshape(b, w * m, *members.shape[3:])[..., :2]
    fluct = mem - mem.mean(dim=1, keepdim=True)
    e_m = energy_spectrum(fluct, None, taper=True, batch_dims=1)[1][:, 1:]
    return torch.log(e_m + _SPEC_EPS)


def converged_log_spectra(hf_ref: torch.Tensor) -> torch.Tensor:
    """Log radial spectrum target of a converged reference trajectory
    (T, H, W, C) in normalized space -> (nbins-1,)."""
    fl = hf_ref[..., :2] - hf_ref[..., :2].mean(dim=0, keepdim=True)
    e = energy_spectrum(fl, None, taper=True)[1][1:]
    return torch.log(e + _SPEC_EPS)


def spectral_target_mse(members: torch.Tensor, log_targets: torch.Tensor) -> torch.Tensor:
    """MSE between the member-fluctuation log spectra and precomputed
    converged-reference log-spectrum targets (B, nbins-1)."""
    d = member_log_spectra(members) - log_targets
    return torch.mean(d * d)


def dispersion_log_mse(
    members: torch.Tensor, hf_tm: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Spread-skill loss: per-pixel log-MSE between the fair ensemble
    variance (ddof 0, times 1 + 1/M) and the squared ensemble-mean error,
    each averaged over the window. members (W, B, M, H, Wd, C); hf_tm
    (W, B, H, Wd, C)."""
    m = members.shape[2]
    mu = members.mean(dim=2)
    err2 = ((mu - hf_tm) ** 2).mean(dim=0)
    var = members.var(dim=2, correction=0).mean(dim=0) * (1.0 + 1.0 / m)
    d = torch.log(var + eps) - torch.log(err2 + eps)
    return torch.mean(d * d)


def clipped_tau(log_tau: torch.Tensor) -> torch.Tensor:
    """exp(log_tau) bounded to (0, _TAU_MAX] (the stability ceiling)."""
    return torch.clamp(torch.exp(log_tau), max=_TAU_MAX)


def window_draws(
    model: TMGlow, batch: int, n_members: int, window: int, generator: torch.Generator
) -> list[list[torch.Tensor]]:
    """Standard-normal draws of one window: per timestep, per scale l,
    shaped as scale l's latent at batch x n_members, on the model's
    device."""
    shapes = latent_shapes(model.cfg, batch * n_members)
    dev = model.device
    return [[torch.randn(s, generator=generator, device=dev) for s in shapes]
            for _ in range(window)]


def make_finetune_loss(model: TMGlow, n_members: int, remat: bool = False) -> Callable:
    """Build loss(log_tau, lf_win, hf_win, spec_target, state,
    lambda_crps, lambda_spec, lambda_disp, draws) -> (total, aux) over
    ``model``'s parameters and ``log_tau``. Windows are batch-major
    (B, W, ...); ``draws`` is a ``torch.Generator`` or the window's
    draws as :func:`window_draws` makes them. aux holds the 0-d terms
    "bpd", "crps", "spec", "disp", "bound" and the final "state"."""

    def step(hf_t, lf_t, state, tau, eps_t):
        bpd, members, state = model.nll_and_sample_step(
            hf_t, lf_t, state, tau, n_members, eps=eps_t)
        return bpd.mean(), members, state

    step = remat_step(step, remat)

    def loss_fn(log_tau, lf_win, hf_win, spec_target, state, lambda_crps, lambda_spec,
                lambda_disp, draws):
        tau = clipped_tau(log_tau)
        b, w = lf_win.shape[:2]
        if isinstance(draws, torch.Generator):
            draws = window_draws(model, b, n_members, w, draws)
        bpds, members = [], []
        for t in range(w):
            bpd, mem, state = step(hf_win[:, t], lf_win[:, t], state, tau, draws[t])
            bpds.append(bpd)
            members.append(mem)
        members = torch.stack(members)  # (W, B, M, H, Wd, C), normalized space
        hf_tm = hf_win.movedim(1, 0)
        bpd = torch.stack(bpds).mean()
        crps = ensemble_crps(members, hf_tm, axis=2).mean()
        spec = spectral_target_mse(members, spec_target)
        disp = dispersion_log_mse(members, hf_tm)
        # Always-on stability barrier: normalized fields live at |x| <~ 5;
        # penalizing excursions beyond 8 keeps a widened sampler inside
        # the decoder's validity envelope (zero in-distribution).
        bound = torch.mean(torch.relu(members.abs() - 8.0) ** 2)
        total = (bpd + lambda_crps * crps + lambda_spec * spec
                 + lambda_disp * disp + bound)
        aux = {"bpd": bpd, "crps": crps, "spec": spec, "disp": disp, "bound": bound,
               "state": state}
        return total, aux

    return loss_fn


class FinetuneOptimizer:
    """The JAX package's fine-tune optax chain over (params, log_tau):
    ``clip_by_global_norm(grad_clip)`` over every gradient and
    log_tau's, then Adam (betas 0.9/0.999, eps 1e-8; no decay, no
    weight decay) with per-group learning rates: ``lr`` inside the
    scope, 0 outside it (its moments still accumulate, as in optax),
    ``lr * tau_lr_scale`` for log_tau (0 without ``learn_tau``).

    :meth:`step` takes the raw gradients (in :attr:`params` order, then
    log_tau's), clips them in place and returns the norm before the
    clip; it steps Adam only when ``apply`` is true."""

    def __init__(self, model: nn.Module, log_tau: torch.Tensor, lr: float, grad_clip: float,
                 learn_tau: bool, tau_lr_scale: float = 10.0,
                 scope_mask: dict[str, bool] | None = None):
        named = list(model.named_parameters())
        mask = scope_mask or {n: True for n, _ in named}
        self.params = [p for _, p in named]
        self.log_tau = log_tau
        self.grad_clip = grad_clip
        groups = [
            {"params": [p for n, p in named if mask[n]], "lr": lr},
            {"params": [p for n, p in named if not mask[n]], "lr": 0.0},
            {"params": [log_tau], "lr": lr * tau_lr_scale if learn_tau else 0.0},
        ]
        self.adam = torch.optim.Adam([g for g in groups if g["params"]],
                                     betas=(0.9, 0.999), eps=1e-8)

    def clip(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """Clip ``grads`` in place; the global norm before the clip."""
        return clip_by_global_norm_(grads, self.grad_clip)

    def apply(self, grads: list[torch.Tensor]) -> None:
        """One Adam step on clipped ``grads`` (params, then log_tau)."""
        for p, g in zip([*self.params, self.log_tau], grads):
            p.grad = g
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)


def _scope_mask(model: nn.Module, scope: str) -> dict[str, bool]:
    """Which parameters the fine-tune may move, by the port's parameter
    names (the JAX package's Flax paths joined by ".").

    "all": every parameter. "nets": all but the flow-arithmetic
    parameters (actnorm scale/bias, inv-1x1 LU factors), which are
    log-scale-like and exponentially sensitive through L x K flow steps.
    "priors": only the conditional-prior nets (split priors and the base
    prior): dispersion reallocation with the decode map frozen."""
    names = [n for n, _ in model.named_parameters()]
    if scope == "all":
        return {n: True for n in names}
    if scope == "nets":
        return {n: not any(k in ("actnorm", "invconv") for k in n.split("."))
                for n in names}
    if scope != "priors":
        raise ValueError(f"train_scope must be 'all', 'nets' or 'priors', got {scope!r}")
    return {n: any("prior" in k for k in n.split(".")) for n in names}


def make_finetune_optimizer(
    model: nn.Module, log_tau: torch.Tensor, lr: float, grad_clip: float, learn_tau: bool,
    tau_lr_scale: float = 10.0, scope_mask: dict[str, bool] | None = None,
) -> FinetuneOptimizer:
    """The fine-tune optimizer over ``model``'s parameters and the leaf
    ``log_tau``; ``scope_mask`` (see :func:`_scope_mask`; None = all)
    freezes everything outside the fine-tune scope."""
    return FinetuneOptimizer(model, log_tau, lr, grad_clip, learn_tau, tau_lr_scale,
                             scope_mask)


def make_finetune_trajectory_step(
    model: TMGlow,
    optimizer: FinetuneOptimizer,
    window: int,
    n_members: int,
    remat: bool = False,
) -> Callable:
    """Whole-trajectory fine-tune step, the semantics of the JAX
    package's: consecutive BPTT windows of a batch (B, T, ...), the state
    starting at zero and carrying its value (gradient cut) across
    windows, the trailing partial window dropped:

        step(lf_traj, hf_traj, spec_target, draws, lambda_crps,
             lambda_spec, lambda_disp) -> metrics

    updates ``model``'s parameters and ``optimizer.log_tau`` in place.
    ``spec_target`` (B, nbins-1) are the batch's converged log-spectrum
    targets; ``draws`` is a ``torch.Generator`` or, per window, the
    draws of :func:`window_draws`. A window whose loss or gradient norm
    is not finite is skipped (nothing changes). metrics: "loss", "bpd",
    "crps", "spec", "disp", "bound", "grad_norm" as means over finite
    windows, "skipped_windows" and "tau" (clipped), as tensors."""
    loss_fn = make_finetune_loss(model, n_members, remat=remat)
    log_tau = optimizer.log_tau
    wrt = [*optimizer.params, log_tau]

    def trajectory_step(lf_traj, hf_traj, spec_target, draws, lambda_crps, lambda_spec,
                        lambda_disp):
        b = lf_traj.shape[0]
        state = init_lstm_state(model.cfg, b, lf_traj.device)
        per_window, skipped = [], []
        wins = TrajectoryDataset.windows(lf_traj, hf_traj, window)
        for i, (lf_win, hf_win) in enumerate(wins):
            d = draws if isinstance(draws, torch.Generator) else draws[i]
            loss, aux = loss_fn(log_tau, lf_win, hf_win, spec_target, state, lambda_crps,
                                lambda_spec, lambda_disp, d)
            grads = list(torch.autograd.grad(loss, wrt, allow_unused=True,
                                             materialize_grads=True))
            gnorm = optimizer.clip(grads)
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))  # waits on the device
            if ok:
                optimizer.apply(grads)
            state = tuple((h.detach(), c.detach()) for h, c in aux["state"])
            per_window.append(torch.stack([loss.detach(), *(aux[k].detach() for k in _TERMS[1:-1]),
                                           gnorm]))
            skipped.append(0.0 if ok else 1.0)
        vals = torch.stack(per_window)  # (n_windows, len(_TERMS))
        skip = torch.tensor(skipped, device=vals.device)
        fin = 1.0 - skip
        n_fin = torch.clamp(fin.sum(), min=1.0)
        finite = torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))
        means = (finite * fin[:, None]).sum(dim=0) / n_fin
        metrics = dict(zip(_TERMS, means))
        metrics["skipped_windows"] = skip.sum()
        metrics["tau"] = clipped_tau(log_tau.detach())
        return metrics

    return trajectory_step
