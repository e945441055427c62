"""Autoregressive ensemble rollout, and the held-out NLL.

Counterpart of ``make_ensemble_rollout`` and ``make_nll_eval`` in
``tpuflow/eval/rollout.py``. The rollout:
for one LF trajectory, N ensemble members with their own ConvLSTM states
and latent draws at temperature tau step autoregressively over T
timesteps. The time loop is a Python loop; three things are hoisted out
of it, as in the JAX package:

  * the LF encoder runs once for the whole trajectory (T as the batch);
  * every inv-1x1 W^{-1} is computed once;
  * every coupling net's weights are packed once, in the kernel's layout
    (net-dtype kernels, float32 biases, as the JAX package's fused path
    keeps them).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state


def make_ensemble_rollout(
    model: TMGlow,
    n_samples: int,
    temperature: float = 1.0,
    collect: str = "stats",
) -> Callable:
    """Build ``rollout(lf_traj, generator=None, temperature=..., eps=None)``
    for ONE LF trajectory on the model's device.

    ``lf_traj`` is (T, h, w, C) normalised LF input; ``temperature`` is a
    runtime scalar or per-scale vector. ``eps`` hands in the latent
    draws instead of the generator (parity tests): ``eps[t][l]`` is the
    standard-normal draw of step t, scale l, shaped like that scale's
    prior mean.

    Returns, by ``collect``:
      "stats":  {"mean", "var"} each (T, H, W, C), variance over the
                members with ddof 0;
      "fields": (T, N, H, W, C) every member's field.
    """
    if collect not in ("stats", "fields"):
        raise ValueError(f"collect must be 'stats' or 'fields', got {collect!r}")
    if collect == "stats" and n_samples < 2:
        raise ValueError(
            f"stats-mode rollout needs >= 2 ensemble members (got {n_samples}); "
            "use collect='fields' for single samples"
        )
    cfg = model.cfg

    @torch.no_grad()
    def rollout(
        lf_traj: torch.Tensor,
        generator: torch.Generator | None = None,
        temperature=temperature,
        eps: Sequence[Sequence[torch.Tensor]] | None = None,
    ):
        dev = model.device
        if lf_traj.device != dev:
            raise ValueError(f"lf_traj on {lf_traj.device}, model on {dev}")
        if eps is not None and len(eps) != lf_traj.shape[0]:
            raise ValueError(f"eps has {len(eps)} steps, lf_traj {lf_traj.shape[0]}")
        state = init_lstm_state(cfg, n_samples, dev)
        inv_caches = model.build_inv_caches()
        packs = model.glow.pack_couplings()
        feats_traj = model.encode_lf(lf_traj)
        outs = []
        for t in range(lf_traj.shape[0]):
            x, state = model.sample_from_feats(
                [f[t] for f in feats_traj], state,
                temperature=temperature, generator=generator,
                eps=None if eps is None else eps[t],
                inv_caches=inv_caches, packs=packs,
            )
            if collect == "fields":
                outs.append(x)
            else:
                outs.append(torch.stack([x.mean(dim=0), x.var(dim=0, correction=0)]))
        ys = torch.stack(outs)
        if collect == "fields":
            return ys
        return {"mean": ys[:, 0], "var": ys[:, 1]}

    return rollout


def make_nll_eval(model: TMGlow) -> Callable:
    """Build ``nll(lf_traj, hf_traj) -> (T, B)`` bits/dim for a batch of
    held-out trajectories (B, T, ...) on the model's device: the teacher-
    forced NLL step over time from a zero ConvLSTM state, without
    gradients."""
    cfg = model.cfg

    @torch.no_grad()
    def nll(lf_traj: torch.Tensor, hf_traj: torch.Tensor) -> torch.Tensor:
        state = init_lstm_state(cfg, lf_traj.shape[0], lf_traj.device)
        bpds = []
        for t in range(lf_traj.shape[1]):
            bpd, state = model.nll_step(hf_traj[:, t], lf_traj[:, t], state)
            bpds.append(bpd)
        return torch.stack(bpds)

    return nll
