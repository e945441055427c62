"""Autoregressive ensemble rollout, and the held-out NLL.

Counterpart of ``make_ensemble_rollout``, ``make_batched_ensemble_rollout``
and ``make_nll_eval`` in ``tpuflow/eval/rollout.py``. The rollout: for one
LF trajectory, N ensemble members with their own ConvLSTM states and
latent draws at temperature tau step autoregressively over T timesteps.
The batched rollout runs B trajectories x N members as one batch of B*N.
The time loop is a Python loop; three things are hoisted out of it, as in
the JAX package:

  * the LF encoder runs once for the whole trajectory (T, or T*B, as the
    batch);
  * every inv-1x1 W^{-1} is computed once;
  * every coupling net's weights are packed once, in the kernel's layout
    (net-dtype kernels, float32 biases, as the JAX package's fused path
    keeps them).

Overflow redraw (``overflow_redraw=True``, off by default as in the JAX
package): members whose field is not finite are redrawn once at 0.6 tau
from the same state and features (the recurrent state never consumes x,
so a redraw is a fresh draw from the same conditional), the redraw is
cleaned with ``nan_to_num(..., 0)``, and only the failed members are
replaced. The check reads a flag on the host, so it waits on the device
once per step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state, latent_shapes

Draws = Sequence[torch.Tensor]  # one step's standard-normal draws, per scale
_REDRAW_TAU = 0.6


def _check_collect(collect: str, n_samples: int) -> None:
    if collect not in ("stats", "fields"):
        raise ValueError(f"collect must be 'stats' or 'fields', got {collect!r}")
    if collect == "stats" and n_samples < 2:
        raise ValueError(
            f"stats-mode rollout needs >= 2 ensemble members (got {n_samples}); "
            "use collect='fields' for single samples"
        )


def _redraw_failed(model, x, feats_t, state_in, temperature, draw, hoisted):
    """x with every member that is not finite everywhere replaced by a
    redraw at 0.6 tau from ``state_in``, non-finite values of the redraw
    set to 0. Reading the flag waits on the device."""
    finite = torch.isfinite(x).flatten(1).all(dim=1)
    if bool(finite.all()):
        return x
    x2, _ = model.sample_from_feats(feats_t, state_in, temperature=temperature * _REDRAW_TAU,
                                    **draw, **hoisted)
    x2 = torch.nan_to_num(x2, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(finite.view(-1, 1, 1, 1), x, x2)


def _loop(model: TMGlow, feats, n_traj, n_samples, temperature, collect, overflow_redraw,
          draw: Callable[[int], dict], redraw: Callable[[int], dict]):
    """The time loop over per-scale features (T, n_traj, h, w, F); step t
    draws with ``draw(t)`` (and redraws with ``redraw(t)``), the
    ``generator``/``eps`` arguments of ``sample_from_feats``. Returns
    fields (T, n_traj, N, H, W, C) or stats (T, 2, n_traj, H, W, C)."""
    state = init_lstm_state(model.cfg, n_traj * n_samples, model.device)
    hoisted = dict(inv_caches=model.build_inv_caches(), packs=model.glow.pack_couplings())
    outs = []
    for t in range(feats[0].shape[0]):
        # A batch-1 feature broadcasts against the members' states.
        feats_t = [f[t] if n_traj == 1 else f[t].repeat_interleave(n_samples, dim=0)
                   for f in feats]
        state_in = state
        x, state = model.sample_from_feats(feats_t, state, temperature=temperature,
                                           **draw(t), **hoisted)
        if overflow_redraw:
            x = _redraw_failed(model, x, feats_t, state_in, temperature, redraw(t), hoisted)
        x = x.view(n_traj, n_samples, *x.shape[1:])
        if collect == "fields":
            outs.append(x)
        else:
            outs.append(torch.stack([x.mean(dim=1), x.var(dim=1, correction=0)]))
    return torch.stack(outs)


def make_ensemble_rollout(
    model: TMGlow,
    n_samples: int,
    temperature: float = 1.0,
    collect: str = "stats",
    overflow_redraw: bool = False,
) -> Callable:
    """Build ``rollout(lf_traj, generator=None, temperature=..., eps=None,
    redraw_eps=None)`` for ONE LF trajectory on the model's device.

    ``lf_traj`` is (T, h, w, C) normalised LF input; ``temperature`` is a
    runtime scalar or per-scale vector. ``eps`` hands in the latent
    draws instead of the generator (parity tests): ``eps[t][l]`` is the
    standard-normal draw of step t, scale l, shaped like that scale's
    prior mean; ``redraw_eps[t][l]`` likewise for the overflow redraw's
    draws at step t (else the redraw draws from ``generator``).

    Returns, by ``collect``:
      "stats":  {"mean", "var"} each (T, H, W, C), variance over the
                members with ddof 0;
      "fields": (T, N, H, W, C) every member's field.
    """
    _check_collect(collect, n_samples)

    @torch.no_grad()
    def rollout(
        lf_traj: torch.Tensor,
        generator: torch.Generator | None = None,
        temperature=temperature,
        eps: Sequence[Draws] | None = None,
        redraw_eps: Sequence[Draws] | None = None,
    ):
        if lf_traj.device != model.device:
            raise ValueError(f"lf_traj on {lf_traj.device}, model on {model.device}")
        for name, e in (("eps", eps), ("redraw_eps", redraw_eps)):
            if e is not None and len(e) != lf_traj.shape[0]:
                raise ValueError(f"{name} has {len(e)} steps, lf_traj {lf_traj.shape[0]}")
        feats = [f[:, None] for f in model.encode_lf(lf_traj)]
        ys = _loop(
            model, feats, 1, n_samples, temperature, collect, overflow_redraw,
            lambda t: dict(generator=generator, eps=None if eps is None else eps[t]),
            lambda t: dict(generator=generator,
                           eps=None if redraw_eps is None else redraw_eps[t]),
        )
        if collect == "fields":
            return ys[:, 0]
        return {"mean": ys[:, 0, 0], "var": ys[:, 1, 0]}

    return rollout


def make_batched_ensemble_rollout(
    model: TMGlow,
    n_samples: int,
    temperature: float = 1.0,
    collect: str = "stats",
    overflow_redraw: bool = False,
) -> Callable:
    """Build ``rollout(lf_trajs, generators=None, temperature=..., eps=None,
    redraw_eps=None)`` for a batch of B LF trajectories on the model's
    device: B trajectories x N members step as one batch of B*N (the LF
    encoder runs once on T*B frames, the features repeat per member, the
    ConvLSTM state and the fused coupling run at B*N).

    ``lf_trajs`` is (B, T, h, w, C). Each trajectory takes its own draws:
    ``generators[b]`` (drawn in the order a single-trajectory rollout
    draws, so trajectory b's draws equal those of
    ``make_ensemble_rollout`` with that generator, up to any overflow
    redraw, which draws for every trajectory), or ``eps[b][t][l]``
    (and ``redraw_eps[b][t][l]``) as :func:`make_ensemble_rollout` takes
    them. With neither, the batch draws from torch's default generator.

    Returns the single-trajectory outputs stacked per trajectory: "stats"
    -> {"mean", "var"} each (B, T, H, W, C); "fields" -> (B, T, N, H, W, C).
    """
    _check_collect(collect, n_samples)
    cfg = model.cfg

    def per_traj(b, t, generators, eps):
        """Step t's draws of the whole batch, trajectory by trajectory."""
        if eps is not None:
            rows = [eps[i][t] for i in range(b)]
        else:
            shapes = latent_shapes(cfg, n_samples)
            rows = []
            for g in generators:
                row = [None] * cfg.n_scales
                for l in reversed(range(cfg.n_scales)):  # the base prior draws first
                    row[l] = torch.randn(shapes[l], generator=g, device=model.device)
                rows.append(row)
        return [rows[0][l] if b == 1 else torch.cat([r[l] for r in rows])
                for l in range(cfg.n_scales)]

    @torch.no_grad()
    def rollout(
        lf_trajs: torch.Tensor,
        generators: Sequence[torch.Generator] | None = None,
        temperature=temperature,
        eps: Sequence[Sequence[Draws]] | None = None,
        redraw_eps: Sequence[Sequence[Draws]] | None = None,
    ):
        if lf_trajs.device != model.device:
            raise ValueError(f"lf_trajs on {lf_trajs.device}, model on {model.device}")
        if lf_trajs.dim() != 5:
            raise ValueError(f"lf_trajs must be (B, T, h, w, C), got {tuple(lf_trajs.shape)}")
        b, steps = lf_trajs.shape[:2]
        if generators is not None and len(generators) != b:
            raise ValueError(f"{len(generators)} generators for {b} trajectories")
        for name, e in (("eps", eps), ("redraw_eps", redraw_eps)):
            if e is not None and (len(e) != b or any(len(et) != steps for et in e)):
                raise ValueError(f"{name} must hold {steps} steps for each of {b} trajectories")

        def draws(e):
            if e is None and generators is None:
                return lambda t: {}
            return lambda t: dict(eps=per_traj(b, t, generators, e))

        frames = lf_trajs.transpose(0, 1).reshape(steps * b, *lf_trajs.shape[2:])
        feats = [f.view(steps, b, *f.shape[1:]) for f in model.encode_lf(frames)]
        ys = _loop(model, feats, b, n_samples, temperature, collect, overflow_redraw,
                   draws(eps), draws(redraw_eps))
        if collect == "fields":
            return ys.transpose(0, 1)
        return {"mean": ys[:, 0].transpose(0, 1), "var": ys[:, 1].transpose(0, 1)}

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
