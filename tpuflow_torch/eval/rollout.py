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

Each step's standard-normal draws are made for the whole batch before
the step, in the order the Glow's reverse consumes them (the base
prior's first), from the caller's generator, torch's default one, or
the caller's ``eps``.

Devices (``mesh=``, a ``train.mesh.Mesh`` of devices): the members of a
rollout split into contiguous chunks, one per mesh device, as the JAX
package shards the member axis over both mesh axes; the batched rollout
splits its trajectories over the data axis (each chunk on the first
device of its data row). Each device runs its chunk on a replica of the
model, loaded from its state dict when the rollout is made. A step's
draws are made in the flat order on the first device and scattered to
the chunks, and the fields are gathered there for the statistics, so a
split rollout equals the flat one on the same generator. One host thread
launches every chunk in turn: the step is host-bound (hundreds of
launches), and Python threads would contend for the interpreter lock on
that same launch work.

Overflow redraw (``overflow_redraw=True``, off by default as in the JAX
package): members whose field is not finite are redrawn once at 0.6 tau
from the same state and features (the recurrent state never consumes x,
so a redraw is a fresh draw from the same conditional), the redraw is
cleaned with ``nan_to_num(..., 0)``, and only the failed members are
replaced. The redraw's draws are made for the whole batch, in the flat
order, and only the chunks holding a failed member run it. The check
reads a flag on the host, so it waits on the device once per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state, latent_shapes

Draws = Sequence[torch.Tensor]  # one step's standard-normal draws, per scale
_REDRAW_TAU = 0.6


@dataclass(frozen=True)
class _Chunk:
    """A model (the caller's or a replica on another device) and the rows
    of the flat (trajectory, member) batch it steps."""

    model: TMGlow
    rows: slice


def _check_collect(collect: str, n_samples: int) -> None:
    if collect not in ("stats", "fields"):
        raise ValueError(f"collect must be 'stats' or 'fields', got {collect!r}")
    if collect == "stats" and n_samples < 2:
        raise ValueError(
            f"stats-mode rollout needs >= 2 ensemble members (got {n_samples}); "
            "use collect='fields' for single samples"
        )


def _replicas(model: TMGlow, devices) -> list[TMGlow]:
    """One model per entry of ``devices``: ``model`` itself for the first
    entry where it already lives, else a replica loaded with its state
    dict."""
    out = []
    for i, d in enumerate(devices):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if i == 0 and d == model.device:
            out.append(model)
            continue
        replica = TMGlow(model.cfg, device=d)
        replica.load_state_dict(model.state_dict())
        out.append(replica)
    return out


def _standard_normal(cfg, rows: int, generator, device) -> list[torch.Tensor]:
    """One step's draws for ``rows`` members, per scale, drawn in the order
    the Glow's reverse draws them (the base prior, scale L-1, first)."""
    shapes = latent_shapes(cfg, rows)
    out = [None] * cfg.n_scales
    for l in reversed(range(cfg.n_scales)):
        out[l] = torch.randn(shapes[l], generator=generator, device=device)
    return out


def _on(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _loop(chunks: Sequence[_Chunk], feats, n_traj, n_samples, temperature, collect,
          overflow_redraw, draw: Callable[[int], Draws], redraw: Callable[[int], Draws]):
    """The time loop over per-scale features (T, n_traj, h, w, F) on the
    first chunk's device; step t takes the draws ``draw(t)`` (the redraw
    ``redraw(t)``) of the flat batch. Returns fields (T, n_traj, N, H, W, C)
    or stats (T, 2, n_traj, H, W, C) on the first chunk's device."""
    dev0 = chunks[0].model.device
    parts = []
    for c in chunks:
        dev, rows = c.model.device, c.rows
        trajs = slice(0, 1) if n_traj == 1 else slice(rows.start // n_samples,
                                                       rows.stop // n_samples)
        parts.append(dict(
            chunk=c, dev=dev, temperature=_on(temperature, dev),
            feats=[f[:, trajs].to(dev) for f in feats],
            state=init_lstm_state(c.model.cfg, rows.stop - rows.start, dev),
            hoisted=dict(inv_caches=c.model.build_inv_caches(),
                         packs=c.model.glow.pack_couplings()),
        ))

    def sample(p, feats_t, state, temperature, eps):
        return p["chunk"].model.sample_from_feats(
            feats_t, state, temperature=temperature,
            eps=[e[p["chunk"].rows].to(p["dev"]) for e in eps], **p["hoisted"])

    outs = []
    for t in range(feats[0].shape[0]):
        eps = draw(t)
        xs, states_in, feats_ts = [], [], []
        for p in parts:
            # A batch-1 feature broadcasts against the members' states.
            feats_t = [f[t] if n_traj == 1 else f[t].repeat_interleave(n_samples, dim=0)
                       for f in p["feats"]]
            states_in.append(p["state"])
            feats_ts.append(feats_t)
            x, p["state"] = sample(p, feats_t, p["state"], p["temperature"], eps)
            xs.append(x)
        if overflow_redraw:
            finite = torch.cat([torch.isfinite(x).flatten(1).all(dim=1).cpu() for x in xs])
            if not bool(finite.all()):
                eps2 = redraw(t)
                for i, p in enumerate(parts):
                    ok = finite[p["chunk"].rows]
                    if bool(ok.all()):
                        continue
                    x2, _ = sample(p, feats_ts[i], states_in[i],
                                   p["temperature"] * _REDRAW_TAU, eps2)
                    x2 = torch.nan_to_num(x2, nan=0.0, posinf=0.0, neginf=0.0)
                    xs[i] = torch.where(ok.to(p["dev"]).view(-1, 1, 1, 1), xs[i], x2)
        x = xs[0] if len(xs) == 1 else torch.cat([x.to(dev0) for x in xs])
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
    mesh=None,
) -> Callable:
    """Build ``rollout(lf_traj, generator=None, temperature=..., eps=None,
    redraw_eps=None)`` for ONE LF trajectory on the model's device.

    ``lf_traj`` is (T, h, w, C) normalised LF input; ``temperature`` is a
    runtime scalar or per-scale vector. ``eps`` hands in the latent
    draws instead of the generator (parity tests): ``eps[t][l]`` is the
    standard-normal draw of step t, scale l, shaped like that scale's
    prior mean; ``redraw_eps[t][l]`` likewise for the overflow redraw's
    draws at step t (else the redraw draws from ``generator``).

    ``mesh`` (a ``train.mesh.Mesh`` of devices, the model's first) splits
    the members into one contiguous chunk per mesh device; ``n_samples``
    must divide by the mesh's size. The results equal the flat rollout's
    on the same generator or ``eps``.

    Returns, by ``collect``, on the model's device:
      "stats":  {"mean", "var"} each (T, H, W, C), variance over the
                members with ddof 0;
      "fields": (T, N, H, W, C) every member's field.
    """
    _check_collect(collect, n_samples)
    if mesh is None:
        chunks = [_Chunk(model, slice(0, n_samples))]
    else:
        from tpuflow_torch.train.mesh import ensemble_sharding

        rows = ensemble_sharding(mesh, n_samples)
        chunks = [_Chunk(m, r) for m, r in zip(_replicas(model, mesh.devices), rows)]

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

        def draws(e):
            if e is not None:
                return lambda t: e[t]
            return lambda t: _standard_normal(model.cfg, n_samples, generator, model.device)

        feats = [f[:, None] for f in model.encode_lf(lf_traj)]
        ys = _loop(chunks, feats, 1, n_samples, temperature, collect, overflow_redraw,
                   draws(eps), draws(redraw_eps))
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
    mesh=None,
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

    ``mesh`` (a ``train.mesh.Mesh`` of devices) splits the trajectories
    over its data axis, B / mesh.data on the first device of each data
    row; B must divide.

    Returns the single-trajectory outputs stacked per trajectory: "stats"
    -> {"mean", "var"} each (B, T, H, W, C); "fields" -> (B, T, N, H, W, C).
    """
    _check_collect(collect, n_samples)
    cfg = model.cfg
    if mesh is None:
        models = [model]
    else:
        models = _replicas(model, [mesh.devices[i * mesh.ensemble] for i in range(mesh.data)])

    def per_traj(b, t, generators, eps):
        """Step t's draws of the whole batch, trajectory by trajectory."""
        if eps is not None:
            rows = [eps[i][t] for i in range(b)]
        else:
            rows = [_standard_normal(cfg, n_samples, g, model.device) for g in generators]
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
        if b % len(models):
            raise ValueError(f"{b} trajectories do not split over a data axis of {len(models)}")
        per = b // len(models) * n_samples
        chunks = [_Chunk(m, slice(i * per, (i + 1) * per)) for i, m in enumerate(models)]

        def draws(e):
            if e is None and generators is None:
                return lambda t: _standard_normal(cfg, b * n_samples, None, model.device)
            return lambda t: per_traj(b, t, generators, e)

        frames = lf_trajs.transpose(0, 1).reshape(steps * b, *lf_trajs.shape[2:])
        feats = [f.view(steps, b, *f.shape[1:]) for f in model.encode_lf(frames)]
        ys = _loop(chunks, feats, b, n_samples, temperature, collect, overflow_redraw,
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
