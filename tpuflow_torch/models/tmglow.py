"""TM-Glow: transient multi-fidelity conditional Glow surrogate.

Counterpart of ``tpuflow/models/tmglow.py``: LF encoder (feature
pyramid) -> per-scale ConvLSTM -> conditioning features (a sum of two
1x1 convs of the encoder feature and the LSTM hidden state) ->
multi-scale Glow. The model exposes single-timestep functions (the NLL
step of training, encode / reconstruct, sampling); the time loops live in
``tpuflow_torch/train/step.py`` and ``tpuflow_torch/eval/rollout.py``.

Parameter names follow the JAX package's Flax paths (``encoder``,
``lstm{l}``, ``cond_projf{l}``, ``cond_projh{l}``, ``glow``), so
``tpuflow_torch.convert.from_flax`` maps a checkpoint one leaf to one
tensor.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpuflow_torch.configs.config import ModelConfig
from tpuflow_torch.device import resolve_device
from tpuflow_torch.flows.actnorm import ActNorm
from tpuflow_torch.flows.layout import LayoutConv, lecun_normal_
from tpuflow_torch.models.conv_lstm import ConvLSTMCell
from tpuflow_torch.models.glow import MultiScaleGlow
from tpuflow_torch.models.lf_encoder import LFEncoder

LSTMState = tuple[tuple[torch.Tensor, torch.Tensor], ...]  # per scale (h, c)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LN2 = math.log(2.0)


def scale_shapes(cfg: ModelConfig) -> list[tuple[int, int]]:
    """Spatial resolution of Glow scale l (after l+1 squeezes)."""
    h, w = cfg.hf_shape
    return [(h >> (l + 1), w >> (l + 1)) for l in range(cfg.n_scales)]


def latent_shapes(cfg: ModelConfig, batch: int) -> list[tuple[int, ...]]:
    """Shape of scale l's standard-normal draw in a reverse pass: the
    factored-out half at a split, the whole remaining latent at the base
    prior (scale L-1)."""
    shapes, c = [], cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c *= 4
        if l < cfg.n_scales - 1:
            c //= 2
        shapes.append((batch, h, w, c))
    return shapes


def init_lstm_state(
    cfg: ModelConfig, batch: int, device: torch.device | str
) -> LSTMState:
    """Zero ConvLSTM state, (batch, H_l, W_l, hidden) f32 per scale."""
    return tuple(
        (
            torch.zeros(batch, sh, sw, cfg.lstm_hidden, device=device),
            torch.zeros(batch, sh, sw, cfg.lstm_hidden, device=device),
        )
        for sh, sw in scale_shapes(cfg)
    )


def perturb_(model: nn.Module, seed: int, scale: float = 0.004) -> None:
    """Seeded noise on every parameter, so the zero-init coupling heads
    and priors of a random init compute something. The scale is kept
    small: an untrained reverse coupling stack amplifies its input, and
    at full width noise of 0.01 already overflows a 64-member rollout
    to inf (measured on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((scale * torch.randn(p.shape, generator=gen)).to(p.device))


class TMGlow(nn.Module):
    """Single-timestep TM-Glow on ``device`` (default ``"cuda"``; raises
    where there is no GPU unless ``device="cpu"`` is given).

    ``seed`` makes a random initialisation in the JAX package's scheme
    (``lecun_normal`` kernels, zero biases, zero coupling heads and prior
    convs, random-rotation inv-1x1); :meth:`data_init` then initialises
    the ActNorms from a real batch, as ``model.init`` does in the JAX
    package. Load trained weights with
    ``load_state_dict(convert.from_flax(...))``.

    Calling the model runs :meth:`nll_step`, as the JAX package's
    ``__call__`` does.
    """

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        cfg.validate()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        gen = torch.Generator().manual_seed(seed)
        shapes = scale_shapes(cfg)
        self.encoder = LFEncoder(
            cfg.channels, shapes, width=cfg.encoder_width, dtype=self.dtype
        )
        for l in range(cfg.n_scales):
            self.add_module(
                f"lstm{l}",
                ConvLSTMCell(cfg.encoder_width, cfg.lstm_hidden, dtype=self.dtype),
            )
            self.add_module(
                f"cond_projf{l}",
                LayoutConv(cfg.encoder_width, cfg.cond_channels, 1, dtype=self.dtype),
            )
            self.add_module(
                f"cond_projh{l}",
                LayoutConv(cfg.lstm_hidden, cfg.cond_channels, 1, use_bias=False,
                           dtype=self.dtype),
            )
        # Kernels of the encoder, LSTM and projections: lecun_normal;
        # the Glow initialises its own (zero heads and priors).
        for m in list(self.modules()):
            if isinstance(m, LayoutConv):
                lecun_normal_(m.weight, gen)
        self.glow = MultiScaleGlow(
            n_scales=cfg.n_scales,
            n_steps=cfg.n_flow_steps,
            in_channels=cfg.channels,
            cond_channels=cfg.cond_channels,
            width=cfg.coupling_width,
            layers=cfg.coupling_layers,
            growth_rate=cfg.growth_rate,
            dtype=self.dtype,
            use_pallas=cfg.use_pallas,
            z_clip=cfg.z_clip,
            generator=gen,
        )
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def build_inv_caches(self) -> list[list[torch.Tensor]]:
        """Every inv-1x1 W^{-1}, [scale][step]: time-invariant, so a
        rollout computes them once instead of per step."""
        return [[self.glow.step(l, k).invconv.w_inv() for k in range(self.cfg.n_flow_steps)]
                for l in range(self.cfg.n_scales)]

    def encode_lf(self, lf: torch.Tensor) -> list[torch.Tensor]:
        """LF frame(s) (T, h, w, C) -> encoder pyramid, T as the batch:
        the encoder is member-independent, so a rollout runs it once per
        trajectory."""
        return self.encoder(lf)

    def condition(
        self, feats: list[torch.Tensor], state: LSTMState
    ) -> tuple[list[torch.Tensor], LSTMState]:
        """Per scale: ConvLSTM update on the encoder feature, then the
        conditioning cond = projf(f) + projh(h)."""
        conds, new_state = [], []
        for l in range(self.cfg.n_scales):
            f = feats[l]
            if f.dim() == 3:
                f = f[None]  # batch-1: broadcasts against the members
            h, s = getattr(self, f"lstm{l}")(f, state[l])
            cond = getattr(self, f"cond_projf{l}")(f) + getattr(self, f"cond_projh{l}")(h)
            conds.append(cond)
            new_state.append(s)
        return conds, tuple(new_state)

    def _condition_lf(self, lf_t: torch.Tensor, state: LSTMState):
        return self.condition(self.encoder(lf_t), state)

    def forward(self, hf_t: torch.Tensor, lf_t: torch.Tensor, state: LSTMState):
        return self.nll_step(hf_t, lf_t, state)

    def nll_step(
        self, hf_t: torch.Tensor, lf_t: torch.Tensor, state: LSTMState
    ) -> tuple[torch.Tensor, LSTMState]:
        """Forward (normalizing) direction: per-example NLL in bits/dim,
        bpd = -(logp + logdet) / (H*W*C*ln 2), the training objective.
        hf_t (B, H, W, C), lf_t (B, h, w, C); returns (bpd (B,), state)."""
        dims = hf_t.shape[-3] * hf_t.shape[-2] * hf_t.shape[-1]
        conds, state = self._condition_lf(lf_t, state)
        _, logdet, logp = self.glow(hf_t, conds)
        return -(logp + logdet) / (dims * _LN2), state

    def sample_step(
        self,
        lf_t: torch.Tensor,
        state: LSTMState,
        temperature=1.0,
        *,
        generator: torch.Generator | None = None,
        eps: list[torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, LSTMState]:
        """Reverse (generative) direction: one autoregressive HF draw from
        (lf_t (N, h, w, C), state) at ``temperature``. ``eps[l]`` hands in
        scale l's standard-normal draws. Returns (x (N, H, W, C), state)."""
        conds, state = self._condition_lf(lf_t, state)
        x, _ = self.glow.reverse(conds, temperature=temperature, generator=generator, eps=eps)
        return x, state

    def nll_and_sample_step(
        self,
        hf_t: torch.Tensor,
        lf_t: torch.Tensor,
        state: LSTMState,
        temperature=1.0,
        n_members: int = 4,
        *,
        generator: torch.Generator | None = None,
        eps: list[torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, LSTMState]:
        """One timestep of both directions under one conditioning pass:
        the teacher-forced NLL and ``n_members`` draws per example (the
        conditioning repeated member-consecutively along the batch).
        ``eps[l]`` hands in scale l's standard-normal draws, shaped
        (B*n_members, ...). Returns (bpd (B,), members (B, n_members, H,
        W, C), state)."""
        dims = hf_t.shape[-3] * hf_t.shape[-2] * hf_t.shape[-1]
        conds, state = self._condition_lf(lf_t, state)
        _, logdet, logp = self.glow(hf_t, conds)
        bpd = -(logp + logdet) / (dims * _LN2)
        conds_m = [c.repeat_interleave(n_members, dim=0) for c in conds]
        x_m, _ = self.glow.reverse(
            conds_m, temperature=temperature, generator=generator, eps=eps
        )
        return bpd, x_m.reshape(hf_t.shape[0], n_members, *x_m.shape[1:]), state

    def encode_step(self, hf_t: torch.Tensor, lf_t: torch.Tensor, state: LSTMState):
        """x -> (latents, logdet, logp, state)."""
        conds, state = self._condition_lf(lf_t, state)
        latents, logdet, logp = self.glow(hf_t, conds)
        return latents, logdet, logp, state

    def reconstruct_step(self, latents, lf_t: torch.Tensor, state: LSTMState):
        """latents -> (x, state): with the (lf_t, state) given to
        :meth:`encode_step`, the exact inverse."""
        conds, state = self._condition_lf(lf_t, state)
        x, _ = self.glow.reverse(conds, latents=latents)
        return x, state

    def data_init(self, hf_t: torch.Tensor, lf_t: torch.Tensor, state: LSTMState) -> None:
        """Initialise every ActNorm from one forward on a real batch, each
        from its own input in order (the counterpart of the JAX package's
        ``model.init`` on the first batch)."""
        actnorms = [m for m in self.modules() if isinstance(m, ActNorm)]
        for m in actnorms:
            m.init_pending = True
        with torch.no_grad():
            self.nll_step(hf_t, lf_t, state)
        missed = [m for m in actnorms if m.init_pending]
        if missed:
            raise RuntimeError(f"data_init: {len(missed)} ActNorm layers saw no input")

    def sample_from_feats(
        self,
        feats: list[torch.Tensor],
        state: LSTMState,
        *,
        temperature=1.0,
        generator: torch.Generator | None = None,
        eps: list[torch.Tensor] | None = None,
        inv_caches=None,
        packs=None,
    ) -> tuple[torch.Tensor, LSTMState]:
        """Ensemble-batched sample step from precomputed encoder features
        (unbatched (h_l, w_l, F) or batch-1); the state carries the
        member axis N. Returns x (N, H, W, C) and the new state.
        ``eps`` hands in the per-scale standard-normal draws."""
        conds, new_state = self.condition(feats, state)
        x, _ = self.glow.reverse(
            conds, temperature=temperature, generator=generator, eps=eps,
            inv_caches=inv_caches, packs=packs,
        )
        return x, new_state
