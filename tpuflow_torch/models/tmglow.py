"""TM-Glow: transient multi-fidelity conditional Glow surrogate.

Counterpart of ``tpuflow/models/tmglow.py``: LF encoder (feature
pyramid) -> per-scale ConvLSTM -> conditioning features (a sum of two
1x1 convs of the encoder feature and the LSTM hidden state) ->
multi-scale Glow. The model exposes single-timestep functions; the time
loop lives in ``tpuflow_torch/eval/rollout.py``.

Parameter names follow the JAX package's Flax paths (``encoder``,
``lstm{l}``, ``cond_projf{l}``, ``cond_projh{l}``, ``glow``), so
``tpuflow_torch.convert.from_flax`` maps a checkpoint one leaf to one
tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuflow_torch.configs.config import ModelConfig
from tpuflow_torch.device import resolve_device
from tpuflow_torch.flows.layout import LayoutConv, lecun_normal_
from tpuflow_torch.models.conv_lstm import ConvLSTMCell
from tpuflow_torch.models.glow import MultiScaleGlow
from tpuflow_torch.models.lf_encoder import LFEncoder

LSTMState = tuple[tuple[torch.Tensor, torch.Tensor], ...]  # per scale (h, c)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def scale_shapes(cfg: ModelConfig) -> list[tuple[int, int]]:
    """Spatial resolution of Glow scale l (after l+1 squeezes)."""
    h, w = cfg.hf_shape
    return [(h >> (l + 1), w >> (l + 1)) for l in range(cfg.n_scales)]


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


class TMGlow(nn.Module):
    """Single-timestep TM-Glow on ``device`` (default ``"cuda"``; raises
    where there is no GPU unless ``device="cpu"`` is given).

    ``seed`` makes a random initialisation in the JAX package's scheme
    (``lecun_normal`` kernels, zero biases, zero coupling heads and prior
    convs, random-rotation inv-1x1); load trained weights with
    ``load_state_dict(convert.from_flax(...))``.
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
            z_clip=cfg.z_clip,
            generator=gen,
        )
        self.to(dev)
        # Serving only so far: the CUDA coupling kernel has no backward yet.
        self.requires_grad_(False)

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
