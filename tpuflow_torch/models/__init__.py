from tpuflow_torch.models.conv_lstm import ConvLSTMCell
from tpuflow_torch.models.glow import GlowStep, MultiScaleGlow
from tpuflow_torch.models.lf_encoder import LFEncoder
from tpuflow_torch.models.tmglow import (
    TMGlow,
    init_lstm_state,
    latent_shapes,
    perturb_,
    scale_shapes,
)

__all__ = [
    "ConvLSTMCell",
    "GlowStep",
    "LFEncoder",
    "MultiScaleGlow",
    "TMGlow",
    "init_lstm_state",
    "latent_shapes",
    "perturb_",
    "scale_shapes",
]
