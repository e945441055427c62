from tpuflow_torch.flows.actnorm import ActNorm
from tpuflow_torch.flows.coupling import AffineCoupling, DenseBlockNet
from tpuflow_torch.flows.inv1x1 import InvConv1x1LU, compute_w_inv
from tpuflow_torch.flows.prior import gaussian_logp, gaussian_sample
from tpuflow_torch.flows.split import ConditionalPrior, ConditionalSplit
from tpuflow_torch.flows.squeeze import squeeze2d, unsqueeze2d

__all__ = [
    "ActNorm",
    "AffineCoupling",
    "ConditionalPrior",
    "ConditionalSplit",
    "DenseBlockNet",
    "InvConv1x1LU",
    "compute_w_inv",
    "gaussian_logp",
    "gaussian_sample",
    "squeeze2d",
    "unsqueeze2d",
]
