"""Leaf loader for exported rollout artifacts: torch and the K2 operator only.

Counterpart of ``tpuflow/tools/artifact.py``. A serving host (``tools/serve.py``,
or any process that only wants to call the rollout) imports no model, data,
training or CLI module of the port: the artifact holds the whole rollout.

An artifact (``tools/export_rollout.py`` writes it) is a zip of three members:

  * ``encoder.pt2``: ``torch.export`` of the LF encoder over the whole
    trajectory, (T, h, w, C) -> the per-scale features (T, h_l, w_l, F);
  * ``step.pt2``: one rollout step, (features of step t, ConvLSTM state,
    that step's standard-normal draws, tau) -> (new state, mean, var), the
    ensemble's mean and variance (ddof 0) in physical units; the weights,
    the inverse 1x1 convs, the packed coupling nets and the HF
    normalization are baked in;
  * ``program.json``: the device and torch version it was exported on,
    the ensemble size, the per-scale shapes of the draws and the state,
    and ``use_pallas``, the coupling numerics the step computes (a record:
    the step holds them as constants of its K2 calls).

:class:`ServedRollout` holds the time loop: step t draws its eps from one
``torch.Generator(device).manual_seed(seed)``, scale by scale in the order
the Glow's reverse consumes them (the base prior's first), as
``eval.rollout.make_ensemble_rollout`` draws them. So the served stats equal
that rollout's on a generator seeded the same way, denormalized.

An exported program records the device of every constant, and a program
from one torch version need not load in another. So the loader refuses a
device type (or CUDA index) other than the one it was exported on, and a
torch major.minor other than the exporter's: export where you serve.
Registering the K2 operator before ``torch.export.load`` (importing
``tpuflow_torch.kernels.ops``) is what the JAX loader's LAPACK warm-up is
there.
"""

from __future__ import annotations

import io
import json
import pathlib
import zipfile

import torch

import tpuflow_torch.kernels.ops  # noqa: F401  (registers tpuflow_torch::fused_coupling)

ENCODER, STEP, PROGRAM = "encoder.pt2", "step.pt2", "program.json"


def torch_minor(version: str) -> str:
    """``"2.11.0+cu128"`` -> ``"2.11"``."""
    return ".".join(version.split("+")[0].split(".")[:2])


def write_artifact(path, encoder, step, program: dict) -> int:
    """Write the two exported programs and ``program`` to ``path``; returns
    the bytes written."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for name, ep in ((ENCODER, encoder), (STEP, step)):
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(name, buf.getvalue())
        z.writestr(PROGRAM, json.dumps(program, indent=2))
    return path.stat().st_size


class ServedRollout:
    """A loaded artifact: ``served(lf_traj, seed, tau)`` -> {"mean", "var"}.

    ``lf_traj`` (T, h, w, C) normalized, ``seed`` an int (uint32), ``tau``
    an (n_scales,) vector; arrays or tensors. Returns tensors (T, H, W, C)
    in physical units on the artifact's device. ``call`` is the same, the
    JAX artifact's name.
    """

    def __init__(self, encoder, step, program: dict, device: torch.device):
        self.encoder, self.step = encoder, step
        self.program, self.device = program, device
        self.latent_shapes = [tuple(s) for s in program["latent_shapes"]]
        self.state_shapes = [tuple(s) for s in program["state_shapes"]]

    def draws(self, generator: torch.Generator) -> list[torch.Tensor]:
        """One step's standard-normal draws, per scale, the base prior's
        (scale L-1) first."""
        out = [None] * len(self.latent_shapes)
        for l in reversed(range(len(out))):
            out[l] = torch.randn(self.latent_shapes[l], generator=generator, device=self.device)
        return out

    def __call__(self, lf_traj, seed, tau) -> dict[str, torch.Tensor]:
        dev = self.device
        lf = torch.as_tensor(lf_traj, dtype=torch.float32, device=dev)
        want = tuple(self.program["lf_input_shape"])
        if tuple(lf.shape) != want:
            raise ValueError(f"LF input shape {tuple(lf.shape)} != exported contract {want}")
        tau = torch.as_tensor(tau, dtype=torch.float32, device=dev).reshape(-1)
        if tau.shape != (len(self.latent_shapes),):
            raise ValueError(f"tau must have shape ({len(self.latent_shapes)},), "
                             f"got {tuple(tau.shape)}")
        gen = torch.Generator(dev).manual_seed(int(seed) % (1 << 32))
        with torch.inference_mode():
            feats = self.encoder(lf)
            state = tuple((torch.zeros(s, device=dev), torch.zeros(s, device=dev))
                          for s in self.state_shapes)
            means, variances = [], []
            for t in range(lf.shape[0]):
                state, mean, var = self.step([f[t:t + 1] for f in feats], state,
                                             self.draws(gen), tau)
                means.append(mean)
                variances.append(var)
            return {"mean": torch.stack(means), "var": torch.stack(variances)}

    call = __call__


def load_artifact(path, device: str | torch.device | None = None) -> ServedRollout:
    """Read an artifact, ready to call as ``served(lf, seed, tau)``.

    ``device`` defaults to the one it was exported on; another device type
    or CUDA index, or another torch major.minor than the exporter's, is
    refused by name.
    """
    with zipfile.ZipFile(path) as z:
        program = json.loads(z.read(PROGRAM))
        exported_on = torch.device(program["device"])
        dev = exported_on if device is None else torch.device(device)
        if dev.type == "cuda" == exported_on.type and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != exported_on:
            raise ValueError(
                f"{path}: the artifact was exported on {exported_on} and cannot serve on "
                f"{dev}: an exported program keeps the device of its constants. Export it "
                "on the device that serves.")
        if torch_minor(program["torch_version"]) != torch_minor(torch.__version__):
            raise RuntimeError(
                f"{path}: the artifact was exported with torch {program['torch_version']}; "
                f"this is torch {torch.__version__}. Export it with the torch that serves.")
        encoder, step = (torch.export.load(io.BytesIO(z.read(n))).module()
                         for n in (ENCODER, STEP))
    return ServedRollout(encoder, step, program, dev)
