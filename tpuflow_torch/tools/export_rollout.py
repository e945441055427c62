"""Export the ensemble rollout as a serving artifact.

Counterpart of ``tpuflow/tools/export_rollout.py``. ``torch.export`` turns
the rollout of a checkpoint into programs that a serving process runs
without the model code (``tools/artifact.py`` loads them, ``tools/serve.py``
serves them): the weights, the ensemble size and the HF normalization are
baked in, and K2 runs as the registered operator
``tpuflow_torch::fused_coupling`` (``kernels/ops.py``).

The JAX package exports the whole ``scan`` over time. ``torch.export``
would unroll the Python time loop into one node per launch of every step,
so the port exports two programs and the loader holds the loop:

  * the LF encoder over the whole trajectory, run once (as
    ``eval/rollout.py`` runs it);
  * one step (:class:`RolloutStep`): the features of step t, the ConvLSTM
    state, that step's standard-normal draws and the per-scale tau in; the
    new state and the ensemble's physical-unit mean and variance (ddof 0)
    out. Every inverse 1x1 conv and packed coupling net is computed once,
    here, and held as a buffer, as the JAX artifact closes over them. The
    step has no overflow redraw (its host check would wait on the device
    every step); the JAX artifact is built without it too.

The artifact serves on the device it was exported on, with the torch
version that exported it (the loader refuses others): export where you
serve.

Usage: python -m tpuflow_torch.tools.export_rollout <case> [key=value ...]
           [export_path=...] [--device cuda|cpu]
       (out file: {eval.output_dir}/{case}/rollout.torchexport, beside it
        the sidecar rollout.meta.json)

The sidecar holds the JAX exporter's keys with its values for the same
checkpoint (``platforms`` names the torch device) and ``torch_version``;
``spread_scale`` and ``interval_scales`` are carried over from the case's
``eval_metrics.json`` where the case has been evaluated.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch
from torch import nn

from tpuflow_torch.cli import as_console_script, parse_args, pop_tool_args
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import NormStats, load_dataset
from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.kernels.coupling_fused import PackedNet
from tpuflow_torch.models.tmglow import TMGlow, latent_shapes, scale_shapes
from tpuflow_torch.tools.artifact import write_artifact

PROG = "python -m tpuflow_torch.tools.export_rollout"
ARTIFACT = "rollout.torchexport"


class _Tensors(nn.Module):
    """Tensors held as buffers ``t0, t1, ...``, each a copy: a packed f32
    bias is the parameter's own storage, and ``torch.export`` would save
    it as that parameter, which loads requiring grad (the kernel's wrapper
    refuses such inputs)."""

    def __init__(self, tensors):
        super().__init__()
        for i, t in enumerate(tensors):
            self.register_buffer(f"t{i}", t.detach().clone(memory_format=torch.contiguous_format))
        self.n = len(tensors)

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f"t{i}") for i in range(self.n)]


class RolloutStep(nn.Module):
    """One ensemble rollout step of ``model`` with its inverse 1x1 convs and
    packed coupling nets hoisted into buffers, and the HF normalization of
    ``norm``: ``(feats, state, eps, tau) -> (state, mean, var)``.

    ``feats[l]`` is step t's batch-1 encoder feature of scale l, ``state``
    the ConvLSTM state of the N members, ``eps[l]`` the step's
    standard-normal draws of scale l, ``tau`` the (n_scales,) temperature.
    The mean and variance (ddof 0) over the members are in physical units.
    """

    def __init__(self, model: TMGlow, norm: NormStats):
        super().__init__()
        self.model = model
        self.inv = nn.ModuleList(_Tensors(row) for row in model.build_inv_caches())
        self.packs = nn.ModuleList(
            nn.ModuleList(_Tensors([n.win0, n.b0, n.bj0, *n.wjs]) for n in row)
            for row in model.glow.pack_couplings())
        dev = model.device
        self.register_buffer("hf_mean", torch.as_tensor(norm.hf_mean, device=dev))
        self.register_buffer("hf_std", torch.as_tensor(norm.hf_std, device=dev))
        self.register_buffer("hf_var", torch.as_tensor(norm.hf_std**2, device=dev))

    def forward(self, feats, state, eps, tau):
        packs = []
        for row in self.packs:
            packs.append([])
            for held in row:
                win0, b0, bj0, *wjs = held.tensors()
                packs[-1].append(PackedNet(win0, b0, tuple(wjs), bj0))
        x, state = self.model.sample_from_feats(
            feats, state, temperature=tau, eps=eps,
            inv_caches=[row.tensors() for row in self.inv], packs=packs)
        mean = x.mean(dim=0) * self.hf_std + self.hf_mean
        return state, mean, x.var(dim=0, correction=0) * self.hf_var


def build_exported(cfg: CaseConfig, model: TMGlow, norm: NormStats, n_samples: int | None = None):
    """``torch.export`` the LF encoder and :class:`RolloutStep` on the model's
    device for ``n_samples`` members (default ``cfg.eval.n_samples``) and
    ``cfg.eval.rollout_steps`` steps; returns (encoder program, step
    program, the artifact's ``program.json`` dict)."""
    mc, dev = cfg.model, model.device
    n = cfg.eval.n_samples if n_samples is None else n_samples
    if n < 2:
        raise ValueError(f"the served rollout reports ensemble stats: needs >= 2 members, got {n}")
    lf = torch.zeros(cfg.eval.rollout_steps, *mc.lf_shape, mc.channels, device=dev)
    state_shapes = [(n, h, w, mc.lstm_hidden) for h, w in scale_shapes(mc)]
    with torch.no_grad():
        encoder = torch.export.export(model.encoder, (lf,), strict=False)
        feats = [f[:1] for f in model.encoder(lf)]
        state = tuple((torch.zeros(s, device=dev), torch.zeros(s, device=dev))
                      for s in state_shapes)
        eps = [torch.zeros(s, device=dev) for s in latent_shapes(mc, n)]
        tau = torch.zeros(mc.n_scales, device=dev)
        step = torch.export.export(RolloutStep(model, norm), (feats, state, eps, tau),
                                   strict=False)
    # torch.export.save would store the example inputs too: the members'
    # state and draws, three times the weights' bytes at 64 members.
    encoder.example_inputs = step.example_inputs = None
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    program = {
        "device": str(dev),
        "torch_version": torch.__version__,
        "n_samples": n,
        "lf_input_shape": list(lf.shape),
        "latent_shapes": [list(s) for s in latent_shapes(mc, n)],
        "state_shapes": [list(s) for s in state_shapes],
    }
    return encoder, step, program


def sidecar(cfg: CaseConfig, norm: NormStats, temperature, program: dict) -> dict:
    """The ``rollout.meta.json`` of the JAX exporter, for the port."""
    L = cfg.model.n_scales
    default = ([float(t) for t in temperature.tolist()] if isinstance(temperature, torch.Tensor)
               else [float(temperature)] * L)
    meta = {
        "case": cfg.name,
        "rollout_steps": cfg.eval.rollout_steps,
        "n_samples": program["n_samples"],
        "default_temperature": default,
        "n_scales": L,
        "lf_input_shape": program["lf_input_shape"],
        "platforms": [program["device"]],
        "lf_mean": [float(v) for v in norm.lf_mean],
        "lf_std": [float(v) for v in norm.lf_std],
        "outputs": "physical-unit ensemble mean/var per step",
        "torch_version": program["torch_version"],
    }
    metrics_path = pathlib.Path(cfg.eval.output_dir) / cfg.name / "eval_metrics.json"
    if metrics_path.exists():
        m = json.loads(metrics_path.read_text())
        if "spread_scale" in m:
            meta["spread_scale"] = float(m["spread_scale"])
        if "interval_scales" in m:
            meta["interval_scales"] = {k: float(v) for k, v in m["interval_scales"].items()}
    return meta


def main(argv: list[str] | None = None) -> pathlib.Path:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_override = pop_tool_args(argv, {"export_path": ""})["export_path"]
    cfg, device = parse_args(argv, prog=PROG)
    model, norm, meta = load_eval_bundle(cfg, device=device)
    # The checkpoint's normalization constants; the train split's without one.
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    temperature = resolve_temperature(cfg, meta, device=model.device)
    encoder, step, program = build_exported(cfg, model, ds.norm)
    out = (pathlib.Path(out_override) if out_override
           else pathlib.Path(cfg.eval.output_dir) / cfg.name / ARTIFACT)
    nbytes = write_artifact(out, encoder, step, program)
    meta_path = out.with_suffix(".meta.json")
    meta_path.write_text(json.dumps(sidecar(cfg, ds.norm, temperature, program), indent=2) + "\n")
    print(f"exported {cfg.eval.rollout_steps}-step {program['n_samples']}-member rollout for "
          f"{program['device']} (torch {program['torch_version']}) -> {out} "
          f"({nbytes / 1e6:.1f} MB; sidecar {meta_path.name})")
    return out


cli = as_console_script(main)

if __name__ == "__main__":
    main()
