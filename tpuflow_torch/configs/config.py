"""Typed configuration: the port's own copy of the model, data, training
and rollout settings, read from per-case YAML presets with dotted
overrides.

Counterpart of ``tpuflow/configs/config.py`` (``ModelConfig``, the
fields of ``DataConfig`` and ``TrainConfig`` that the trainer reads,
``EvalConfig``, ``FinetuneConfig``, ``load_case``). The port keeps its
own copy so that it imports nothing of the JAX package.

``conv_layout`` and ``flow_layout`` are accepted for parity with the JAX
package's configs, but select nothing: the port always computes the NHWC
semantics. ``use_pallas`` selects the coupling's numerics, as it selects
the path in the JAX package: false (the presets' setting and JAX's
default) computes the XLA path's, every bf16 conv output and sum rounded
to bf16; true computes the fused coupling's, f32 sums. Either way the
port runs its fused coupling (the CUDA kernel on a GPU, its plain version
on the CPU); see ``kernels/coupling_fused.py``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import typing
from dataclasses import dataclass, field
from typing import Any

import yaml

_CASES_DIR = pathlib.Path(__file__).parent / "cases"


@dataclass(frozen=True)
class ModelConfig:
    """TM-Glow architecture hyperparameters (arXiv:2006.04731 §3)."""

    # Multi-scale Glow structure: L scales, K steps of flow per scale.
    n_scales: int = 3
    n_flow_steps: int = 8
    # HF field channels (u, v, p).
    channels: int = 3
    # HF grid (H, W); must be divisible by 2**n_scales.
    hf_shape: tuple[int, int] = (64, 128)
    # LF grid (H, W).
    lf_shape: tuple[int, int] = (16, 32)
    coupling_width: int = 64
    coupling_layers: int = 3
    growth_rate: int = 32
    encoder_width: int = 32
    lstm_hidden: int = 32
    cond_channels: int = 32
    # Dtype of the networks' convolutions; the flow arithmetic itself is
    # always float32.
    compute_dtype: str = "bfloat16"
    # TPU layouts of the JAX package; accepted, same function (see the
    # module docstring).
    conv_layout: str = "hwnc"
    flow_layout: str = "nhwc"
    # The coupling's numerics: the JAX default path's (false) or its fused
    # coupling's (true); see the module docstring.
    use_pallas: bool = False
    # Clip standard-normal latent draws at ±z_clip (0 = off).
    z_clip: float = 4.0

    def validate(self) -> None:
        h, w = self.hf_shape
        div = 2 ** self.n_scales
        if h % div or w % div:
            raise ValueError(
                f"hf_shape {self.hf_shape} must be divisible by 2^{self.n_scales}"
            )
        for name in ("conv_layout", "flow_layout"):
            if getattr(self, name) not in ("hwnc", "nhwc"):
                raise ValueError(
                    f"{name} must be 'hwnc' or 'nhwc', got {getattr(self, name)!r}"
                )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}"
            )


@dataclass(frozen=True)
class DataConfig:
    """Dataset location and windowing: the fields of the JAX package's
    ``DataConfig`` that the trainer reads, with its defaults."""

    data_dir: str = "./datasets"
    case: str = "backward-step"
    # Truncated-BPTT window length (timesteps per gradient segment).
    window: int = 8
    # Timesteps loaded per trajectory.
    train_steps: int = 64
    n_train_traj: int = 32
    n_test_traj: int = 4
    batch_size: int = 8
    # Procedural fixture (data/synthetic.py) instead of an archive.
    synthetic: bool = True
    fixture_version: int = 3
    # Keep the whole training split on the device and gather batches
    # there by index, when it fits device_resident_max_gb.
    # Training-split loading: "ram" loads the whole archive; "stream"
    # serves trajectory batches from {case}_train.tpf through the native
    # loader (data/tpf.py), with the normalization fused into the gather
    # and the next batch prefetched (host RAM O(batch)).
    loader: str = "ram"
    device_resident: bool = True
    device_resident_max_gb: float = 4.0
    seed: int = 0
    # Physical domain extents (x, y) of the structured grid; both cases
    # use a 4x1 domain. They set the grid spacings of the evaluator's
    # vorticity and divergence and the wavenumbers of its spectra.
    domain_x: float = 4.0
    domain_y: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's ``TrainConfig`` that the trainer
    reads, with its defaults."""

    epochs: int = 100
    lr: float = 5e-4
    # Continuous decay: lr * lr_decay ** (step / 100).
    lr_decay: float = 0.995
    weight_decay: float = 0.0
    grad_clip: float = 100.0
    # Recompute each timestep's activations in the backward pass
    # (torch.utils.checkpoint) instead of keeping the whole window's:
    # memory of one timestep for a second forward. Off by default, as in
    # the JAX presets.
    remat: bool = False
    # Accepted for parity with the JAX package's configs and inert, as
    # model.conv_layout is: the port always runs every window of a
    # trajectory batch in order (train/step.trajectory_train_step).
    fused_windows: bool = True
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every: int = 10
    # Save a sample-vs-target figure every N epochs (0 = off); needs
    # matplotlib.
    plot_every: int = 0
    # Held-out NLL every N epochs into val_log.csv (0 = off).
    eval_every: int = 0
    # Log a metrics row every N global steps (0 = off).
    log_every: int = 10
    seed: int = 42
    # Process mesh of a torchrun launch: data x ensemble processes
    # (train/mesh.py); -1 on data means world // mesh_ensemble. Ranks
    # sharing a data index train on the same rows.
    mesh_data: int = -1
    mesh_ensemble: int = 1
    # Raise FloatingPointError at the first module whose output is not
    # finite (forward hooks), with autograd's anomaly mode for the
    # backward. Each check waits on the device.
    debug_nans: bool = False
    # torch.profiler trace directory of the epoch loop ("" = off).
    trace_dir: str = ""
    # TensorBoard scalar-summary directory ("" = CSV/stdout only).
    tensorboard_dir: str = ""


@dataclass(frozen=True)
class EvalConfig:
    """The JAX package's ``EvalConfig``, with its defaults."""

    n_samples: int = 64
    rollout_steps: int = 100
    temperature: float = 0.85
    # Per-scale sampling temperatures "t0,t1,t2" (scale 0 = the finest
    # split). "" = use the scalar `temperature`, unless the checkpoint
    # carries a fine-tuned "learned_tau" in its meta
    # (eval/loading.resolve_temperature priority: this override >
    # learned_tau > scalar).
    temperature_scales: str = ""
    output_dir: str = "./eval_out"
    # torch.profiler trace directory for the rollout CLI's timed run and
    # the evaluator's batched rollout ("" = off).
    trace_dir: str = ""
    # Exact-calibration horizon: a fields-mode rollout of this many steps
    # per test trajectory feeds the evaluator's ensemble CRPS, interval
    # coverage, spectra and calibration fits (0 = skip; memory is
    # O(T*N*H*W*C)).
    calibration_steps: int = 32
    # Post-hoc UQ spread inflation: rollout stats report
    # var * spread_scale**2; 1.0 = raw ensemble dispersion.
    spread_scale: float = 1.0
    # Per-location inflation field: path to an (H, W, C) .npy of factors.
    # When set, deployed variance surfaces use var * field**2 (overrides
    # the scalar). "" = off.
    spread_field: str = ""
    # Member-level overflow recovery in rollouts (eval/rollout.py):
    # redraw failed ensemble members once at 0.6x temperature, then
    # zero-fill. The check waits on the device every step, so default off.
    overflow_redraw: bool = False
    # Reference horizon of the evaluator's variance-derived statistics
    # (TKE, Reynolds stress, fluctuation PDFs) on synthetic data: when
    # above the rollout horizon, the generator extends each test
    # trajectory to this many steps and the references use the converged
    # temporal statistics. 0 = the rollout horizon. Ignored for archives.
    ref_steps: int = 0
    # Trajectories per batched rollout in the evaluator: bounds peak
    # activation memory at traj_batch * n_samples members.
    traj_batch: int = 4
    # Evaluating with no checkpoint is an error by default: a typo'd
    # checkpoint_dir would otherwise silently evaluate an untrained
    # model. Set true only for explicit untrained smoke rollouts.
    allow_untrained: bool = False


@dataclass(frozen=True)
class FinetuneConfig:
    """Sample-path fine-tuning knobs (train/finetune.py): dispersion and
    spectral-shape objectives evaluated on generative draws, starting
    from a converged NLL checkpoint. The JAX package's fields and
    defaults."""

    epochs: int = 8
    # Generative draws per trajectory per timestep (folded into the
    # batch axis of one reverse pass: TMGlow.nll_and_sample_step).
    n_members: int = 6
    # Trajectories per fine-tune batch (smaller than training: the
    # sample branch multiplies the effective batch by n_members).
    batch_size: int = 4
    # Fair-ensemble-CRPS weight (dispersion in the loop; 0 = off).
    lambda_crps: float = 0.0
    # Member-fluctuation log-spectrum MSE weight (0 = off).
    lambda_spec: float = 0.0
    # Spread-skill (variance-matching) weight: per-pixel log-MSE of the
    # fair ensemble variance against the squared ensemble-mean error
    # (0 = off).
    lambda_disp: float = 0.0
    lr: float = 1e-4
    grad_clip: float = 1000.0
    # Optimize a per-scale log sampling temperature jointly with the
    # parameters; deployed through checkpoint meta "learned_tau".
    learn_tau: bool = True
    # Which parameters may move: "all"; "nets" (all but the actnorm and
    # inv-1x1 flow-arithmetic parameters, which are exponentially
    # sensitive); or "priors" (only the conditional-prior nets: the
    # decode map frozen). See train/finetune._scope_mask.
    train_scope: str = "all"
    remat: bool = False
    # Source checkpoint directory ("" = train.checkpoint_dir). The
    # fine-tuned checkpoint saves to checkpoint_dir ("" = source +
    # "_ft"), never overwriting the source run.
    source_dir: str = ""
    checkpoint_dir: str = ""
    seed: int = 7
    # Overflow guard: an epoch is healthy iff its skipped-window fraction
    # is <= max_skipped_frac and its bpd has not risen more than
    # max_bpd_rise above the best healthy bpd. Healthy epochs snapshot
    # the parameters to the host; the saved checkpoint is the last
    # healthy snapshot. With early_stop, two consecutive unhealthy epochs
    # (or a rise of twice max_bpd_rise) end the run.
    max_skipped_frac: float = 0.4
    max_bpd_rise: float = 0.5
    early_stop: bool = True


@dataclass(frozen=True)
class CaseConfig:
    name: str = "backward-step"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    finetune: FinetuneConfig = field(default_factory=FinetuneConfig)

    def validate(self) -> None:
        self.model.validate()


def _from_dict(cls, d: dict[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(
            f"unknown {cls.__name__} keys {sorted(unknown)}; "
            f"valid keys: {sorted(known)}"
        )
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _apply_overrides(cfg: CaseConfig, overrides: dict[str, Any]) -> CaseConfig:
    """Apply dotted-path overrides, e.g. {"model.n_scales": 2}."""
    d = dataclasses.asdict(cfg)
    for key, val in overrides.items():
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                raise KeyError(f"unknown config key: {key}")
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        old = node[parts[-1]]
        if isinstance(old, bool):
            if not isinstance(val, bool):
                s = str(val).lower()
                if s in ("1", "true", "yes", "on"):
                    val = True
                elif s in ("0", "false", "no", "off"):
                    val = False
                else:
                    raise ValueError(
                        f"boolean override {key}={val!r} not understood "
                        "(use true/false)"
                    )
        elif isinstance(old, int):
            val = int(val)
        elif isinstance(old, float):
            val = float(val)
        elif isinstance(old, (tuple, list)):
            if isinstance(val, str):
                val = tuple(int(x) for x in val.strip("()[] ").split(","))
            else:
                val = tuple(val)
        node[parts[-1]] = val
    return _from_dict(CaseConfig, d)


def case_names() -> list[str]:
    return sorted(p.stem for p in _CASES_DIR.glob("*.yaml"))


def load_case(name_or_path: str, overrides: dict[str, Any] | None = None) -> CaseConfig:
    """Load a case preset YAML (by name or path) with optional dotted
    overrides."""
    path = pathlib.Path(name_or_path)
    if not path.exists():
        path = _CASES_DIR / f"{name_or_path}.yaml"
    if not path.exists():
        raise FileNotFoundError(
            f"no case config {name_or_path!r}; known cases: {case_names()}"
        )
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = _from_dict(CaseConfig, raw)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    cfg.validate()
    return cfg


def parse_cli_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse ``key=value`` CLI arguments into an override dict."""
    out: dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        out[k] = v
    return out
