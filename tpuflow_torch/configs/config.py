"""Typed configuration: the port's own copy of the model, data, training
and rollout settings, read from per-case YAML presets with dotted
overrides.

Counterpart of ``tpuflow/configs/config.py`` (``ModelConfig``, the
fields of ``DataConfig`` and ``TrainConfig`` that the trainer reads, the
rollout fields of ``EvalConfig``, ``load_case``). The port keeps its own
copy so that it imports nothing of the JAX package.

``conv_layout``, ``flow_layout`` and ``use_pallas`` are accepted for
parity with the JAX package's configs, but select nothing: the port
always computes the NHWC semantics and always runs the fused coupling
(the CUDA kernel on a GPU, its plain version on the CPU).
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
    # TPU layout and kernel choices of the JAX package; accepted, same
    # function (see the module docstring).
    conv_layout: str = "hwnc"
    flow_layout: str = "nhwc"
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
    device_resident: bool = True
    device_resident_max_gb: float = 4.0
    seed: int = 0


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
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every: int = 10
    # Held-out NLL every N epochs into val_log.csv (0 = off).
    eval_every: int = 0
    # Log a metrics row every N global steps (0 = off).
    log_every: int = 10
    seed: int = 42


@dataclass(frozen=True)
class EvalConfig:
    """The rollout fields of the JAX package's ``EvalConfig``."""

    n_samples: int = 64
    rollout_steps: int = 100
    temperature: float = 0.85


@dataclass(frozen=True)
class CaseConfig:
    name: str = "backward-step"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

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
