from tpuflow_torch.configs.config import (
    CaseConfig,
    DataConfig,
    EvalConfig,
    FinetuneConfig,
    ModelConfig,
    TrainConfig,
    case_names,
    load_case,
    parse_cli_overrides,
)

__all__ = [
    "CaseConfig",
    "DataConfig",
    "EvalConfig",
    "FinetuneConfig",
    "ModelConfig",
    "TrainConfig",
    "case_names",
    "load_case",
    "parse_cli_overrides",
]
