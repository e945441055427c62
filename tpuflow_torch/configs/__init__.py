from tpuflow_torch.configs.config import (
    CaseConfig,
    EvalConfig,
    ModelConfig,
    case_names,
    load_case,
)

__all__ = ["CaseConfig", "EvalConfig", "ModelConfig", "case_names", "load_case"]
