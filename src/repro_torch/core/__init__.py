from repro_torch.core.nestedfp import (
    NestedTensor, encode, decode, fp8_view, fp8_dequant,
    is_applicable, is_applicable_values, split_stats,
    FP8_DEQUANT_SCALE, NESTED_SCALE_LOG2, E4M3_MAX,
)
from repro_torch.core.linear import NestedLinearParams, nested_linear, nest_weight_tree
from repro_torch.core.policy import DualPrecisionController, SLOConfig, StepObservation
