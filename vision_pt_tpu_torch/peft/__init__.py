"""Parameter-efficient fine-tuning: LoRA and LoHa adapters (port of
``vision_pt_tpu/peft``)."""

from .config import LoHaConfig, LoRAConfig, PeftConfigMixin, PeftTargetConfig, RegexMatch
from .functional import (
    AdapterParam,
    PeftLayer,
    adapter_parameters,
    calculate_trainable_parameters,
    detect_peft_method,
    freeze_all_but_adapters,
    get_adapter_parameters,
    load_peft_weight,
    print_trainable_parameters,
    replace_to_peft_layer,
    retype_to_adapter_params,
    set_peft_layer_enabled,
    while_peft_disabled,
    while_peft_enabled,
)
from .loha import LoHaLinear
from .lora import LoRALinear

__all__ = [
    "AdapterParam",
    "LoRAConfig",
    "LoHaConfig",
    "LoHaLinear",
    "LoRALinear",
    "PeftConfigMixin",
    "PeftLayer",
    "PeftTargetConfig",
    "RegexMatch",
    "adapter_parameters",
    "calculate_trainable_parameters",
    "detect_peft_method",
    "freeze_all_but_adapters",
    "get_adapter_parameters",
    "load_peft_weight",
    "print_trainable_parameters",
    "replace_to_peft_layer",
    "retype_to_adapter_params",
    "set_peft_layer_enabled",
    "while_peft_disabled",
    "while_peft_enabled",
]
