"""SDXL adapters of the port: the rectified-flow conversion, IP-Adapter,
PFG, the RoPE retrofit and the style tokenizer."""

from .flow_match import SDXLFlowMatch, SDXLFlowMatchConfig
from .ip_adapter import SDXLModelWithIPAdapter, SDXLModelWithIPAdapterConfig
from .prompt_free import SDXLModelWithPFG, SDXLModelWithPFGConfig
from .rope import SDXLWithRoPEConfig, SDXLWithRoPEModel, while_rope_disabled, while_rope_enabled
from .style_tokenizer import SDXLModelWithStyleTokenizer, SDXLModelWithStyleTokenizerConfig

__all__ = ["SDXLFlowMatch", "SDXLFlowMatchConfig", "SDXLModelWithIPAdapter",
           "SDXLModelWithIPAdapterConfig", "SDXLModelWithPFG", "SDXLModelWithPFGConfig",
           "SDXLModelWithStyleTokenizer", "SDXLModelWithStyleTokenizerConfig",
           "SDXLWithRoPEConfig", "SDXLWithRoPEModel", "while_rope_disabled",
           "while_rope_enabled"]
