"""SDXL adapters of the port: the rectified-flow conversion, IP-Adapter and
PFG."""

from .flow_match import SDXLFlowMatch, SDXLFlowMatchConfig
from .ip_adapter import SDXLModelWithIPAdapter, SDXLModelWithIPAdapterConfig
from .prompt_free import SDXLModelWithPFG, SDXLModelWithPFGConfig

__all__ = ["SDXLFlowMatch", "SDXLFlowMatchConfig", "SDXLModelWithIPAdapter",
           "SDXLModelWithIPAdapterConfig", "SDXLModelWithPFG", "SDXLModelWithPFGConfig"]
