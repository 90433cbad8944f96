"""SDXL adapters of the port: the rectified-flow conversion."""

from .flow_match import SDXLFlowMatch, SDXLFlowMatchConfig

__all__ = ["SDXLFlowMatch", "SDXLFlowMatchConfig"]
