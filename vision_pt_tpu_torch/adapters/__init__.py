"""Image adapters of the port: the adapter framework, IP-Adapter and PFG."""

from .util import Adapter, AdapterManager

__all__ = ["Adapter", "AdapterManager"]
