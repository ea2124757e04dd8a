from .circuits import MulChainCircuit

__all__ = ["MulChainCircuit"]
