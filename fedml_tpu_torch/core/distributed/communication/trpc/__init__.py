from .trpc_comm_manager import TRPCCommManager

__all__ = ["TRPCCommManager"]
