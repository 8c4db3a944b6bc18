from .base import AlgoOperator, TableSourceOp

__all__ = ["AlgoOperator", "TableSourceOp"]
