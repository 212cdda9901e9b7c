from repro_torch.data.pipeline import DataState, TokenPipeline

__all__ = ["DataState", "TokenPipeline"]
