"""Pipelines: the multi-input walk-forward and the single-asset
multi-timescale pipeline."""

from portfoliooptgp_tpu_torch.pipelines.multi_input import MultiInputGPR
from portfoliooptgp_tpu_torch.pipelines.single_asset import StockPredictor
from portfoliooptgp_tpu_torch.pipelines.walk_forward import batched_walk_forward

__all__ = ["MultiInputGPR", "StockPredictor", "batched_walk_forward"]
