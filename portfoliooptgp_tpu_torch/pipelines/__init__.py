"""Pipelines: the multi-input walk-forward, the single-asset
multi-timescale pipeline and the config-5 frontier pipeline."""

from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import (
    FrontierResult,
    run_frontier_pipeline,
)
from portfoliooptgp_tpu_torch.pipelines.multi_input import MultiInputGPR
from portfoliooptgp_tpu_torch.pipelines.single_asset import StockPredictor
from portfoliooptgp_tpu_torch.pipelines.walk_forward import batched_walk_forward

__all__ = ["FrontierResult", "MultiInputGPR", "StockPredictor", "batched_walk_forward",
           "run_frontier_pipeline"]
