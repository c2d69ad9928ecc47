"""Headless matplotlib visualization (reference plotting surface)."""

from portfoliooptgp_tpu_torch.viz.visualizer import Visualizer, setup_plot_style
