"""Configuration schema for the framework.

Port of portfoliooptgp_tpu/config.py, field for field, so a RunConfig JSON
file serves both packages and `print-config` prints the same text. The
reference hard-codes every knob in `__main__` blocks (reference:
GPR/main.py:88-118, Multi-Input_GPR/main.py:482-528); here they live in
dataclasses that serialize to and from JSON. `DTypePolicy.dtype` is a
torch dtype.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class DTypePolicy:
    """Precision policy.

    `parity` mirrors the reference's float64-end-to-end behavior
    (reference: GPR/data_handler.py:63-64); `fast` uses float32 compute with
    float32 accumulation, the path of the CUDA kernels.
    """

    mode: str = "parity"  # "parity" (f64) | "fast" (f32)

    @property
    def dtype(self):
        import torch

        return torch.float64 if self.mode == "parity" else torch.float32


@dataclass
class DataConfig:
    """Data-layer knobs (reference: Multi-Input_GPR/utils/data_handler.py)."""

    train_start_date: str = "2024-02-10"
    train_end_date: str = "2024-05-10"
    test_start_date: str = "2024-05-13"
    test_end_date: str = "2024-05-17"
    predict_y: str = "return"  # 'return' | 'daily_log_return' | 'close' | 'intraday_return'
    window_size: int = 3  # sliding-window denoise width (utils/data_handler.py:38-49)
    denoise: bool = False
    gaussian_filter: bool = False  # sigma=1 smoothing (utils/data_handler.py:102-103)
    data_root: str = "."  # directory containing Stocks/ Commodities/ trees


@dataclass
class TrainConfig:
    """Hyperparameter-MLE training knobs (reference:
    Multi-Input_GPR/models/model_trainer.py:17-72, GPR/model_trainer.py:10-26)."""

    maxiter: int = 100  # L-BFGS budget (GPR/model_trainer.py:19)
    noise_variance: float = 1e-5  # frozen likelihood var (GPR/model_trainer.py:16)
    train_likelihood: bool = False  # isFixedLikelihood=False path
    restart_noise_inits: Sequence[float] = (1e-5, 1e-3, 1e-1, 1.0)  # model_trainer.py:26
    lbfgs_memory: int = 10
    gtol: float = 1e-8
    ftol: float = 1e-12


@dataclass
class PortfolioConfig:
    """Portfolio knobs (reference: Multi-Input_GPR/main.py:482-528)."""

    risk_free_rate: float = 0.01 / 252
    max_volatility: float = 0.02
    min_return: float = 0.001
    prob_threshold: float = 0.5
    lambda_l1: float = 0.01
    lambda_l2: float = 0.0
    broker_fee: float = 0.00001
    tx_penalty: bool = True
    correlation_threshold: float = 0.30  # covariate gating (main.py:547)
    removal_percentage: float = 0.1
    is_log_return: bool = False
    mc_samples: int = 10_000  # dynamic-strategy MC budget (Strategies/dynamic_strategy.py:24)


@dataclass
class MeshConfig:
    """Device-mesh layout for scale-out (net-new vs reference — the reference
    is a single CPU process with no parallelism)."""

    data_axis: int = 1  # shards over minibatch / observation axis (SVGP ELBO)
    restart_axis: int = 1  # shards the batched-restart axis
    axis_names: Sequence[str] = ("data", "restart")


@dataclass
class RunConfig:
    dtype: DTypePolicy = field(default_factory=DTypePolicy)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    portfolio: PortfolioConfig = field(default_factory=PortfolioConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw = json.loads(text)
        return cls(
            dtype=DTypePolicy(**raw.get("dtype", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            portfolio=PortfolioConfig(**raw.get("portfolio", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            seed=raw.get("seed", 0),
        )


def load(path: str) -> RunConfig:
    with open(path) as f:
        return RunConfig.from_json(f.read())
