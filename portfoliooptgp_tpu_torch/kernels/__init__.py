"""Kernels and mean functions."""

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.kernels.base import (
    Constant,
    Kernel,
    Product,
    Sum,
    White,
    normalize_active_dims,
)
from portfoliooptgp_tpu_torch.kernels.linear import Linear, Polynomial
from portfoliooptgp_tpu_torch.kernels.means import (
    ConstantMean,
    LinearMean,
    MeanFunction,
    PolynomialMean,
    Zero,
)
from portfoliooptgp_tpu_torch.kernels.periodic import Periodic
from portfoliooptgp_tpu_torch.kernels.stationary import (
    Exponential,
    Matern12,
    Matern32,
    Matern52,
    RationalQuadratic,
    SquaredExponential,
    Stationary,
)


def default_kernel_menu(*, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """The reference's 8-kernel selection menu (GPR/main.py:105-114), fresh
    parameters on every call, in the JAX package's order."""
    o = dict(device=device, dtype=dtype)
    SE, M12, RQ = SquaredExponential, Matern12, RationalQuadratic
    return [
        SE.create(**o),
        M12.create(**o),
        RQ.create(**o),
        Exponential.create(**o),
        SE.create(**o) + M12.create(**o),
        Exponential.create(**o) + Periodic.create(SE.create(**o), **o) + Linear.create(**o),
        Exponential.create(**o) + Periodic.create(SE.create(**o), **o),
        SE.create(**o) * M12.create(**o),
    ]


def composite_kernel(input_dim, kernel1_cls=Exponential, kernel2_cls=Exponential,
                     *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """Feature-kernel × time-kernel composite over column slices: k1 acts
    on columns [0, D-1) (covariates), k2 on column D-1 (time)."""
    k1 = kernel1_cls.create(active_dims=slice(0, input_dim - 1),
                            device=device, dtype=dtype)
    k2 = kernel2_cls.create(active_dims=slice(input_dim - 1, input_dim),
                            device=device, dtype=dtype)
    return k1 * k2


__all__ = [
    "Kernel", "Sum", "Product", "SquaredExponential", "Matern12", "Matern32",
    "Matern52", "Exponential", "RationalQuadratic", "Periodic", "Linear",
    "Polynomial", "Stationary", "MeanFunction", "Zero", "ConstantMean",
    "LinearMean", "PolynomialMean", "default_kernel_menu", "composite_kernel",
    "normalize_active_dims", "Constant", "White",
]
