from pmpx_torch.targets.analytic import Banana, Gaussian1D, StandardMVN
from pmpx_torch.targets.linreg import (
    BayesLinReg,
    make_synthetic_linreg,
    pad_to_grid,
)

__all__ = [
    "Banana",
    "BayesLinReg",
    "Gaussian1D",
    "StandardMVN",
    "make_synthetic_linreg",
    "pad_to_grid",
]
