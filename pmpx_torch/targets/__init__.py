from pmpx_torch.targets.analytic import Banana, Gaussian1D, StandardMVN
from pmpx_torch.targets.linreg import (
    BayesLinReg,
    make_synthetic_linreg,
    pad_to_grid,
)
from pmpx_torch.targets.nn import NNPosterior

__all__ = [
    "Banana",
    "BayesLinReg",
    "Gaussian1D",
    "NNPosterior",
    "StandardMVN",
    "make_synthetic_linreg",
    "pad_to_grid",
]
