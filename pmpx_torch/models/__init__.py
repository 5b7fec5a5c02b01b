"""Model zoo: the port's counterparts of ``pmpx.models``.

| Model      | Reference definition | In the port |
|------------|----------------------|-------------|
| MnistMLP   | 28^2-512-256-128-10 FC net, ``complex_nets/Mnist/FC/PMP_FC.py:21-36`` | yes |
| MnistCNN   | 2-conv CNN, ``complex_nets/Mnist/CNN/PMP_CNN.py:23-44`` | yes |
| MnistLSTM  | LSTM(28->64) + Linear(10), ``complex_nets/Mnist/LSTM/PMP_LSTM.py:22-43`` | yes |
| LeNet      | CIFAR-10 LeNet w/ BatchNorm, ``complex_nets/Cifar-10/cifar_PMPhmc.py:33-55`` | yes |
| BayesMLP   | torchbnn BayesLinear 784-1024-10 mean-field net, ``Bayesian Network Training/main.py:173-177`` | yes |
| PackedLeNet, PackedMnistCNN | channel-packed layouts (``pmpx/models/packed.py``) | yes |
| GraniteHybridLM | granite-4.0-h-micro's Mamba-2/attention stack, ``ibm-granite/granite-4.0-h-micro`` config.json; no counterpart in ``pmpx`` | port only |

Each model is an ``nn.Module`` whose state-dict keys are flax's parameter
paths joined by dots, and whose ``flax_layout()`` lists (path, shape,
initialiser) in ``pmpx``'s flat-theta order.  ``GraniteHybridLM`` has no
flax tree to follow: its leaves are the published model's modules in
order, each kernel (in, out).
"""

from pmpx_torch.models.bnn import BayesMLP
from pmpx_torch.models.cnn import MnistCNN
from pmpx_torch.models.granite_hybrid import GraniteHybridLM
from pmpx_torch.models.lenet import LeNet
from pmpx_torch.models.lstm import MnistLSTM
from pmpx_torch.models.mlp import MnistMLP
from pmpx_torch.models.packed import PackedLeNet, PackedMnistCNN

__all__ = ["MnistMLP", "MnistCNN", "MnistLSTM", "LeNet", "BayesMLP",
           "PackedLeNet", "PackedMnistCNN", "GraniteHybridLM"]
