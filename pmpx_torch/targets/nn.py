"""Neural-network posteriors as flattened-parameter targets (port of
``pmpx/targets/nn.py``).

The chain state is the raveled parameter vector theta in R^d, laid out as
``pmpx`` ravels the flax tree (``ravel_pytree``: sorted keys, leaf by
leaf).  The layout is the model's explicit ``flax_layout()`` list of
(flax path, shape, initialiser); :meth:`NNPosterior.unravel` and
:meth:`NNPosterior.ravel` both read it, so a theta carried over from
``pmpx`` means the same network here.  All P speculative networks evaluate
in one ``torch.func.vmap`` of ``functional_call`` over the full batch.

Supports deterministic models (MLP, LSTM, and LeNet, whose BatchNorm runs
on the batch's statistics and keeps no state outside theta) and
stochastic ones (BayesMLP): with ``stochastic=True`` every density
evaluation draws fresh weight noise from the generator the sampler passes
(``needs_rng``), one draw per proposal, outside the vmap (a random op
under ``vmap`` cannot take an explicit generator) and passed in batched.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from pmpx_torch._device import resolve_device
from pmpx_torch.profiling import span

__all__ = ["NNPosterior"]

# flax's lecun_normal: a normal truncated at 2 sd, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _init_leaf(shape, init: str, gen: torch.Generator) -> torch.Tensor:
    """flax's initialiser ``init`` for one leaf, drawn on the CPU from
    ``gen`` (the law of flax's; not its numbers).  The fan-in of a kernel
    is the product of all but its last axis (flax's ``in_axis=-2`` times
    the receptive field of a conv kernel (kh, kw, in, out)).  ``normal``
    is N(0, 1/fan_in) untruncated, ``normal:<std>`` N(0, std^2);
    ``mamba_A_log`` and ``mamba_dt_bias`` are Mamba-2's initialisers: log
    U(1, 16), and softplus^-1 of a dt log-uniform on [1e-3, 1e-1]."""
    t = torch.zeros(shape)
    fan_in = math.prod(shape[:-1])
    if init == "normal" or init.startswith("normal:"):
        std = (math.sqrt(1.0 / fan_in) if init == "normal"
               else float(init[len("normal:"):]))
        torch.nn.init.normal_(t, 0.0, std, generator=gen)
    elif init == "mamba_A_log":
        t = torch.log(torch.empty(shape).uniform_(1.0, 16.0, generator=gen))
    elif init == "mamba_dt_bias":
        dt = torch.exp(torch.empty(shape).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen))
        t = dt + torch.log(-torch.expm1(-dt))
    elif init == "lecun_normal":
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
    elif init == "kaiming_uniform":
        lim = math.sqrt(6.0 / fan_in)
        torch.nn.init.uniform_(t, -lim, lim, generator=gen)
    elif init == "orthogonal":
        torch.nn.init.orthogonal_(t, generator=gen)
    elif init == "ones":
        t.fill_(1.0)
    elif init.startswith("const:"):
        t.fill_(float(init[len("const:"):]))
    elif init != "zeros":
        raise ValueError(f"unknown initialiser {init!r}")
    return t


def _flatten(params, prefix: str = "") -> dict:
    """Nested dicts keyed like the flax tree -> {dotted path: leaf}."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


class NNPosterior:
    """log pi(theta) = -temper * mean CrossEntropy(model(X; theta), Y).

    ``temper`` captures the reference's loss scalings: 0.1 (``PMP_FC.py:44``
    loss/10), 1e4 (``MH_FC.py`` lambda), 1.0 (HMC scripts).

    ``compute_dtype=torch.bfloat16`` runs the forward pass (parameters and
    activations) in bf16, promoted as flax promotes them; the chain state
    and the loss stay f32.  ``proposal_chunk`` bounds how many of the P
    networks evaluate at once (``vmap``'s ``chunk_size``; it must divide
    P).  ``seed`` draws :meth:`init_theta` from flax's initialisers with a
    ``torch.Generator``, at its first call (a posterior whose chain starts
    elsewhere draws nothing).  ``X`` and ``Y`` move to ``device`` (CUDA
    unless given); an integer ``X`` (token ids) stays integer, any other
    is cast to float32 and then to ``compute_dtype``.
    ``stochastic=True`` (a model with ``noise_shapes()``, such as
    ``BayesMLP``) makes the density methods take ``generator=``, from
    which each evaluation draws its own weight noise.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        X,
        Y,
        temper: float = 1.0,
        seed: int = 0,
        stochastic: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        proposal_chunk: Optional[int] = None,
        device=None,
    ):
        if stochastic and not hasattr(model, "noise_shapes"):
            raise ValueError(
                f"stochastic=True needs a model that takes its weight "
                f"noise (noise_shapes()); {type(model).__name__} does not")
        dev = resolve_device(device)
        self.device = dev
        self.model = model.to(dev)
        self.compute_dtype = compute_dtype
        self.X = self._cast_x(torch.as_tensor(X, device=dev))
        self.Y = torch.as_tensor(Y, device=dev).long()
        self.temper = float(temper)
        self.stochastic = bool(stochastic)
        self.needs_rng = self.stochastic
        self._noise_shapes = model.noise_shapes() if stochastic else {}
        self.proposal_chunk = proposal_chunk
        self.layout = model.flax_layout()
        self._slices = {}
        off = 0
        for path, shape, _ in self.layout:
            n = math.prod(shape)
            self._slices[path] = (off, n, tuple(shape))
            off += n
        self.d = off
        self.seed = int(seed)
        self._theta0 = None
        # Optional fused-kernel density (pmpx_torch.kernels.lstm_fused
        # .attach): a log_prob_batch that bypasses the generic forward.
        self._fast_batch = None
        self._data_bound = False

    # ------------------------------------------------------------------
    def _cast_x(self, X: torch.Tensor) -> torch.Tensor:
        """Inputs as the forward pass takes them: integers (token ids)
        as they are, anything else in float32, then ``compute_dtype``."""
        if not X.is_floating_point() and X.dtype != torch.bool:
            return X
        X = X.to(torch.float32)
        return X if self.compute_dtype is None else X.to(self.compute_dtype)

    def unravel(self, theta: torch.Tensor) -> dict:
        """{flax path: leaf} views of ``theta`` (d,) or a batch (..., d)."""
        lead = theta.shape[:-1]
        return {path: theta[..., o:o + n].reshape(*lead, *shape)
                for path, (o, n, shape) in self._slices.items()}

    def ravel(self, params: dict) -> torch.Tensor:
        """Flat theta from {flax path: leaf}, in the layout's order."""
        missing = [p for p in self._slices if p not in params]
        extra = [p for p in params if p not in self._slices]
        if missing or extra:
            raise ValueError(f"parameter paths do not match the layout: "
                             f"missing {missing[:4]}, unexpected {extra[:4]}")
        leaves = []
        for path, (_, _, shape) in self._slices.items():
            leaf = params[path]
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.from_numpy(np.array(leaf, np.float32))
            leaf = leaf.to(device=self.device, dtype=torch.float32)
            if tuple(leaf.shape) != shape:
                raise ValueError(f"shape mismatch at {path}: layout "
                                 f"{shape}, given {tuple(leaf.shape)}")
            leaves.append(leaf.reshape(-1))
        return torch.cat(leaves)

    @contextmanager
    def bound_data(self, X, Y=None):
        """Temporarily rebind the dataset (cast to ``compute_dtype``).
        Not reentrant: a nested bind of one posterior raises."""
        if self._data_bound:
            raise RuntimeError(
                "bound_data is not reentrant: this NNPosterior already "
                "has a dataset bound (nested binds of one posterior would "
                "cross-bind datasets)"
            )
        self._data_bound = True
        old_x, old_y = self.X, self.Y
        self.X = self._cast_x(X)
        if Y is not None:
            self.Y = Y
        try:
            yield self
        finally:
            self.X, self.Y = old_x, old_y
            self._data_bound = False

    def init_theta(self) -> torch.Tensor:
        """Raveled freshly initialised parameters (the reference warm-starts
        from pretrained ``.pkl`` checkpoints; see ``theta_from_params``),
        drawn at the first call, on the CPU from ``seed``, leaf by leaf."""
        if self._theta0 is None:
            gen = torch.Generator().manual_seed(self.seed)
            self._theta0 = torch.cat([
                _init_leaf(shape, init, gen).reshape(-1)
                for _, shape, init in self.layout
            ]).to(self.device)
        return self._theta0

    def theta_from_params(self, params: dict) -> torch.Tensor:
        """Ravel externally trained parameters: nested dicts keyed like the
        flax tree, or {dotted flax path: leaf}."""
        return self.ravel(_flatten(params))

    # ------------------------------------------------------------------
    def _noise(self, generator, lead=()) -> Optional[dict]:
        """One forward pass's weight noise for each of ``lead`` networks,
        drawn in ``noise_shapes()`` order from ``generator`` (None for a
        deterministic model)."""
        if not self.stochastic:
            return None
        return {k: torch.randn((*lead, *shape), generator=generator,
                               device=self.device)
                for k, shape in self._noise_shapes.items()}

    def draw_noise(self, generator) -> Optional[dict]:
        """One forward pass's weight noise, drawn from ``generator``, to
        pass as ``noise=`` to :meth:`log_prob` and :meth:`accuracy` (None
        for a deterministic model)."""
        return self._noise(generator)

    def _logits(self, theta: torch.Tensor, X: torch.Tensor,
                noise: Optional[dict] = None) -> torch.Tensor:
        params = self.unravel(theta)
        if self.compute_dtype is not None:
            params = {k: v.to(self.compute_dtype) for k, v in params.items()}
            if X.is_floating_point():
                X = X.to(self.compute_dtype)
        args = (X,) if noise is None else (X, noise)
        return functional_call(self.model, params, args)

    def _neg_loss(self, theta: torch.Tensor,
                  noise: Optional[dict] = None) -> torch.Tensor:
        logits = self._logits(theta, self.X, noise)
        return -self.temper * F.cross_entropy(logits.float(), self.Y)

    def _chunk(self, P: int) -> Optional[int]:
        c = self.proposal_chunk
        if c is None or c >= P:
            return None
        if P % c:
            raise ValueError(
                f"proposal_chunk={c} must divide the batch size {P}"
            )
        return c

    # -- Target protocol ------------------------------------------------
    def log_prob(self, theta: torch.Tensor, generator=None,
                 noise: Optional[dict] = None) -> torch.Tensor:
        """A stochastic model evaluates on ``noise`` (:meth:`draw_noise`)
        where given, else on weight noise drawn from ``generator``."""
        if self._fast_batch is not None:
            # singles through the kernel too: acceptance ratios compare
            # densities of ONE floating-point evaluation order
            return self._fast_batch(theta[None])[0]
        if noise is None:
            noise = self._noise(generator)
        return self._neg_loss(theta, noise)

    def log_prob_batch(self, Theta: torch.Tensor,
                       generator=None) -> torch.Tensor:
        """The span ``nn.density`` (``proposals``, and ``tokens`` the
        predictions the loss averages), kept where spans are and not
        while a CUDA graph captures (it would not be replayed)."""
        if Theta.is_cuda and torch.cuda.is_current_stream_capturing():
            return self._log_prob_batch(Theta, generator)
        with span("nn.density", self.device, proposals=Theta.shape[0],
                  tokens=self.Y.numel()):
            return self._log_prob_batch(Theta, generator)

    def _log_prob_batch(self, Theta, generator):
        if self._fast_batch is not None:
            return self._fast_batch(Theta)
        chunk = self._chunk(Theta.shape[0])
        if self.stochastic:
            noise = self._noise(generator, (Theta.shape[0],))
            return vmap(self._neg_loss, chunk_size=chunk)(Theta, noise)
        return vmap(self._neg_loss, chunk_size=chunk)(Theta)

    def value_and_grad_batch(self, Theta: torch.Tensor, generator=None):
        chunk = self._chunk(Theta.shape[0])
        vg = vmap(grad_and_value(self._neg_loss), chunk_size=chunk)
        if self.stochastic:
            grads, values = vg(Theta, self._noise(generator,
                                                  (Theta.shape[0],)))
        else:
            grads, values = vg(Theta)
        return values, grads

    # ------------------------------------------------------------------
    def accuracy(self, theta: torch.Tensor, X=None, Y=None,
                 generator=None, noise: Optional[dict] = None
                 ) -> torch.Tensor:
        """Classification accuracy (the reference logs train/test correct
        ratios, ``PMP_FC.py:147-156``), through the generic forward; a
        stochastic model takes one set of weights from ``noise``
        (:meth:`draw_noise`) where given, else draws it from
        ``generator``."""
        X = self.X if X is None else X
        Y = self.Y if Y is None else Y
        if noise is None:
            noise = self._noise(generator)
        with torch.no_grad():
            logits = self._logits(theta, X, noise)
            return (logits.argmax(dim=-1) == Y).float().mean()
