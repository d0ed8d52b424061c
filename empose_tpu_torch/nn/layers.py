"""Layer library: Linear, BatchNorm, PReLU, MLP and the masked LSTM stack.

Port of ``empose_tpu/nn/layers.py`` as ``nn.Module``s whose ``state_dict``
keys are the reference torch key space (``empose_tpu/checkpoint/mapping.py``):
``Linear.weight`` is (out, in), BatchNorm keeps ``running_mean``/
``running_var``/``num_batches_tracked``, PReLU ``weight`` is (1,), and the
LSTM holds ``weight_ih_l{k}[_reverse]`` etc. in ``torch.nn.LSTM`` layout. A
reference ``model.pth`` therefore loads with ``load_state_dict(strict=True)``.

Parameters are created empty; ``init_parameters(module, generator)`` fills
them as the JAX package's ``*_init`` functions do, from an explicit
``torch.Generator``. Only the inference forward is ported: a module in
training mode raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from empose_tpu_torch.ops.lstm_kernel import lstm_cell_plain, lstm_stack, lstm_stack_fused

BN_EPS = 1e-5

TRAINING_NOT_PORTED = ("training is not ported yet: ROADMAP.md, queue 1, "
                       "'Losses and trainer' (with the LSTM training kernel pair)")


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator, low: Optional[float] = None):
    low = -bound if low is None else low
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(low, bound, generator=generator))


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` as a freshly initialized model."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


class Linear(nn.Module):
    """``x @ weight.T + bias``; torch's default init U(+-1/sqrt(in))."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.t() + self.bias


class BatchNorm1d(nn.Module):
    """Inference BatchNorm reading the running statistics:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.num_features = num_features
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # The reference initializes bn.weight uniformly in [0, 1).
        _uniform_(self.weight, 1.0, generator, low=0.0)
        with torch.no_grad():
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        return (x - self.running_mean) * torch.rsqrt(self.running_var + BN_EPS) * self.weight + self.bias


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class LinearLayers(nn.Module):
    """[Linear -> BN? -> PReLU -> Dropout] x n with an optional skip over the
    whole block. Sequential indices per block: 0 Linear, 1 BN, 2 PReLU,
    3 Dropout (without BN: 0 Linear, 1 PReLU, 2 Dropout); the reference key
    space depends on them. Dropout is the identity at inference."""

    def __init__(self, hidden_size: int, num_layers: int = 2, use_batch_norm: bool = True,
                 skip_connection: bool = False):
        super().__init__()
        mods = []
        for _ in range(num_layers):
            mods.append(Linear(hidden_size, hidden_size))
            if use_batch_norm:
                mods.append(BatchNorm1d(hidden_size))
            mods += [PReLU(), nn.Identity()]
        self.layers = nn.Sequential(*mods)
        self.skip_connection = skip_connection

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layers(x)
        return x + y if self.skip_connection else y


class MLP(nn.Module):
    """input_to_hidden -> BN? -> PReLU -> LinearLayers x n -> hidden_to_output
    (``nn/layers.py::mlp_apply`` at inference)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int, num_layers: int = 2,
                 use_batch_norm: bool = True, skip_connection: bool = False):
        super().__init__()
        self.input_to_hidden = Linear(input_size, hidden_size)
        self.batch_norm = BatchNorm1d(hidden_size) if use_batch_norm else None
        self.activation_fn = PReLU()
        self.hidden_layers = nn.ModuleList([
            LinearLayers(hidden_size, 2, use_batch_norm, skip_connection)
            for _ in range(num_layers)])
        self.hidden_to_output = Linear(hidden_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.input_to_hidden(x)
        if self.batch_norm is not None:
            y = self.batch_norm(y)
        y = self.activation_fn(y)
        for block in self.hidden_layers:
            y = block(y)
        return self.hidden_to_output(y)


def _reverse_by_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-sample reversal of the valid prefix of a (F, N, ...) tensor."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    idx = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 0, idx)


class LSTM(nn.Module):
    """Parameters of a (bi)LSTM in ``torch.nn.LSTM`` layout, gate order
    (i, f, g, o); computed by :func:`lstm_apply`, never by cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.bidirectional = bidirectional
        dirs = 2 if bidirectional else 1
        for l in range(num_layers):
            in_size = input_size if l == 0 else hidden_size * dirs
            for suffix in ("", "_reverse")[:dirs]:
                self.register_parameter(f"weight_ih_l{l}{suffix}",
                                        nn.Parameter(torch.empty(4 * hidden_size, in_size)))
                self.register_parameter(f"weight_hh_l{l}{suffix}",
                                        nn.Parameter(torch.empty(4 * hidden_size, hidden_size)))
                self.register_parameter(f"bias_ih_l{l}{suffix}",
                                        nn.Parameter(torch.empty(4 * hidden_size)))
                self.register_parameter(f"bias_hh_l{l}{suffix}",
                                        nn.Parameter(torch.empty(4 * hidden_size)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            _uniform_(p, bound, generator)

    def cell(self, l: int, suffix: str = "") -> dict:
        """Layer ``l``'s weights in ``x @ w`` form (w_ih (in, 4H), w_hh (H, 4H))."""
        return {
            "w_ih": getattr(self, f"weight_ih_l{l}{suffix}").t(),
            "w_hh": getattr(self, f"weight_hh_l{l}{suffix}").t(),
            "b_ih": getattr(self, f"bias_ih_l{l}{suffix}"),
            "b_hh": getattr(self, f"bias_hh_l{l}{suffix}"),
        }


def lstm_apply(lstm: LSTM, x: torch.Tensor, lengths: torch.Tensor,
               init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               inference: bool = True, stack_fn=lstm_stack_fused):
    """Multi-layer (bi)LSTM over a padded batch (``nn/layers.py::lstm_apply``).

    Padded frames never update the state and give zero outputs; the reverse
    direction runs over each sample's true length.

    On CUDA a unidirectional inference stack runs through the weight-resident
    kernel (``stack_fn``); on the CPU through its plain version.

    :param x: (N, F, I) batch-first; :param lengths: (N,) int.
    :param init_state: (h0, c0), each (num_layers * dirs, N, H), torch layout.
    :return: (outputs (N, F, H * dirs), (hF, cF) in torch layout).
    """
    n, f = x.shape[0], x.shape[1]
    hidden = lstm.hidden_size
    dirs = 2 if lstm.bidirectional else 1
    if x.is_cuda and lstm.bidirectional:
        raise NotImplementedError(
            "bidirectional LSTM on CUDA needs the bidirectional layer kernel, "
            "not ported yet: ROADMAP.md, queue 2, 'ops/lstm_kernel.py::_pallas_bidi'")
    if x.is_cuda and not inference:
        raise NotImplementedError(
            "LSTM training on CUDA needs the training kernel pair, not ported "
            "yet: ROADMAP.md, queue 2, 'ops/lstm_train_kernel.py::_pallas_fwd + _pallas_bwd'")
    mask = (torch.arange(f, device=x.device)[:, None] < lengths[None, :]).to(x.dtype)  # (F, N)
    xt = x.transpose(0, 1)  # (F, N, I)
    if init_state is None:
        h0 = x.new_zeros(lstm.num_layers * dirs, n, hidden)
        c0 = h0
    else:
        h0, c0 = init_state

    if not lstm.bidirectional:
        cells = [lstm.cell(l) for l in range(lstm.num_layers)]
        outs, (hF, cF) = lstm_stack(cells, xt, mask, h0, c0, stack_fn=stack_fn)
        return outs.transpose(0, 1), (hF, cF)

    h_finals, c_finals = [], []
    for l in range(lstm.num_layers):
        fwd, bwd = lstm.cell(l), lstm.cell(l, "_reverse")
        xp = xt @ fwd["w_ih"] + fwd["b_ih"] + fwd["b_hh"]
        outs_f, hF_f, cF_f = lstm_cell_plain(xp, mask, fwd["w_hh"], h0[2 * l], c0[2 * l])
        xt_rev = _reverse_by_length(xt, lengths)
        xp = xt_rev @ bwd["w_ih"] + bwd["b_ih"] + bwd["b_hh"]
        outs_b, hF_b, cF_b = lstm_cell_plain(xp, mask, bwd["w_hh"], h0[2 * l + 1], c0[2 * l + 1])
        xt = torch.cat([outs_f, _reverse_by_length(outs_b, lengths)], dim=-1)
        h_finals += [hF_f, hF_b]
        c_finals += [cF_f, cF_b]
    return xt.transpose(0, 1), (torch.stack(h_finals), torch.stack(c_finals))


class RNNLayer(nn.Module):
    """(Learned) initial state + LSTM (``nn/layers.py::rnn_layer_apply``).
    Streaming state is an explicit carry.

    ``lstm_stack`` is the stack function the unidirectional LSTM runs
    through; the default launches the kernel on CUDA. A reference run on the
    card may set it to ``lstm_stack_plain``.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False, learn_init_state: bool = False):
        super().__init__()
        if bidirectional and learn_init_state:
            raise NotImplementedError(
                "bidirectional + learn_init_state: the reference crashes on this "
                "combination as well; no released model uses it.")
        dirs = 2 if bidirectional else 1
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.lstm = LSTM(input_size, hidden_size, num_layers, bidirectional)
        if learn_init_state:
            self.to_init_state_h = Linear(input_size, hidden_size * num_layers * dirs)
            self.to_init_state_c = Linear(input_size, hidden_size * num_layers * dirs)
        self.lstm_stack = lstm_stack_fused

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, carry=None):
        """:param carry: previous final (h, c) (streaming windows) or None.

        Keeps a reference quirk for checkpoint parity: its cell_init returns
        ``(c0, h0)``, so torch's h-slot receives ``to_init_state_c``'s output
        and vice versa.
        """
        init_state = carry
        if init_state is None and hasattr(self, "to_init_state_h"):
            n = x.shape[0]
            first = x[:, 0]
            c0 = self.to_init_state_c(first).reshape(n, self.num_layers, self.hidden_size)
            h0 = self.to_init_state_h(first).reshape(n, self.num_layers, self.hidden_size)
            init_state = (c0.transpose(0, 1).contiguous(), h0.transpose(0, 1).contiguous())
        return lstm_apply(self.lstm, x, lengths, init_state, inference=not self.training,
                          stack_fn=self.lstm_stack)
