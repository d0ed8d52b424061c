"""Layer library: Linear, BatchNorm, PReLU, MLP and the masked LSTM stack.

Port of ``empose_tpu/nn/layers.py`` as ``nn.Module``s whose ``state_dict``
keys are the reference torch key space (``empose_tpu/checkpoint/mapping.py``):
``Linear.weight`` is (out, in), BatchNorm keeps ``running_mean``/
``running_var``/``num_batches_tracked``, PReLU ``weight`` is (1,), and the
LSTM holds ``weight_ih_l{k}[_reverse]`` etc. in ``torch.nn.LSTM`` layout. A
reference ``model.pth`` therefore loads with ``load_state_dict(strict=True)``.

Parameters are created empty; ``init_parameters(module, generator)`` fills
them as the JAX package's ``*_init`` functions do, from an explicit
``torch.Generator``.

Training mode follows the JAX package: BatchNorm takes its statistics over
the valid frames only (``mask``), dropout draws from an explicit
``torch.Generator`` (none given: no dropout, as a missing JAX key), and the
LSTM runs layer by layer through the differentiable training pair
(``ops/lstm_train_kernel.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from empose_tpu_torch.ops.lstm_kernel import (lstm_bidi_fused, lstm_bidi_layer, lstm_stack,
                                              lstm_stack_fused)
from empose_tpu_torch.ops.lstm_train_kernel import lstm_cell_train
from empose_tpu_torch.ops.precision import matmul_at
from empose_tpu_torch.parallel.mesh import all_reduce_sum, batch_draw, current_shard
from empose_tpu_torch.utils.precision import HIGHEST, resolve

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# Matmul precision of the NN layers (``empose_tpu/nn/layers.py:_HI``): the
# Linear layers (MLPs, residual blocks, heads), the LSTM input projections
# and the LSTM kernels' products. ``highest`` is the fp32 parity mode;
# ``default`` the bf16 serving mode. The kinematics have their own knob
# (``nn.models.set_fk_precision``); ``device.set_precision`` sets both.
_NN_PRECISION = HIGHEST


def set_nn_precision(name: str) -> None:
    """Switch the NN-layer matmul precision for every later forward."""
    global _NN_PRECISION
    _NN_PRECISION = resolve(name)


def nn_precision() -> str:
    return _NN_PRECISION


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
        return matmul_at(x, self.weight.t(), _NN_PRECISION) + self.bias


class BatchNorm1d(nn.Module):
    """BatchNorm over the last axis (``nn/layers.py::batch_norm_apply``).

    Eval: ``(x - mean) * rsqrt(var + eps) * weight + bias`` from the running
    statistics. Train: the batch statistics of the rows where ``mask`` is 1
    (all rows without a mask), in the JAX package's one-pass form shifted by
    the running mean; the biased variance normalizes, the unbiased one goes
    into the running statistic with momentum 0.1, and
    ``num_batches_tracked`` counts the updates. In a data-parallel step the
    statistics are the global batch's: the count and both sums are summed
    over the ranks (``parallel/mesh.all_reduce_sum``, differentiable), so
    every rank normalizes alike and keeps the same running statistics."""

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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            return (x - self.running_mean) * torch.rsqrt(self.running_var + BN_EPS) * self.weight + self.bias
        rows = x.reshape(-1, x.shape[-1])
        m = (torch.ones_like(rows[:, :1]) if mask is None
             else mask.reshape(-1, 1).to(x.dtype))
        count = m.sum().clamp(min=1.0)
        m0 = self.running_mean.detach()
        xc = rows - m0
        if current_shard() is None:
            d = (xc * m).sum(0) / count
            d_sq = (xc * xc * m).sum(0) / count
        else:
            # The global batch's sums, over every rank's valid rows; each
            # rank shifts by the same running mean, so the sums add exactly.
            c = self.num_features
            sums = all_reduce_sum(torch.cat([(xc * m).sum(0), (xc * xc * m).sum(0),
                                             m.sum().reshape(1)]))
            count = sums[2 * c].clamp(min=1.0)
            d, d_sq = sums[:c] / count, sums[c:2 * c] / count
        var = (d_sq - d * d).clamp(min=0.0)
        mean = m0 + d
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias
        with torch.no_grad():
            unbiased = var * (count / (count - 1.0).clamp(min=1.0))
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * unbiased)
            self.num_batches_tracked.add_(1)
        return y


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator``
    (``nn/layers.py::dropout_apply``); the identity at eval, at ``p <= 0`` and
    without a generator. ``x``'s leading axis holds the samples (or their
    frames, sample by sample); in a data-parallel step the mask is the
    global batch's (``parallel/mesh.batch_draw``)."""
    if not training or p <= 0.0 or generator is None:
        return x
    keep = 1.0 - p
    kept = batch_draw(lambda k: torch.rand((k, *x.shape[1:]), generator=generator,
                                           device=x.device), x.shape[0]) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


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
    space depends on them. Dropout has no parameters: its slot holds an
    ``nn.Identity`` and :func:`dropout` runs in ``forward``."""

    def __init__(self, hidden_size: int, num_layers: int = 2, use_batch_norm: bool = True,
                 skip_connection: bool = False, dropout_p: float = 0.0):
        super().__init__()
        mods = []
        for _ in range(num_layers):
            mods.append(Linear(hidden_size, hidden_size))
            if use_batch_norm:
                mods.append(BatchNorm1d(hidden_size))
            mods += [PReLU(), nn.Identity()]
        self.layers = nn.Sequential(*mods)
        self.skip_connection = skip_connection
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, bn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x
        for mod in self.layers:
            if isinstance(mod, BatchNorm1d):
                y = mod(y, bn_mask)
            elif isinstance(mod, nn.Identity):
                y = dropout(y, self.dropout_p, self.training, generator)
            else:
                y = mod(y)
        return x + y if self.skip_connection else y


class MLP(nn.Module):
    """input_to_hidden -> BN? -> PReLU -> Dropout -> LinearLayers x n ->
    hidden_to_output (``nn/layers.py::mlp_apply``); ``bn_mask`` marks the
    rows that count in train-mode BatchNorm statistics."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int, num_layers: int = 2,
                 use_batch_norm: bool = True, skip_connection: bool = False,
                 dropout_p: float = 0.0):
        super().__init__()
        self.input_to_hidden = Linear(input_size, hidden_size)
        self.batch_norm = BatchNorm1d(hidden_size) if use_batch_norm else None
        self.activation_fn = PReLU()
        self.hidden_layers = nn.ModuleList([
            LinearLayers(hidden_size, 2, use_batch_norm, skip_connection, dropout_p)
            for _ in range(num_layers)])
        self.hidden_to_output = Linear(hidden_size, output_size)
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, bn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.input_to_hidden(x)
        if self.batch_norm is not None:
            y = self.batch_norm(y, bn_mask)
        y = dropout(self.activation_fn(y), self.dropout_p, self.training, generator)
        for block in self.hidden_layers:
            y = block(y, bn_mask, generator)
        return self.hidden_to_output(y)


class ResidualBlock(nn.Module):
    """``relu(dense(x) + x)`` (``nn/layers.py::residual_block_apply``)."""

    def __init__(self, size: int):
        super().__init__()
        self.dense = Linear(size, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.dense(x) + x)


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
               inference: bool = True, stack_fn=lstm_stack_fused, train_cell=lstm_cell_train,
               bidi_fn=lstm_bidi_fused):
    """Multi-layer (bi)LSTM over a padded batch (``nn/layers.py::lstm_apply``).

    Padded frames never update the state and give zero outputs; the reverse
    direction runs over each sample's true length.

    Inference: a unidirectional stack runs through the weight-resident stack
    kernel (``stack_fn``), a bidirectional one layer by layer through the
    bidirectional layer kernel (``bidi_fn``), both directions in one call;
    both, and the input projections, at the NN knob's precision
    (:func:`set_nn_precision`). Training: every direction-layer runs through
    ``train_cell``, the differentiable kernel pair on CUDA, at the same
    precision.

    :param x: (N, F, I) batch-first; :param lengths: (N,) int.
    :param init_state: (h0, c0), each (num_layers * dirs, N, H), torch layout.
    :return: (outputs (N, F, H * dirs), (hF, cF) in torch layout).
    """
    n, f = x.shape[0], x.shape[1]
    hidden = lstm.hidden_size
    dirs = 2 if lstm.bidirectional else 1
    mask = (torch.arange(f, device=x.device)[:, None] < lengths[None, :]).to(x.dtype)  # (F, N)
    xt = x.transpose(0, 1)  # (F, N, I)
    if init_state is None:
        h0 = x.new_zeros(lstm.num_layers * dirs, n, hidden)
        c0 = h0
    else:
        h0, c0 = init_state

    precision = _NN_PRECISION
    if inference and not lstm.bidirectional:
        cells = [lstm.cell(l) for l in range(lstm.num_layers)]
        outs, (hF, cF) = lstm_stack(cells, xt, mask, h0, c0, stack_fn=stack_fn,
                                    precision=precision)
        return outs.transpose(0, 1), (hF, cF)

    h_finals, c_finals = [], []
    for l in range(lstm.num_layers):
        if inference:  # bidirectional: both directions of the layer in one call
            outs2, (hF, cF) = lstm_bidi_layer(
                lstm.cell(l), lstm.cell(l, "_reverse"), xt, _reverse_by_length(xt, lengths),
                mask, h0[2 * l:2 * l + 2], c0[2 * l:2 * l + 2], bidi_fn=bidi_fn,
                precision=precision)
            xt = torch.cat([outs2[:, 0], _reverse_by_length(outs2[:, 1], lengths)], dim=-1)
            h_finals += [hF[0], hF[1]]
            c_finals += [cF[0], cF[1]]
        else:
            outs_f, (hF, cF) = train_cell(lstm.cell(l), xt, mask, h0[l * dirs], c0[l * dirs],
                                          precision=precision)
            h_finals.append(hF)
            c_finals.append(cF)
            if lstm.bidirectional:
                outs_b, (hF, cF) = train_cell(lstm.cell(l, "_reverse"),
                                              _reverse_by_length(xt, lengths), mask,
                                              h0[l * dirs + 1], c0[l * dirs + 1],
                                              precision=precision)
                outs_f = torch.cat([outs_f, _reverse_by_length(outs_b, lengths)], dim=-1)
                h_finals.append(hF)
                c_finals.append(cF)
            xt = outs_f
    return xt.transpose(0, 1), (torch.stack(h_finals), torch.stack(c_finals))


class RNNLayer(nn.Module):
    """Input dropout + (learned) initial state + LSTM
    (``nn/layers.py::rnn_layer_apply``). Streaming state is an explicit carry.

    ``lstm_stack`` is the stack function a unidirectional LSTM runs through
    at inference, ``lstm_bidi`` the layer function of a bidirectional one,
    and ``lstm_train_cell`` the direction-layer function of training; the
    defaults launch the kernels on CUDA. A reference run on the card may set
    them to ``lstm_stack_plain``, ``lstm_bidi_plain`` and ``lstm_cell_train``
    with the plain sweeps.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False, learn_init_state: bool = False,
                 dropout_p: float = 0.0):
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
        self.lstm_bidi = lstm_bidi_fused
        self.lstm_train_cell = lstm_cell_train
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, carry=None,
                generator: Optional[torch.Generator] = None):
        """:param carry: previous final (h, c) (streaming windows) or None.

        Keeps a reference quirk for checkpoint parity: its cell_init returns
        ``(c0, h0)``, so torch's h-slot receives ``to_init_state_c``'s output
        and vice versa.
        """
        x = dropout(x, self.dropout_p, self.training, generator)
        init_state = carry
        if init_state is None and hasattr(self, "to_init_state_h"):
            n = x.shape[0]
            first = x[:, 0]
            c0 = self.to_init_state_c(first).reshape(n, self.num_layers, self.hidden_size)
            h0 = self.to_init_state_h(first).reshape(n, self.num_layers, self.hidden_size)
            init_state = (c0.transpose(0, 1).contiguous(), h0.transpose(0, 1).contiguous())
        return lstm_apply(self.lstm, x, lengths, init_state, inference=not self.training,
                          stack_fn=self.lstm_stack, train_cell=self.lstm_train_cell,
                          bidi_fn=self.lstm_bidi)
