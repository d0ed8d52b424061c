"""Plain layers over a flat parameter dict keyed like ``torch.nn`` state
dicts: Linear, BatchNorm1d, PReLU, the EM-POSE MLP and a masked LSTM.

Every function takes ``p`` (name -> tensor) and the prefix of its module.
Dropout is left out: both released models train with p = 0. BatchNorm in
training normalizes by the biased variance of the valid rows, two-pass; in
evaluation by the running statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

BN_EPS = 1e-5

Params = Dict[str, torch.Tensor]


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def batch_norm(p: Params, name: str, x: torch.Tensor, train: bool,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not train:
        return (x - p[f"{name}.running_mean"]) / torch.sqrt(p[f"{name}.running_var"] + BN_EPS) * w + b
    m = torch.ones_like(x[:, :1]) if mask is None else mask.reshape(-1, 1).to(x.dtype)
    count = m.sum()
    mean = (x * m).sum(0) / count
    var = (((x - mean) ** 2) * m).sum(0) / count
    return (x - mean) / torch.sqrt(var + BN_EPS) * w + b


def prelu(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, p[f"{name}.weight"] * x)


def mlp(p: Params, name: str, x: torch.Tensor, n_blocks: int, bn: bool, train: bool,
        mask=None) -> torch.Tensor:
    """input_to_hidden -> [BN] -> PReLU, then ``n_blocks`` blocks of two
    (Linear -> [BN] -> PReLU), then hidden_to_output."""
    y = linear(p, f"{name}.input_to_hidden", x)
    if bn:
        y = batch_norm(p, f"{name}.batch_norm", y, train, mask)
    y = prelu(p, f"{name}.activation_fn", y)
    step = 4 if bn else 3   # Linear, [BN], PReLU, Dropout slots
    for blk in range(n_blocks):
        base = f"{name}.hidden_layers.{blk}.layers"
        for k in range(2):
            i = k * step
            y = linear(p, f"{base}.{i}", y)
            if bn:
                y = batch_norm(p, f"{base}.{i + 1}", y, train, mask)
            y = prelu(p, f"{base}.{i + 1 + bn}", y)
    return linear(p, f"{name}.hidden_to_output", y)


def mlp_spec(name: str, n_in: int, n_out: int, hidden: int, n_blocks: int, bn: bool) -> List:
    """The parameters and buffers of :func:`mlp` as (key, shape, init):
    init is ("uniform", bound), ("uniform01",), ("zeros",), ("prelu",),
    ("buffer", value) or ("count",), the last two not trained."""
    spec = linear_spec(f"{name}.input_to_hidden", n_in, hidden)
    if bn:
        spec += _bn_spec(f"{name}.batch_norm", hidden)
    spec.append((f"{name}.activation_fn.weight", (1,), ("prelu",)))
    step = 4 if bn else 3
    for blk in range(n_blocks):
        base = f"{name}.hidden_layers.{blk}.layers"
        for k in range(2):
            i = k * step
            spec += linear_spec(f"{base}.{i}", hidden, hidden)
            if bn:
                spec += _bn_spec(f"{base}.{i + 1}", hidden)
            spec.append((f"{base}.{i + 1 + bn}.weight", (1,), ("prelu",)))
    return spec + linear_spec(f"{name}.hidden_to_output", hidden, n_out)


def linear_spec(name: str, n_in: int, n_out: int) -> List:
    bound = 1.0 / math.sqrt(n_in)
    return [(f"{name}.weight", (n_out, n_in), ("uniform", bound)),
            (f"{name}.bias", (n_out,), ("uniform", bound))]


def _bn_spec(name: str, n: int) -> List:
    return [(f"{name}.weight", (n,), ("uniform01",)), (f"{name}.bias", (n,), ("zeros",)),
            (f"{name}.running_mean", (n,), ("buffer", 0.0)),
            (f"{name}.running_var", (n,), ("buffer", 1.0)),
            (f"{name}.num_batches_tracked", (), ("count",))]


def lstm_spec(name: str, n_in: int, hidden: int, layers: int, bidirectional: bool) -> List:
    bound = 1.0 / math.sqrt(hidden)
    dirs = ("", "_reverse") if bidirectional else ("",)
    spec = []
    for l in range(layers):
        i = n_in if l == 0 else hidden * len(dirs)
        for s in dirs:
            spec += [(f"{name}.weight_ih_l{l}{s}", (4 * hidden, i), ("uniform", bound)),
                     (f"{name}.weight_hh_l{l}{s}", (4 * hidden, hidden), ("uniform", bound)),
                     (f"{name}.bias_ih_l{l}{s}", (4 * hidden,), ("uniform", bound)),
                     (f"{name}.bias_hh_l{l}{s}", (4 * hidden,), ("uniform", bound))]
    return spec


def lstm_direction(x: torch.Tensor, mask: torch.Tensor, w_ih, w_hh, b_ih, b_hh,
                   h: torch.Tensor, c: torch.Tensor):
    """One direction of one layer over time-major ``x`` (F, N, I), gates
    (i, f, g, o). A frame whose ``mask`` (F, N) is 0 leaves the state as it
    is and outputs 0. Returns (outputs (F, N, H), (h, c))."""
    xp = x @ w_ih.T + (b_ih + b_hh)
    full = bool(mask.all())
    outs = []
    for t in range(x.shape[0]):
        gates = xp[t] + h @ w_hh.T
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if full:
            h, c = h_new, c_new
            outs.append(h_new)
        else:
            m = mask[t][:, None]
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
            outs.append(h_new * m)
    return torch.stack(outs), (h, c)


def reverse_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sample's first ``length`` frames of time-major ``x``."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    idx = torch.where(t < lengths[None], lengths[None] - 1 - t, t)
    return torch.gather(x, 0, idx[..., None].expand_as(x))


def lstm(p: Params, name: str, x: torch.Tensor, lengths: torch.Tensor, layers: int,
         bidirectional: bool, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         library: bool = False):
    """A (bi)LSTM over batch-first ``x`` (N, F, I); ``state`` is (h, c), each
    (layers * dirs, N, H). Returns (outputs (N, F, H * dirs), final state).

    ``library``: through ``torch.nn.LSTM`` (cuDNN on the card) instead of
    the step loop, for long sequences; it needs every row at full length."""
    n, f = x.shape[:2]
    hidden = p[f"{name}.weight_hh_l0"].shape[1]
    dirs = 2 if bidirectional else 1
    if state is None:
        zero = x.new_zeros(layers * dirs, n, hidden)
        state = (zero, zero)
    if library:
        if not bool((lengths == f).all()):
            raise ValueError("the library LSTM runs full-length rows only")
        mod = torch.nn.LSTM(x.shape[-1], hidden, layers, batch_first=True,
                            bidirectional=bidirectional, device="meta")
        weights = {k[len(name) + 1:]: v for k, v in p.items() if k.startswith(name + ".")}
        return torch.func.functional_call(mod, weights, (x, state))
    mask = (torch.arange(f, device=x.device)[:, None] < lengths[None]).to(x.dtype)
    xt = x.transpose(0, 1)
    hs, cs = [], []
    for l in range(layers):
        outs = []
        for d, s in enumerate(("", "_reverse")[:dirs]):
            w = [p[f"{name}.{k}_l{l}{s}"] for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            k = l * dirs + d
            inp = xt if d == 0 else reverse_valid(xt, lengths)
            out, (h, c) = lstm_direction(inp, mask, *w, state[0][k], state[1][k])
            outs.append(out if d == 0 else reverse_valid(out, lengths))
            hs.append(h)
            cs.append(c)
        xt = torch.cat(outs, -1)
    return xt.transpose(0, 1), (torch.stack(hs), torch.stack(cs))
