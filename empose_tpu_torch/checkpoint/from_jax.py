"""Carry JAX-package params/state across into the port's state dict.

``state_dict_from_jax(params, state, config)`` takes the JAX package's
parameter and state pytrees (as numpy, or anything ``np.asarray`` reads) and
returns the reference torch key space that the port's modules use;
``grads_from_jax(grads, config)`` maps a gradient pytree (the params'
structure) through the same key map, so gradients compare by torch key. It
is the port's own copy of the key map of ``empose_tpu/checkpoint/
torch_writer.py::export_model``:

* Linear: w (in, out) -> weight (out, in); bias unchanged.
* BatchNorm: scale/bias -> weight/bias; state mean/var -> running stats;
  ``num_batches_tracked`` is 0.
* PReLU: alpha -> weight.
* LSTM: w_ih (in, 4H) -> weight_ih_l{k}[_reverse] (4H, in); gate order kept.

Model key maps (``empose_tpu/checkpoint/mapping.py:132-173``): ResNet
``from_input``, ``blocks.{i}.dense``, ``to_pose``, ``to_shape`` (an MLP
without BatchNorm); SimpleRNN ``rnn.lstm.*[_reverse]``,
``rnn.to_init_state_{h,c}``, ``to_pose``, ``to_shape``; IEF/LGD the init RNN
or MLPs and the iter MLPs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _put(out: StateDict, key: str, value) -> None:
    out[key.lstrip(".")] = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))


def _linear(params: Dict, prefix: str, out: StateDict) -> None:
    _put(out, f"{prefix}.weight", np.asarray(params["w"]).T)
    _put(out, f"{prefix}.bias", params["b"])


def _batch_norm(params: Dict, state: Optional[Dict], prefix: str, out: StateDict) -> None:
    _put(out, f"{prefix}.weight", params["scale"])
    _put(out, f"{prefix}.bias", params["bias"])
    if state is None:
        return
    _put(out, f"{prefix}.running_mean", state["mean"])
    _put(out, f"{prefix}.running_var", state["var"])
    out[f"{prefix}.num_batches_tracked".lstrip(".")] = torch.tensor(0, dtype=torch.int64)


def _prelu(params: Dict, prefix: str, out: StateDict) -> None:
    _put(out, f"{prefix}.weight", params["alpha"])


def _sub(state: Optional[Dict], key, n: int = 0):
    """``state[key]`` (or ``n`` Nones for a list), None without a state."""
    if state is None:
        return [None] * n if n else None
    return state[key]


def _linear_layers(params: Dict, state: Optional[Dict], prefix: str, out: StateDict,
                   use_bn: bool) -> None:
    step = 4 if use_bn else 3
    blocks = params["blocks"]
    for i, (bp, bs) in enumerate(zip(blocks, _sub(state, "blocks", len(blocks)))):
        base = i * step
        _linear(bp["linear"], f"{prefix}.layers.{base}", out)
        if use_bn:
            _batch_norm(bp["bn"], _sub(bs, "bn"), f"{prefix}.layers.{base + 1}", out)
            _prelu(bp["prelu"], f"{prefix}.layers.{base + 2}", out)
        else:
            _prelu(bp["prelu"], f"{prefix}.layers.{base + 1}", out)


def _mlp(params: Dict, state: Optional[Dict], prefix: str, out: StateDict, use_bn: bool) -> None:
    _linear(params["input_to_hidden"], f"{prefix}.input_to_hidden", out)
    _prelu(params["prelu"], f"{prefix}.activation_fn", out)
    _linear(params["hidden_to_output"], f"{prefix}.hidden_to_output", out)
    if use_bn:
        _batch_norm(params["bn"], _sub(state, "bn"), f"{prefix}.batch_norm", out)
    hidden = params["hidden_layers"]
    for i, (hp, hs) in enumerate(zip(hidden, _sub(state, "hidden_layers", len(hidden)))):
        _linear_layers(hp, hs, f"{prefix}.hidden_layers.{i}", out, use_bn)


def _rnn_layer(params: Dict, prefix: str, out: StateDict) -> None:
    for l, layer in enumerate(params["lstm"]["layers"]):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if d not in layer:
                continue
            cell = layer[d]
            _put(out, f"{prefix}.lstm.weight_ih_l{l}{suffix}", np.asarray(cell["w_ih"]).T)
            _put(out, f"{prefix}.lstm.weight_hh_l{l}{suffix}", np.asarray(cell["w_hh"]).T)
            _put(out, f"{prefix}.lstm.bias_ih_l{l}{suffix}", cell["b_ih"])
            _put(out, f"{prefix}.lstm.bias_hh_l{l}{suffix}", cell["b_hh"])
    for name in ("to_init_state_h", "to_init_state_c"):
        if name in params:
            _linear(params[name], f"{prefix}.{name}", out)


def state_dict_from_jax(params: Dict, state: Optional[Dict], config) -> StateDict:
    """The port's ``state_dict`` for a model's JAX pytrees; with
    ``state=None`` the parameters only (no BatchNorm buffers)."""
    out: StateDict = {}
    if config.m_type in ("resnet", "rnn"):
        if config.m_type == "resnet":
            _linear(params["from_input"], "from_input", out)
            for i, block in enumerate(params["blocks"]):
                _linear(block["dense"], f"blocks.{i}.dense", out)
        else:
            _rnn_layer(params["rnn"], "rnn", out)
        _linear(params["to_pose"], "to_pose", out)
        if config.m_estimate_shape:
            _mlp(params["to_shape"], _sub(state, "to_shape"), "to_shape", out, use_bn=False)
        return out
    if config.m_type not in ("ief", "lgd"):
        raise ValueError(f"Model type '{config.m_type}' unknown.")
    use_bn = not config.m_no_batch_norm
    if config.m_rnn_init:
        _rnn_layer(params["rnn"], "rnn", out)
        _linear(params["pose_net_init"], "pose_net_init", out)
        _linear(params["shape_net_init"], "shape_net_init", out)
    else:
        for name in ("pose_net_init", "shape_net_init"):
            _mlp(params[name], _sub(state, name), name, out, use_bn)
    for name in ("pose_net_iter", "shape_net_iter"):
        _mlp(params[name], _sub(state, name), name, out, use_bn)
    return out


def grads_from_jax(grads: Dict, config) -> StateDict:
    """A JAX gradient pytree (the params' structure) in the port's keys,
    transposed as the parameters are."""
    return state_dict_from_jax(grads, None, config)
