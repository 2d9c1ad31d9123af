"""Convert JAX-package variables into the port's state dicts.

``from_jax_variables`` takes the variables of a ``diffsci_tpu`` network as
nested dicts of numpy arrays (``{'params': ..., 'buffers': ...}``), picks
the network by its keys and returns the state dict of the port's
counterpart:

- PUNetG, or the KarrasNet around one (scope ``model``), with the torch
  reference's names: per-head attention w_q / w_k / w_v [H, C, dh] -> the
  packed ``in_proj_weight`` [3C, C], w_o -> ``out_proj.weight`` (the
  inverse of the JAX package's reference-import converter), and
  ``buffers/time_projection/W`` -> ``time_projection.W``;
- UNet2D, or an HFNet around one (scope ``unet``), with diffusers'
  ``UNet2DModel`` names (the JAX package's ``diffusers_unet2d_name_map``
  read backwards);
- MLPUncond / MLPCond (``Dense_{i}`` -> ``net.{2i}``).

Everywhere conv kernels [*k, in, out] -> [out, in, *k], Dense kernels
[in, out] -> [out, in] and norm scales -> ``weight``. The name maps are the
port's own copies of the JAX package's ``extra/converters.py`` maps.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# JAX scope (at the PUNetG level) -> torch prefix
_SCOPES = [
    (re.compile(r"^down_(\d+)_res_(\d+)$"), r"downward_blocks.\1.\2"),
    (re.compile(r"^up_(\d+)_res_(\d+)$"), r"upward_blocks.\1.\2"),
    (re.compile(r"^before_res_(\d+)$"), r"before_block.\1"),
    (re.compile(r"^after_res_(\d+)$"), r"after_block.\1"),
    (re.compile(r"^attn_res_(\d+)$"), r"attn_resnet_block.\1"),
    (re.compile(r"^downsampler_(\d+)$"), r"downsamplers.\1.conv"),
    (re.compile(r"^upsampler_(\d+)$"), r"upsamplers.\1.conv"),
]
_RESBLOCK = {
    "GroupLNorm_0": "gnorm1", "GroupRMSNorm_0": "gnorm2",
    "Conv_0": "conv1", "Conv_1": "conv2",
    "ResnetTimeBlock_0/Dense_0": "timeblock.net.0",
    "ResnetTimeBlock_0/Dense_1": "timeblock.net.2",
    "ResnetTimeBlock_0/Dense_2": "timeblock.net.4",
}
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_ATTN = re.compile(r"^attn_(\d+)$")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _layout(w: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return w
    if w.ndim == 2:                       # Dense [in, out] -> [out, in]
        return w.T
    nd = w.ndim - 2                       # conv [*k, in, out] -> [out, in, *k]
    return np.transpose(w, (nd + 1, nd) + tuple(range(nd)))


def _attention(leaves: dict, prefix: str) -> dict:
    """Per-head MultiHeadAttention leaves -> torch MultiheadAttention
    names."""
    wq, wk, wv, wo = (leaves[f"w_{n}"] for n in "qkvo")
    H, C, dh = wq.shape
    out = {f"{prefix}.in_proj_weight": np.concatenate(
        [w.transpose(0, 2, 1).reshape(H * dh, C) for w in (wq, wk, wv)])}
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [leaves[f"bias_{n}"].reshape(H * dh) for n in "qkv"])
    out[f"{prefix}.out_proj.weight"] = wo.transpose(1, 0, 2).reshape(C, H * dh)
    out[f"{prefix}.out_proj.bias"] = leaves["bias_o"]
    return out


def _punetg_key(path: tuple) -> str:
    """JAX leaf path inside PUNetG (without the collection) -> torch key."""
    scope, rest, leaf = path[0], "/".join(path[1:-1]), path[-1]
    if scope in ("convin", "convout", "conditional_embedding") and not rest:
        return f"{scope}.{_LEAF[leaf]}"
    for pattern, repl in _SCOPES:
        if pattern.match(scope):
            prefix = pattern.sub(repl, scope)
            if prefix.endswith(".conv") and rest == "Conv_0":
                return f"{prefix}.{_LEAF[leaf]}"
            if rest in _RESBLOCK:
                return f"{prefix}.{_RESBLOCK[rest]}.{_LEAF[leaf]}"
    raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")


_UNET_SCOPE = re.compile(r"^(down|up)_blocks_(\d+)$")
_UNET_LAYER = re.compile(r"^(resnets|attentions)_(\d+)$")


def _unet2d_key(path: tuple) -> str:
    """JAX leaf path inside UNet2D (without the collection) -> diffusers
    key."""
    scope, leaf = path[0], _LEAF[path[-1]]
    body = list(path[1:-1])
    if body[-1:] == ["to_out"]:
        body = body[:-1] + ["to_out", "0"]
    if scope in ("time_linear_1", "time_linear_2"):
        prefix = f"time_embedding.linear_{scope[-1]}"
    elif scope in ("conv_in", "conv_out", "conv_norm_out"):
        prefix = scope
    elif scope.startswith("mid_resnet_"):
        prefix = f"mid_block.resnets.{int(scope[-1]) - 1}"
    elif scope == "mid_attn":
        prefix = "mid_block.attentions.0"
    elif _UNET_SCOPE.match(scope):
        kind, i = _UNET_SCOPE.match(scope).groups()
        prefix = f"{kind}_blocks.{i}"
        if body[0] in ("downsample", "upsample"):
            body = [f"{body[0]}rs", "0", "conv"]
        elif _UNET_LAYER.match(body[0]):
            body = list(_UNET_LAYER.match(body[0]).groups()) + body[1:]
        else:
            raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")
    else:
        raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")
    return ".".join([prefix] + body + [leaf])


def _unet2d_state(params: dict) -> dict[str, np.ndarray]:
    return {_unet2d_key(path): _layout(w, path[-1])
            for path, w in _flatten(params)}


def _mlp_state(params: dict) -> dict[str, np.ndarray]:
    out = {}
    for path, w in _flatten(params):
        i = int(path[0].split("_")[1])
        out[f"net.{2 * i}.{_LEAF[path[-1]]}"] = _layout(w, path[-1])
    return out


def _tensors(state: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    return {prefix + k: torch.from_numpy(np.array(v, copy=True))
            for k, v in state.items()}


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """State dict of the port's network from JAX-package variables: PUNetG
    (or KarrasNet, when the variables hold a ``model`` scope), UNet2D (or
    HFNet, scope ``unet``) or an MLP, told apart by their keys."""
    params = variables_np.get("params", {})
    if "unet" in params:
        return _tensors(_unet2d_state(params["unet"]), "unet.")
    if "conv_in" in params:
        return _tensors(_unet2d_state(params))
    if params and all(k.startswith("Dense_") for k in params):
        return _tensors(_mlp_state(params))
    buffers = variables_np.get("buffers", {})
    wrapped = set(params) == {"model"}
    if wrapped:
        params = params["model"]
        buffers = buffers.get("model", {})
    out = {}
    attn: dict[str, dict] = {}
    for path, w in _flatten(params):
        m = _ATTN.match(path[0])
        if m and path[1] == "MultiHeadAttention_0":
            attn.setdefault(f"attn_block.{m.group(1)}.mhattn", {})[
                path[-1]] = w
            continue
        out[_punetg_key(path)] = _layout(w, path[-1])
    for prefix, leaves in attn.items():
        out.update(_attention(leaves, prefix))
    for path, w in _flatten(buffers):
        if path != ("time_projection", "W"):
            raise KeyError(f"no port name for JAX buffer {'/'.join(path)}")
        out["time_projection.W"] = w
    return _tensors(out, "model." if wrapped else "")
