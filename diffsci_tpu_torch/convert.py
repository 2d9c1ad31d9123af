"""Convert JAX-package variables into the port's state dicts.

``from_jax_variables`` takes the variables of a ``diffsci_tpu`` PUNetG (or
of the KarrasNet around one) as nested dicts of numpy arrays
(``{'params': ..., 'buffers': ...}``) and returns the state dict of the
port's PUNetG (or KarrasNet), with the torch reference's names:

- conv kernels [*k, in, out] -> [out, in, *k]; Dense [in, out] -> [out, in];
- per-head attention w_q / w_k / w_v [H, C, dh] -> the packed
  ``in_proj_weight`` [3C, C], w_o -> ``out_proj.weight`` (the inverse of
  the JAX package's reference-import converter);
- ``buffers/time_projection/W`` -> ``time_projection.W``.

The name map is the port's own copy of the JAX package's
``extra/converters.py`` reference map, read backwards.
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


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """State dict of the port's PUNetG (or KarrasNet, when the variables
    hold a ``model`` scope) from JAX-package variables."""
    params = variables_np.get("params", {})
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
    prefix = "model." if wrapped else ""
    return {prefix + k: torch.from_numpy(np.array(v, copy=True))
            for k, v in out.items()}
