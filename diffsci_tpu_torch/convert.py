"""Convert JAX-package variables and train states into the port's.

``from_jax_variables`` takes the variables of a ``diffsci_tpu`` network as
nested dicts of numpy arrays (``{'params': ..., 'buffers': ...}``), picks
the network by its keys and returns the state dict of the port's
counterpart:

- PUNetG or PUNetGCond (scope ``unet``), or the KarrasNet around one
  (scope ``model``; ``dlw`` and the ``batch_stats`` of ``bnorm`` beside
  it), with the torch reference's names: per-head default attention w_q /
  w_k / w_v [H, C, dh] -> the packed ``in_proj_weight`` [3C, C], w_o ->
  ``out_proj.weight`` (the inverse of the JAX package's reference-import
  converter); cosine / mp attention's w_* / w_mp_* -> ``*_proj_matrix``
  as they are; default, circular (``CircularConv_i/Conv_0``) and
  magnitude-preserving (``w_mp``) convolutions and time-MLP layers alike;
  the norms by the config's norm kinds; ``buffers`` (the time projection,
  the Fourier stem) and ``cond_drop/null_embedding`` by name; and the
  conditional embedders (``embedders.py``, a transformer encoder's flax
  attention packed as torch's);
- UNet2D, or an HFNet around one (scope ``unet``), with diffusers'
  ``UNet2DModel`` names (the JAX package's ``diffusers_unet2d_name_map``
  read backwards);
- MLPUncond / MLPCond (``Dense_{i}`` -> ``net.{2i}``);
- AutoencoderKL, 2D or 3D (``encoder``/``decoder``/``quant_conv``), with
  the torch reference's names (``down_{i}_block_{j}`` ->
  ``down.{i}.block.{j}``, the blocks' GroupNorm_0/Conv_0/GroupNorm_1/
  Conv_1/Conv_2 -> norm1/conv1/norm2/conv2/nin_shortcut, ``mid_attn``'s
  Dense_0-3 -> the 1×1 convolutions q/k/v/proj_out, the auto-numbered
  attention blocks at ``attn_resolutions`` -> ``down.{i}.attn.{j}`` in
  call order, which needs the ``DDConfig``), or the ``VAEModel`` around
  one (scope ``autoencoder``, with a trainable ``logvar``);
- VAENet, 1D, 2D or 3D (``encoder``/``decoder``, each with its
  ``quant_conv``), with the torch reference's names: the blocks flax
  numbers in call order (``_StdResBlock_k`` or ``MinimalResnetBlock_k``)
  -> ``down.{i}.block.{j}``, ``mid.block_{1,2}``, ``up.{i}.block.{j}``, a
  block's Conv_0/Dense_0/Conv_1/Conv_2 -> conv1.conv/temb_proj/conv2.conv
  (the gate's ``gate.conv`` in a minimal block)/nin_shortcut.conv, the
  resamplers, ``mid_attn`` and ``time_embed``; or the ``VAEModel`` around
  one; and the ``NLayerDiscriminator`` (Conv_i / GroupNorm_i -> convs.i /
  norms.i);
- the network of a ``KarrasEncoderModel`` (``encoder_model`` beside
  ``model``);
- ADM, 2D or 3D, default or mp convolutions (``time_embedding``,
  ``input_layer``, ``enc_{i}_block_{j}`` / ``mid_block_{j}`` /
  ``dec_{i}_block_{j}`` -> ``encoder.layers.{i}.input_blocks.{j}`` /
  ``middle_block.middle_blocks.{j}`` / ``decoder.layers...``, a block's
  convs -> conv1, conv2, convresidual, its Dense -> embed_linear, its
  norms by the config's kinds -> norm1, norm2, its attention packed);
- DiT and MoE-DiT (``Dense_0-4`` -> time_mlp_in/mid/out, token_embed,
  token_head, ``block_{i}`` / ``moe_block_{i}`` -> ``blocks.{i}``: Dense_0
  adaln, LayerNorm_0/1 norm1/2, the attention packed, Dense_1/2
  mlp_in/out, ``moe`` as it is);
- ConVit (the torch reference's names; a transposed convolution's flax
  kernel [*k, I, O] is spatially flipped back into torch's [I, O, *k];
  the attention's ``scale`` buffer √dh is added);
- the PUNetG variants: PUNetGDeterministic (scope ``unet``), the encoder
  (bottleneck -> ``bottom_blocks.{0-3}``, ``projection``), the decoder,
  PUNetV (``slice_embedding``'s GroupNorm_i / Conv_i -> norm{i+1} /
  conv{i+1});
- MinimalResNet (``block_{i}`` -> ``res_blocks.{i}``) and DASC (the
  reference's Sequential indices; ``_TorchConvTranspose`` kernels
  flipped back, ``srm/A`` -> ``srm.self_repr.weight``);
- the pytorch-fid ``InceptionV3FID`` (``metrics_inception.py``): its
  scopes are pytorch-fid's names already; each BatchNorm's ``scale`` /
  ``bias`` and ``batch_stats`` ``mean`` / ``var`` -> ``weight`` /
  ``bias`` / ``running_mean`` / ``running_var``.

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
# a convolution's JAX scope by convolution type: 'default' Conv_i, 'mp'
# MagnitudePreservingConv_i, 'circular' CircularConv_i/Conv_0
_CONV = re.compile(r"^(?:Conv|MagnitudePreservingConv|CircularConv)_(\d+)"
                   r"(?:/Conv_0)?$")
_TIME_DENSE = re.compile(
    r"^ResnetTimeBlock_0/(?:MagnitudePreserving)?Dense_(\d+)$")
_NORM_CLASS = {"GroupLN": "GroupLNorm", "GroupRMS": "GroupRMSNorm",
               "GroupPix": "GroupPixNorm"}
# flax's nn.Embed table [num, features] is torch's nn.Embedding weight
_LEAF = {"kernel": "weight", "w_mp": "weight", "bias": "bias",
         "scale": "weight", "embedding": "weight"}
_ATTN = re.compile(r"^attn_(\d+)$")
_SLICE = re.compile(r"^slice_embedding/(Conv|GroupNorm)_(\d+)$")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _layout(w: np.ndarray, leaf: str) -> np.ndarray:
    """Dense [in, out] -> [out, in], conv [*k, in, out] -> [out, in, *k]
    (``kernel`` and magnitude-preserving ``w_mp`` leaves); others as
    they are."""
    if leaf not in ("kernel", "w_mp"):
        return w
    if w.ndim == 2:
        return w.T
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd) + tuple(range(nd)))


def _attention(leaves: dict, prefix: str) -> dict:
    """Per-head MultiHeadAttention leaves -> the port's names: with
    biases (the 'default' path) torch MultiheadAttention's packed
    projections; without (cosine / mp, ``w_*`` or ``w_mp_*``) the
    reference's ``{q,k,v,o}_proj_matrix`` [H, C, dh] as they are."""
    if "bias_q" not in leaves:
        return {f"{prefix}.{n}_proj_matrix": leaves[
            f"w_mp_{n}" if f"w_mp_{n}" in leaves else f"w_{n}"]
            for n in "qkvo"}
    wq, wk, wv, wo = (leaves[f"w_{n}"] for n in "qkvo")
    H, C, dh = wq.shape
    out = {f"{prefix}.in_proj_weight": np.concatenate(
        [w.transpose(0, 2, 1).reshape(H * dh, C) for w in (wq, wk, wv)])}
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [leaves[f"bias_{n}"].reshape(H * dh) for n in "qkv"])
    out[f"{prefix}.out_proj.weight"] = wo.transpose(1, 0, 2).reshape(C, H * dh)
    out[f"{prefix}.out_proj.bias"] = leaves["bias_o"]
    return out


def _norm_scopes(norms) -> dict:
    """The JAX auto-names of a ResnetBlockC's two norms (flax numbers them
    per class) -> gnorm1 / gnorm2."""
    first, second = (_NORM_CLASS.get(n) for n in norms)
    out = {}
    if first is not None:
        out[f"{first}_0"] = "gnorm1"
    if second is not None:
        out[f"{second}_{1 if second == first else 0}"] = "gnorm2"
    return out


def _embedder_state(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    """An embedder's JAX leaves (``embedders.py``) -> the port's names:
    GaussianFourierProjection_0 -> gaussian_proj, Dense_i -> net.{2i},
    the curve embedder inside a transformer -> embedder, CompositeEmbedder's
    embedders_i -> embedders.i, _TransformerEncoder_0 -> encoder.layers
    (flax attention q/k/v [E, H, hd] packed into in_proj, LayerNorm_k ->
    layers.{k//2}.norm{k%2+1}, Dense_k -> layers.{k//2}.linear{k%2+1});
    a bare Dense or Conv embedding's leaves go directly under
    ``prefix``."""
    out, attn = {}, {}
    for path, w in _flatten(tree):
        leaf, scopes, names, i = path[-1], path[:-1], [], 0
        while i < len(scopes):
            kind, _, idx = scopes[i].rpartition("_")
            if scopes[i] == "_TransformerEncoder_0":
                sub, _, k = scopes[i + 1].rpartition("_")
                k = int(k)
                if sub == "MultiHeadDotProductAttention":
                    layer = ".".join(names + [f"encoder.layers.{k}"])
                    attn.setdefault(layer, {})[(scopes[i + 2], leaf)] = w
                    break
                kind = "norm" if sub == "LayerNorm" else "linear"
                names.append(f"encoder.layers.{k // 2}.{kind}{k % 2 + 1}")
                i += 1
            elif kind == "GaussianFourierProjection":
                names.append("gaussian_proj")
            elif kind == "Dense":
                names.append(f"net.{2 * int(idx)}")
            elif kind in ("TwoPointCorrelationEmbedder",
                          "PoreSizeDistEmbedder"):
                names.append("embedder")
            elif kind == "embedders":
                names.append(f"embedders.{idx}")
            else:
                raise KeyError(f"no port name for JAX embedder scope "
                               f"{'/'.join(path)}")
            i += 1
        else:
            out[".".join([prefix] + names + [_LEAF.get(leaf, leaf)])] = \
                _layout(w, leaf)
    for layer, leaves in attn.items():
        E = leaves[("query", "kernel")].shape[0]
        base = f"{prefix}.{layer}.self_attn"
        out[f"{base}.in_proj_weight"] = np.concatenate(
            [leaves[(n, "kernel")].reshape(E, E).T
             for n in ("query", "key", "value")])
        out[f"{base}.in_proj_bias"] = np.concatenate(
            [leaves[(n, "bias")].reshape(E) for n in ("query", "key",
                                                       "value")])
        out[f"{base}.out_proj.weight"] = \
            leaves[("out", "kernel")].reshape(E, E).T
        out[f"{base}.out_proj.bias"] = leaves[("out", "bias")]
    return out


def _punetg_state(params: dict, buffers: dict, norms) -> dict:
    """A PUNetG's JAX leaves (params and buffers, without the collection)
    -> the port's state dict (numpy)."""
    resblock = _norm_scopes(norms)
    out, attn = {}, {}
    for coll, tree in (("params", params), ("buffers", buffers)):
        emb = tree.get("conditional_embedding", {})
        out.update(_embedder_state(emb, "conditional_embedding"))
        for path, w in _flatten({k: v for k, v in tree.items()
                                 if k != "conditional_embedding"}):
            m = _ATTN.match(path[0])
            if m and path[1] == "MultiHeadAttention_0":
                attn.setdefault(f"attn_block.{m.group(1)}.mhattn", {})[
                    path[-1]] = w
                continue
            out[_punetg_key(path, resblock)] = _layout(w, path[-1])
    for prefix, leaves in attn.items():
        out.update(_attention(leaves, prefix))
    return out


def _punetg_key(path: tuple, resblock: dict) -> str:
    """JAX leaf path inside PUNetG (without the collection) -> torch key."""
    scope, rest, leaf = path[0], "/".join(path[1:-1]), path[-1]
    name = _LEAF.get(leaf, leaf)
    if scope in ("convin", "convout") and (not rest or _CONV.match(rest)):
        return f"{scope}.{name}"       # a conv, or the Fourier stem's W/bias
    if path in (("time_projection", "W"), ("cond_drop", "null_embedding")):
        return ".".join(path)
    if scope == "projection":          # PUNetGEncoder's EncoderFlattener
        return f"projection.linear.{name}"
    for pattern, repl in _SCOPES:
        if pattern.match(scope):
            prefix = pattern.sub(repl, scope)
            conv = _CONV.match(rest)
            if prefix.endswith(".conv") and conv and conv.group(1) == "0":
                return f"{prefix}.{name}"
            if conv:
                return f"{prefix}.conv{int(conv.group(1)) + 1}.{name}"
            sl = _SLICE.match(rest)
            if sl:
                kind = "norm" if sl.group(1) == "GroupNorm" else "conv"
                return f"{prefix}.slice_embedding.{kind}" \
                       f"{int(sl.group(2)) + 1}.{name}"
            dense = _TIME_DENSE.match(rest)
            if dense:
                return f"{prefix}.timeblock.net.{2 * int(dense.group(1))}." \
                       f"{name}"
            if rest in resblock:
                return f"{prefix}.{resblock[rest]}.{name}"
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


_LDM_BLOCK = {"GroupNorm_0": "norm1", "Conv_0": "conv1",
              "GroupNorm_1": "norm2", "Conv_1": "conv2"}
_LDM_ATTN = {"GroupNorm_0": "norm", "Dense_0": "q", "Dense_1": "k",
             "Dense_2": "v", "Dense_3": "proj_out"}
_LDM_LINEAR_ATTN = {"Dense_0": "to_qkv", "Dense_1": "to_out"}


def _attn_slots(config, side: str) -> list[str]:
    """The port's prefixes of the attention blocks at ``attn_resolutions``
    of the encoder or decoder, in the order flax numbers them."""
    n = len(config.ch_mult)
    if side == "encoder":
        levels, blocks = range(n), config.num_res_blocks
        res = [config.resolution // 2 ** i for i in range(n)]
    else:
        levels, blocks = reversed(range(n)), config.num_res_blocks + 1
        res = [config.resolution // 2 ** i for i in range(n)]
    return [f"down.{i}.attn.{j}" if side == "encoder"
            else f"up.{i}.attn.{j}"
            for i in levels if res[i] in config.attn_resolutions
            for j in range(blocks)]


def _conv_leaf(w: np.ndarray, leaf: str, dense_as_conv: int = 0):
    """A kernel in the port's layout (a Dense kernel as a 1^d conv's when
    ``dense_as_conv`` = d), or a bias / scale as it is."""
    if leaf == "kernel" and dense_as_conv and w.ndim == 2:
        return w.T.reshape(w.shape[1], w.shape[0], *([1] * dense_as_conv))
    return _layout(w, leaf)


def _autoencoder_state(params: dict, config=None) -> dict[str, np.ndarray]:
    """An AutoencoderKL's JAX leaves -> the port's (the torch reference's)
    names."""
    ndim = np.asarray(params["quant_conv"]["kernel"]).ndim - 2
    out = {}
    for path, w in _flatten(params):
        leaf, scopes = path[-1], list(path[:-1])
        name = _LEAF[leaf]
        if scopes[0] in ("quant_conv", "post_quant_conv"):
            out[f"{scopes[0]}.{name}"] = _layout(w, leaf)
            continue
        side, scope, rest = scopes[0], scopes[1], scopes[2:]
        m = re.match(r"^(down|up)_(\d+)_block_(\d+)$", scope)
        attn = re.match(r"^LDM(Linear)?AttnBlock_(\d+)$", scope)
        if scope in ("conv_in", "conv_out", "norm_out"):
            key = scope
        elif m:
            sub = _LDM_BLOCK.get(rest[0])
            if rest[0] == "Conv_2":
                k = np.asarray(params[side][scope]["Conv_2"]["kernel"])
                sub = "nin_shortcut" if k.shape[0] == 1 else "conv_shortcut"
            key = f"{m.group(1)}.{m.group(2)}.block.{m.group(3)}.{sub}"
        elif re.match(r"^(down|up)_(\d+)_(downsample|upsample)$", scope):
            kind, i, what = scope.split("_")
            key = f"{kind}.{i}.{what}.conv"
        elif scope in ("mid_block_1", "mid_block_2"):
            key = f"mid.{scope[4:]}.{_LDM_BLOCK[rest[0]]}"
        elif scope == "mid_attn":
            key = f"mid.attn_1.{_LDM_ATTN[rest[0]]}"
        elif attn:
            if config is None:
                raise ValueError("attention at attn_resolutions needs the "
                                 "DDConfig (config=)")
            slot = _attn_slots(config, side)[int(attn.group(2))]
            table = _LDM_LINEAR_ATTN if attn.group(1) else _LDM_ATTN
            key = f"{slot}.{table[rest[0]]}"
        else:
            raise KeyError(f"no port name for JAX parameter {'/'.join(path)}")
        dense = ndim if "Dense" in "/".join(rest) else 0
        out[f"{side}.{key}.{name}"] = _conv_leaf(w, leaf, dense)
    return out


# VAENet's blocks (flax numbers _StdResBlock_k / MinimalResnetBlock_k in
# call order) -> the reference's names
_VAENET_BLOCK = {
    "_StdResBlock": {"GroupNorm_0": "norm1", "Conv_0": "conv1.conv",
                     "Dense_0": "temb_proj", "GroupNorm_1": "norm2",
                     "Conv_1": "conv2.conv", "Conv_2": "nin_shortcut.conv"},
    "MinimalResnetBlock": {"GroupNorm_0": "norm1", "Conv_0": "conv1.conv",
                           "Dense_0": "temb_proj", "Conv_1": "gate.conv",
                           "Conv_2": "nin_shortcut.conv"}}
_VAENET_ATTN = {"GroupNorm_0": "norm", "Dense_0": "q.conv",
                "Dense_1": "k.conv", "Dense_2": "v.conv",
                "Dense_3": "proj_out.conv"}
_VAENET_TOP = {"conv_in": "conv_in.conv", "conv_out": "conv_out.conv",
               "quant_conv": "quant_conv.conv",
               "post_quant_conv": "post_quant_conv.conv",
               "GroupNorm_0": "norm_out"}
_TIME_EMBED = {"GaussianFourierProjection_0": "fourier",
               "Dense_0": "linear_1", "Dense_1": "linear_2"}


def _vaenet_slots(side: dict, encoder: bool, config=None) -> dict:
    """The flax scopes of one side of a VAENet's blocks and resamplers ->
    the port's prefixes. The levels are the config's or, without one, one
    more than the resamplers (which hold weights with
    ``resamp_with_conv``); the blocks a level are those beyond the
    middle's two over the levels."""
    blocks = sorted((s for s in side if re.match(
        r"^(_StdResBlock|MinimalResnetBlock)_\d+$", s)),
        key=lambda s: int(s.rsplit("_", 1)[1]))
    n = config.num_resolutions if config is not None else 1 + sum(
        1 for s in side if re.match(r"^LDM(Down|Up)sample_\d+$", s))
    per_level = (len(blocks) - 2) // n
    if encoder:
        order = [f"down.{i}.block.{j}" for i in range(n)
                 for j in range(per_level)] + ["mid.block_1", "mid.block_2"]
    else:
        order = ["mid.block_1", "mid.block_2"] + [
            f"up.{i}.block.{j}" for i in reversed(range(n))
            for j in range(per_level)]
    out = dict(zip(blocks, order))
    for k in range(n - 1):
        if encoder:
            out[f"LDMDownsample_{k}"] = f"down.{k}.downsample.conv"
        else:
            out[f"LDMUpsample_{k}"] = f"up.{n - 1 - k}.upsample.conv.conv"
    return out


def _vaenet_state(params: dict, buffers: dict,
                  config=None) -> dict[str, np.ndarray]:
    """A VAENet's JAX leaves -> the port's (the torch reference's) names.
    Attention at ``attn_resolutions`` needs the ``VAENetConfig``
    (``config=``) to place its blocks."""
    ndim = np.asarray(params["encoder"]["quant_conv"]["kernel"]).ndim - 2
    out = {}
    for side_name in ("encoder", "decoder"):
        side = params[side_name]
        slots = _vaenet_slots(side, side_name == "encoder", config)
        attns = sorted((s for s in side if re.match(
            r"^LDM(Linear)?AttnBlock_\d+$", s)),
            key=lambda s: int(s.rsplit("_", 1)[1]))
        if attns:
            if config is None:
                raise ValueError("attention at attn_resolutions needs the "
                                 "VAENetConfig (config=)")
            # the same levels and counts as AutoencoderKL's
            slots.update(zip(attns, _attn_slots(config, side_name)))
        tree = {"params": side, "buffers": buffers.get(side_name, {})}
        for coll, sub in tree.items():
            for path, w in _flatten(sub):
                leaf, scope, rest = path[-1], path[0], list(path[1:-1])
                if scope == "time_embed":
                    key = f"time_embed.{_TIME_EMBED[rest[0]]}"
                    name = leaf if coll == "buffers" else _LEAF[leaf]
                    out[f"{side_name}.{key}.{name}"] = _layout(w, leaf)
                    continue
                name = _LEAF[leaf]
                dense = 0
                if scope in _VAENET_TOP:
                    key = _VAENET_TOP[scope]
                elif scope == "mid_attn":
                    key = f"mid.attn_1.{_VAENET_ATTN[rest[0]]}"
                    dense = ndim
                elif re.match(r"^LDMAttnBlock_\d+$", scope):
                    key = f"{slots[scope]}.{_VAENET_ATTN[rest[0]]}"
                    dense = ndim
                elif re.match(r"^LDMLinearAttnBlock_\d+$", scope):
                    key = f"{slots[scope]}.{_LDM_LINEAR_ATTN[rest[0]]}"
                    dense = ndim
                elif re.match(r"^LDM(Down|Up)sample_\d+$", scope):
                    key = slots[scope]
                elif scope in slots:
                    kind = scope.rsplit("_", 1)[0]
                    sub_name = _VAENET_BLOCK[kind][rest[0]]
                    key = f"{slots[scope]}.{sub_name}"
                else:
                    raise KeyError("no port name for JAX parameter "
                                   f"{side_name}/{'/'.join(path)}")
                out[f"{side_name}.{key}.{name}"] = _conv_leaf(w, leaf, dense)
    return out


def _discriminator_state(params: dict) -> dict[str, np.ndarray]:
    """An NLayerDiscriminator's Conv_i / GroupNorm_i -> convs.i /
    norms.i."""
    out = {}
    for path, w in _flatten(params):
        kind, i = path[0].rsplit("_", 1)
        out[f"{'convs' if kind == 'Conv' else 'norms'}.{i}."
            f"{_LEAF[path[-1]]}"] = _layout(w, path[-1])
    return out


def _is_discriminator(params: dict) -> bool:
    return "Conv_0" in params and all(
        re.match(r"^(Conv|GroupNorm)_\d+$", k) for k in params) and \
        np.asarray(params["Conv_0"]["kernel"]).ndim >= 3


def _is_vaenet(params: dict) -> bool:
    return "encoder" in params and "decoder" in params and \
        "quant_conv" in params["encoder"]


def _unet2d_state(params: dict) -> dict[str, np.ndarray]:
    return {_unet2d_key(path): _layout(w, path[-1])
            for path, w in _flatten(params)}


def _mlp_state(params: dict) -> dict[str, np.ndarray]:
    out = {}
    for path, w in _flatten(params):
        i = int(path[0].split("_")[1])
        out[f"net.{2 * i}.{_LEAF[path[-1]]}"] = _layout(w, path[-1])
    return out


def _flip_transposed(w: np.ndarray) -> np.ndarray:
    """A flax transposed-convolution kernel [*k, I, O], spatially flipped
    against torch's (lax.conv_transpose, the JAX DASC's
    ``_TorchConvTranspose``) -> torch's [I, O, *k]."""
    nd = w.ndim - 2
    w = w[tuple(slice(None, None, -1) for _ in range(nd))]
    return np.ascontiguousarray(
        np.transpose(w, (nd, nd + 1) + tuple(range(nd))))


def _leaf_key(prefix: str, leaf: str) -> str:
    return f"{prefix}.{_LEAF.get(leaf, leaf)}"


def _embedding_leaves(params: dict, buffers: dict) -> dict:
    """A net's ``conditional_embedding`` scope, params and buffers."""
    out = _embedder_state(params.get("conditional_embedding", {}),
                          "conditional_embedding")
    out.update(_embedder_state(buffers.get("conditional_embedding", {}),
                               "conditional_embedding"))
    return out


_ADM_SCOPE = [
    (re.compile(r"^enc_(\d+)_block_(\d+)$"),
     r"encoder.layers.\1.input_blocks.\2"),
    (re.compile(r"^dec_(\d+)_block_(\d+)$"),
     r"decoder.layers.\1.input_blocks.\2"),
    (re.compile(r"^mid_block_(\d+)$"), r"middle_block.middle_blocks.\1"),
]
_ADM_CONV = ("conv1", "conv2", "convresidual")


def _adm_state(params: dict, buffers: dict, norms) -> dict:
    """An ADM's JAX leaves -> the torch reference's names."""
    norm_names = {k: v.replace("gnorm", "norm")
                  for k, v in _norm_scopes(norms).items()}
    out, attn = _embedding_leaves(params, buffers), {}
    for path, w in _flatten({k: v for k, v in params.items()
                             if k != "conditional_embedding"}):
        scope, rest, leaf = path[0], "/".join(path[1:-1]), path[-1]
        if scope == "time_embedding":
            idx = int(rest.split("_")[-1])
            out[_leaf_key(f"time_embedding.mlp.{2 * idx}", leaf)] = \
                _layout(w, leaf)
            continue
        if scope in ("input_layer", "output_layer"):
            out[_leaf_key(scope, leaf)] = _layout(w, leaf)
            continue
        prefix = next(p.sub(r, scope) for p, r in _ADM_SCOPE
                      if p.match(scope))
        if rest.startswith("SpatialSelfAttention_0/"):
            attn.setdefault(f"{prefix}.attn.mhattn", {})[leaf] = w
            continue
        conv = _CONV.match(rest)
        if conv:
            sub = _ADM_CONV[int(conv.group(1))]
        elif rest == "Dense_0":
            sub = "embed_linear"
        else:
            sub = norm_names[rest]
        out[_leaf_key(f"{prefix}.{sub}", leaf)] = _layout(w, leaf)
    for path, w in _flatten(buffers.get("time_embedding", {})):
        out["time_embedding.projection.W"] = w
    for prefix, leaves in attn.items():
        out.update(_attention(leaves, prefix))
    return out


_DIT_TOP = {"Dense_0": "time_mlp_in", "Dense_1": "time_mlp_mid",
            "Dense_2": "time_mlp_out", "Dense_3": "token_embed",
            "Dense_4": "token_head"}
_DIT_BLOCK = {"Dense_0": "adaln", "LayerNorm_0": "norm1",
              "LayerNorm_1": "norm2", "Dense_1": "mlp_in",
              "Dense_2": "mlp_out"}
_DIT_BLOCK_SCOPE = re.compile(r"^(?:moe_)?block_(\d+)$")


def _dit_state(params: dict, buffers: dict) -> dict:
    """A DiT's or MoE-DiT's JAX leaves -> the port's names."""
    out, attn = {}, {}
    for path, w in _flatten(params):
        scope, leaf = path[0], path[-1]
        if scope in _DIT_TOP:
            out[_leaf_key(_DIT_TOP[scope], leaf)] = _layout(w, leaf)
            continue
        prefix = f"blocks.{_DIT_BLOCK_SCOPE.match(scope).group(1)}"
        sub = path[1]
        if sub == "MultiHeadAttention_0":
            attn.setdefault(f"{prefix}.attn", {})[leaf] = w
        elif sub == "moe":
            out[f"{prefix}.moe.{leaf}"] = w
        else:
            out[_leaf_key(f"{prefix}.{_DIT_BLOCK[sub]}", leaf)] = \
                _layout(w, leaf)
    for path, w in _flatten(buffers.get("GaussianFourierProjection_0", {})):
        out["time_proj.W"] = w
    for prefix, leaves in attn.items():
        out.update(_attention(leaves, prefix))
    return out


_SWIGLU = ("linear_in", "linear_gate", "linear_out")


def _convit_state(params: dict, buffers: dict, batch_stats: dict) -> dict:
    """A ConVit's JAX leaves -> the torch reference's names."""
    out = _embedding_leaves(params, buffers)
    for path, w in _flatten({k: v for k, v in params.items()
                             if k != "conditional_embedding"}):
        scope, leaf = path[0], path[-1]
        if scope in ("convin", "convout", "normout"):
            out[_leaf_key(scope, leaf)] = _layout(w, leaf)
            continue
        if scope == "BatchNorm_0":
            out[_leaf_key("input_batch_norm", leaf)] = w
            continue
        prefix = f"blocks.{scope.split('_')[1]}"
        sub = path[1]
        if sub == "fusion_weight":
            out[f"{prefix}.fusion_weight"] = w
        elif sub == "_SwiGLU_0":
            name = ("rms" if path[2] == "RMSNorm_0" else
                    _SWIGLU[int(path[2].split("_")[1])])
            out[_leaf_key(f"{prefix}.embedding_projection.{name}", leaf)] = \
                _layout(w, leaf)
        elif sub.startswith("ChannelRMSNorm_"):
            out[f"{prefix}.norm_{int(sub.split('_')[1]) + 1}.weight"] = w
        elif sub == "ConVitAttention_0":
            if path[2] == "rope":
                out[f"{prefix}.attention.rope_layer.angles"] = w
            else:
                name = "out" if leaf == "o" else leaf
                out[f"{prefix}.attention.{name}_proj_tensor"] = w
                if leaf == "q":
                    out[f"{prefix}.attention.scale"] = np.asarray(
                        np.sqrt(w.shape[1]), np.float32)
        elif sub == "ConvSwiGLU_0":
            name = _SWIGLU[int(path[2].split("_")[1])]
            out[_leaf_key(f"{prefix}.ffn.{name}", leaf)] = _layout(w, leaf)
        elif sub == "ConvTranspose_0":
            out[_leaf_key(f"{prefix}.upsample.conv", leaf)] = (
                _flip_transposed(w) if leaf == "kernel" else w)
        else:                     # Conv_i: [downsample,] depthwise, 1×1
            shift = 0 if "Conv_2" in params[scope] else 1
            name = ("downsample.conv", "depthwise_conv",
                    "pointwise_conv")[int(sub.split("_")[1]) + shift]
            out[_leaf_key(f"{prefix}.{name}", leaf)] = _layout(w, leaf)
    if "GaussianFourierProjection_0" in buffers:
        out["time_embedding.W"] = buffers["GaussianFourierProjection_0"]["W"]
    for path, w in _flatten(batch_stats.get("BatchNorm_0", {})):
        out[f"input_batch_norm.running_{path[-1]}"] = w
    return out


def _classifier_state(params: dict) -> dict:
    """MinimalResNet's JAX leaves -> the torch reference's names."""
    out = {}
    for path, w in _flatten(params):
        scope, leaf = path[0], path[-1]
        if scope in ("in_conv", "out"):
            out[_leaf_key(scope, leaf)] = _layout(w, leaf)
            continue
        kind, i = path[1].split("_")
        sub = f"{'norm' if kind == 'GroupNorm' else 'conv'}{int(i) + 1}"
        out[_leaf_key(f"res_blocks.{scope.split('_')[1]}.{sub}", leaf)] = \
            _layout(w, leaf)
    return out


def _dasc_state(params: dict) -> dict:
    """DASC's JAX leaves -> the torch reference's (Sequential) names."""
    ae = params["auto_encoder"]
    n = sum(1 for k in ae if k.startswith("enc_conv_"))
    seq = {"enc_out": f"encoder.{2 * n + 2}", "dec_in": "decoder.0",
           "dec_out": f"decoder.{2 * n + 1}"}
    seq.update({f"enc_conv_{i}": f"encoder.{2 * i}" for i in range(n)})
    seq.update({f"dec_conv_{i}": f"decoder.{3 + 2 * i}"
                for i in range(n - 1)})
    out = {}
    for path, w in _flatten(ae):
        scope, leaf = path[0], path[-1]
        transposed = scope.startswith("dec_") and scope != "dec_in"
        out[_leaf_key(f"auto_encoder.{seq[scope]}", leaf)] = (
            _flip_transposed(w) if transposed and leaf == "kernel"
            else _layout(w, leaf))
    for path, w in _flatten(params["vmm"]):
        if path[0] == "query":
            out["vmm.query"] = w
        else:
            i = path[0].split("_")[-1]
            out[_leaf_key(f"vmm.attention_layers.{i}", path[-1])] = \
                _layout(w, path[-1])
    out["srm.self_repr.weight"] = np.asarray(params["srm"]["A"])
    for path, w in _flatten(params.get("frm_transform", {})):
        out[_leaf_key("frm_transform", path[-1])] = _layout(w, path[-1])
    return out


def _inception_state(params: dict, batch_stats: dict) -> dict:
    """InceptionV3FID's JAX leaves -> pytorch-fid's names: each
    BasicConv2d's ``conv/kernel`` [kh, kw, I, O] -> ``conv.weight`` [O, I,
    kh, kw], ``bn/scale``, ``bn/bias`` -> ``bn.weight``, ``bn.bias`` and the
    ``batch_stats`` ``bn/mean``, ``bn/var`` -> ``bn.running_mean``,
    ``bn.running_var``."""
    out = {}
    for path, w in _flatten(params):
        out[_leaf_key(".".join(path[:-1]), path[-1])] = _layout(w, path[-1])
    for path, w in _flatten(batch_stats):
        out[f"{'.'.join(path[:-1])}.running_{path[-1]}"] = w
    return out


_BOTTOM = {"before_block": "bottom_blocks.0",
           "attn_resnet_block": "bottom_blocks.1",
           "attn_block": "bottom_blocks.2", "after_block": "bottom_blocks.3"}


def _encoder_state(params: dict, buffers: dict, norms) -> dict:
    """PUNetGEncoder: PUNetG's names with the bottleneck's lists under
    ``bottom_blocks``."""
    out = {}
    for k, v in _punetg_state(params, buffers, norms).items():
        head, _, rest = k.partition(".")
        out[f"{_BOTTOM[head]}.{rest}" if head in _BOTTOM else k] = v
    return out


def _tensors(state: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    return {prefix + k: torch.from_numpy(np.array(v, copy=True))
            for k, v in state.items()}


def _net_state(params: dict, buffers: dict, norms,
               batch_stats: dict | None = None) -> dict:
    """A bare network's JAX leaves -> the port's state dict (numpy):
    UNet2D (or HFNet, scope ``unet``), an MLP, DASC, MinimalResNet, ADM,
    ConVit, DiT / MoE-DiT, PUNetG's encoder or decoder half, PUNetGCond
    (or PUNetGDeterministic) or PUNetG (or PUNetV), told apart by their
    keys."""
    if "auto_encoder" in params and "srm" in params:
        return _dasc_state(params)
    if "in_conv" in params and "out" in params:
        return _classifier_state(params)
    if "input_layer" in params and "time_embedding" in params:
        return _adm_state(params, buffers, norms)
    if "normout" in params:
        return _convit_state(params, buffers, batch_stats or {})
    if "Dense_3" in params and any(map(_DIT_BLOCK_SCOPE.match, params)):
        return _dit_state(params, buffers)
    if "convin" in params and "convout" not in params:
        return _encoder_state(params, buffers, norms)
    if "convout" in params and "convin" not in params and \
            "unet" not in params:
        return _punetg_state(params, buffers, norms)
    if "unet" in params and "conv_in" in params["unet"]:
        return {f"unet.{k}": v
                for k, v in _unet2d_state(params["unet"]).items()}
    if "conv_in" in params:
        return _unet2d_state(params)
    if params and all(k.startswith("Dense_") for k in params):
        return _mlp_state(params)
    if "unet" in params:
        # PUNetGCond: flax keeps its embedding beside ``unet``, the port's
        # inner PUNetG holds it
        def inner(tree):
            return {**tree.get("unet", {}), **{
                k: v for k, v in tree.items() if k != "unet"}}

        return {f"unet.{k}": v for k, v in _punetg_state(
            inner(params), inner(buffers), norms).items()}
    return _punetg_state(params, buffers, norms)


def from_jax_variables(variables_np: dict,
                       config=None) -> dict[str, torch.Tensor]:
    """State dict of the port's network from JAX-package variables: PUNetG
    or PUNetGCond (scope ``unet``), UNet2D (or HFNet, scope ``unet``) or an
    MLP, ADM, DiT or MoE-DiT, ConVit, a PUNetG variant, MinimalResNet or
    DASC, told apart by their keys, or the KarrasNet around one (scope
    ``model``, with ``dlw``, the ``batch_stats`` of ``bnorm`` and a
    ``KarrasEncoderModel``'s ``encoder_model``, which covers
    ``EnsembleKarrasModel`` too); an AutoencoderKL, or a ``VAEModel``'s
    network (scope ``autoencoder``, ``logvar``); an ``SIModel``'s with its
    running initial norm (``batch_stats/initial_norm``: the network at
    scope ``model`` and ``initial_norm.mean``/``.var``, the names of its
    ``RuntimeNet``; without that norm an ``SIModel``'s variables are its
    network's, which load into ``model.net.model``); the pytorch-fid
    ``InceptionV3FID`` (its ``params`` and ``batch_stats``). ``config``: the
    PUNetG's (or ADM's, PUNetV's) config, which names its norms (default
    GroupLN then GroupRMS), or the autoencoder's ``DDConfig`` (needed for
    attention at ``attn_resolutions``)."""
    params = variables_np.get("params", {})
    buffers = variables_np.get("buffers", {})
    stats = variables_np.get("batch_stats", {})
    if "initial_norm" in stats:
        # an SIModel's running initial norm beside its bare network
        out = {f"model.{k}": v for k, v in from_jax_variables(
            dict(variables_np, batch_stats={
                k: v for k, v in stats.items() if k != "initial_norm"}),
            config).items()}
        out.update(_tensors(stats["initial_norm"], "initial_norm."))
        return out
    if "Conv2d_1a_3x3" in params:
        return _tensors(_inception_state(params, stats))
    if "quant_conv" in params:
        return _tensors(_autoencoder_state(params, config))
    if _is_vaenet(params):
        return _tensors(_vaenet_state(params, buffers, config))
    if _is_discriminator(params):
        return _tensors(_discriminator_state(params))
    if "autoencoder" in params:
        inner = params["autoencoder"]
        out = {f"autoencoder.{k}": v for k, v in (
            _vaenet_state(inner, buffers.get("autoencoder", {}), config)
            if _is_vaenet(inner) else
            _autoencoder_state(inner, config)).items()}
        if "logvar" in params:
            out["logvar"] = np.asarray(params["logvar"])
        return _tensors(out)
    norms = (("GroupLN", "GroupRMS") if getattr(
        config, "first_resblock_norm", None) is None else
        (config.first_resblock_norm, config.second_resblock_norm))
    wrapped = "model" in params
    out = {}
    if wrapped:
        dlw_params = params.get("dlw", {})
        for path, w in _flatten(dlw_params):
            out[f"dlw.linear.{_LEAF[path[-1]]}"] = _layout(w, path[-1])
        for path, w in _flatten(buffers.get("dlw", {})):
            out[f"dlw.{path[-1]}"] = w
        for path, w in _flatten(variables_np.get("batch_stats", {})):
            out[".".join(path)] = w
        if "encoder_model" in params:
            out.update({f"encoder_model.{k}": v for k, v in _net_state(
                params["encoder_model"], buffers.get("encoder_model", {}),
                norms).items()})
        params, buffers = params["model"], buffers.get("model", {})
    out.update({f"model.{k}" if wrapped else k: v
                for k, v in _net_state(params, buffers, norms,
                                       stats.get("model", {}) if wrapped
                                       else stats).items()})
    return _tensors(out)


def _field(obj, name):
    """A field of a JAX-package state read as numpy: a dataclass or
    NamedTuple attribute, or a dict key (a raw restore)."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _find(tree, fields: tuple):
    """The first node of an optax state (NamedTuples, tuples, dicts) that
    has every one of ``fields``, or None."""
    if all(hasattr(tree, f) for f in fields) or (
            isinstance(tree, dict) and all(f in tree for f in fields)):
        return tree
    children = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (tuple, list)) else ()
    for child in children:
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _overlay(full: dict, part, leaf_fn) -> dict:
    """``full`` with the leaves that ``part`` (a sub-tree) holds replaced
    by ``leaf_fn`` of ``part``'s."""
    out = {}
    for k, v in full.items():
        if part is None or k not in part:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _overlay(v, part[k], leaf_fn)
        else:
            out[k] = leaf_fn(np.asarray(part[k], np.float32))
    return out


def from_jax_reg_reference(reference_np: dict, params_np: dict,
                           config=None) -> dict[str, torch.Tensor]:
    """The port's L2-SP reference (name -> tensor, for
    ``l2_sp_regularization``) from the JAX package's
    (``select_regularization_reference``: a sub-tree of the params, read
    as numpy), completed by ``params_np`` (the full params tree). A port
    tensor packed from several JAX leaves (attention's in_proj) is in the
    reference when any of them is, with the others' current values."""
    ref = from_jax_variables({"params": _overlay(params_np, reference_np,
                                                  lambda a: a)}, config)
    marked = from_jax_variables({"params": _overlay(
        params_np, reference_np, lambda a: np.full_like(a, np.nan))},
        config)
    return {k: ref[k] for k, v in marked.items() if bool(v.isnan().any())}


def _has_field(obj, name) -> bool:
    return name in obj if isinstance(obj, dict) else hasattr(obj, name)


def _load_optimizer(optimizer, params: dict, opt_state,
                    port_params) -> None:
    """An optax state read as numpy into the port's optimizer over
    ``params`` (name -> tensor): a ``ScaleByAdamState``'s ``count``, ``mu``
    and ``nu`` to AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` (a
    bfloat16 ``mu`` too), or a ``ScheduleFreeState``'s ``z``,
    ``weight_sum``, ``max_lr`` and its RMS ``count`` and ``nu`` to
    ``ScheduleFreeAdamW``'s state. ``port_params`` maps a JAX params tree
    to the port's names."""
    sf = _find(opt_state, ("weight_sum", "max_lr", "z"))
    if sf is not None:
        rms = _find(_field(sf, "base_optimizer_state"), ("count", "nu"))
        scalars = {"step": _field(rms, "count"),
                   "weight_sum": _field(sf, "weight_sum"),
                   "max_lr": _field(sf, "max_lr")}
        sources = (("z", sf, "z"), ("exp_avg_sq", rms, "nu"))
    else:
        adam = _find(opt_state, ("count", "mu", "nu"))
        if adam is None:
            raise ValueError("the JAX optimizer state holds no Adam state")
        scalars = {"step": _field(adam, "count")}
        sources = (("exp_avg", adam, "mu"), ("exp_avg_sq", adam, "nu"))
    # a bfloat16 first moment (mu_dtype) passes through float32
    moments = {key: port_params(_as_f32(_field(node, src)))
               for key, node, src in sources}
    names = {id(p): k for k, p in params.items()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            slot = optimizer.state[p]
            for key, value in scalars.items():
                slot[key].fill_(float(np.asarray(value)))
            for key, values in moments.items():
                slot[key].copy_(values[names[id(p)]])


def _vae_train_state(state_np, model, tx, dtx):
    """A JAX ``VAETrainState`` (read as numpy) -> the port's, made in place
    over a fresh state of ``tx`` and ``dtx``."""
    from diffsci_tpu_torch.models.vae.module import create_vae_train_state

    config = getattr(model.net.autoencoder, "config", None)
    params = _field(state_np, "params")
    consts = _field(state_np, "consts") or {}
    state, _, _ = create_vae_train_state(model, seed=None, optimizer=tx,
                                         disc_optimizer=dtx)
    with torch.no_grad():
        model.net.load_state_dict(from_jax_variables(
            {"params": params, **consts}, config), strict=True)
        _load_optimizer(state.optimizer, state.params,
                        _field(state_np, "opt_state"),
                        lambda tree: from_jax_variables({"params": tree},
                                                        config))
        disc = _field(state_np, "disc_params")
        if model.is_adversarial and disc is not None:
            model.discriminator.load_state_dict(
                from_jax_variables({"params": disc}), strict=True)
            _load_optimizer(state.disc_optimizer, state.disc_params,
                            _field(state_np, "disc_opt_state"),
                            lambda tree: from_jax_variables({"params": tree}))
        step = int(np.asarray(_field(state_np, "step")))
        state.counter.fill_(step)
    state.step = step
    return state


def from_jax_train_state(state_np, model, tx, ema=None, reg_reference=None,
                         dtx=None):
    """The port's ``TrainState`` over ``model`` from a JAX-package
    ``TrainState`` read as numpy (``jax.tree.map(np.asarray, state)``,
    e.g. after the JAX package's ``restore_checkpoint``), made in place
    over a fresh state of ``tx`` (the port's optimizer matching the JAX
    run's) and ``ema`` (its EMA tracker): params and consts through
    ``from_jax_variables``; optax's ``ScaleByAdamState`` ``count``, ``mu``
    and ``nu`` to AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` by the
    same names and layouts (a bfloat16 ``mu`` too), or a
    ``ScheduleFreeState``'s ``z``, ``weight_sum``, ``max_lr`` and its RMS
    ``count`` and ``nu`` to ``ScheduleFreeAdamW``'s state (and
    ``MultiSteps``' accumulated gradients and counters under
    ``accumulate_gradients``); the EMA profiles and their
    ``num_updates``; the step. This carries a TPU run over to the card,
    an ``EnsembleKarrasModel``'s too (its state is a ``KarrasModel``'s);
    with ``reg_reference`` (the JAX run's L2-SP reference, numpy) it
    returns (state, the port's reference, ``from_jax_reg_reference``).

    A JAX ``VAETrainState`` (it has ``disc_params``) gives the port's
    ``VAETrainState`` over a ``VAEModel``: the autoencoder's params and
    consts, the discriminator's params, both AdamW states (``tx`` the
    autoencoder's optimizer, ``dtx`` the discriminator's), and the step,
    also into the device counter the frequency gate reads; so a VAE
    trained by the JAX package resumes on the card."""
    from diffsci_tpu_torch.models.karras.train import _new_train_state
    from diffsci_tpu_torch.models.runtime import RuntimeNet

    if _has_field(state_np, "disc_params"):
        return _vae_train_state(state_np, model, tx, dtx)
    config = getattr(model.net.model, "config", None)
    if not hasattr(config, "first_resblock_norm"):
        config = None

    def port_variables(tree) -> dict[str, torch.Tensor]:
        out = from_jax_variables(tree, config)
        # the JAX variables of the runtimes held as a RuntimeNet (SIModel,
        # ...) are their bare network's
        if isinstance(model.net, RuntimeNet) and \
                "initial_norm" not in tree.get("batch_stats", {}):
            out = {f"model.{k}": v for k, v in out.items()}
        return out

    def port_params(tree) -> dict[str, torch.Tensor]:
        return port_variables({"params": tree})

    params = _field(state_np, "params")
    consts = _field(state_np, "consts") or {}
    state = _new_train_state(model, tx, ema)
    with torch.no_grad():
        model.net.load_state_dict(
            port_variables({"params": params, **consts}), strict=True)
        opt_state = _field(state_np, "opt_state")
        _load_optimizer(state.optimizer, state.params, opt_state,
                        port_params)
        if state.accum is not None:
            multi = _find(opt_state, ("mini_step", "gradient_step",
                                      "acc_grads"))
            acc = port_params(_field(multi, "acc_grads"))
            for name, g in state.accum.grads.items():
                g.copy_(acc[name])
            state.accum.mini_step = int(_field(multi, "mini_step"))
            state.accum.gradient_step = int(_field(multi, "gradient_step"))
        jema = _field(state_np, "ema")
        if state.ema is not None:
            for profile, tree in zip(state.ema.profiles,
                                     _field(jema, "profiles")):
                shadows = port_params(tree)
                for name, v in profile.items():
                    v.copy_(shadows[name])
            state.ema.num_updates = int(_field(jema, "num_updates"))
    state.step = int(_field(state_np, "step"))
    model._masters_changed()
    if reg_reference is not None:
        return state, from_jax_reg_reference(reg_reference, params, config)
    return state
