"""Declarative net descriptions: export a score network as plain data and
rebuild it by ``kind`` tag.

Port of ``diffsci_tpu/models/nets/describe.py``. Each net family exports
``{"kind": ..., "config": {...}}`` with the JAX package's field names,
so a description written by either package rebuilds in the other;
``net_from_description`` rebuilds it from whitelisted constructors only.
Descriptions written before ``kind`` existed carry a PUNetG config dict
and no ``kind`` key; they rebuild as PUNetG. Every kind of the JAX
package rebuilds here: ``punetg``, ``punetg_cond``, ``hfnet``,
``hfnet_cond``, ``unet2d``, ``mlp``, ``mlp_cond``, ``dit``, ``moe_dit``,
``convit`` and ``adm``.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

__all__ = ["plain_module_description", "net_from_description",
           "register_net_kind", "NET_KINDS"]

# kind -> builder(config_kwargs, conditional_embedding, device) -> nn.Module
NET_KINDS: dict[str, Callable[..., Any]] = {}


def register_net_kind(kind: str):
    def deco(builder):
        NET_KINDS[kind] = builder
        return builder
    return deco


def plain_module_description(module, kind: str, cls=None) -> dict[str, Any]:
    """Description of a network whose constructor takes plain data (ints,
    floats, strs, sequences) and keeps each argument as an attribute of
    the same name: the arguments of ``cls.__init__`` (default: the
    module's class) but ``device``, tuples as lists."""
    config = {}
    for name in inspect.signature((cls or type(module)).__init__).parameters:
        if name in ("self", "device"):
            continue
        value = getattr(module, name)
        if isinstance(value, tuple):
            value = list(value)
        config[name] = value
    return dict(kind=kind, config=config)


def _builder(kind, cls_of: Callable[[], type], tuples=()):
    """Register a builder of ``cls_of()`` (imported when called) that
    turns the listed config keys back into tuples (JSON gives lists)."""

    @register_net_kind(kind)
    def build(config: dict, conditional_embedding=None, device=None):
        config = dict(config)
        for key in tuples:
            if key in config and config[key] is not None:
                config[key] = tuple(config[key])
        if conditional_embedding is not None:
            config["conditional_embedding"] = conditional_embedding
        return cls_of()(**config, device=device)

    return build


def _hfnet(name):
    def cls_of():
        from diffsci_tpu_torch.models.nets import hfnet
        return getattr(hfnet, name)
    return cls_of


def _unet2d():
    from diffsci_tpu_torch.models.nets.ddpm_unet import UNet2D
    return UNet2D


def _mlp(name):
    def cls_of():
        from diffsci_tpu_torch.models.nets import mlp
        return getattr(mlp, name)
    return cls_of


_builder("hfnet", _hfnet("HFNet"), tuples=("block_channels",))
_builder("hfnet_cond", _hfnet("HFNetCond"), tuples=("block_channels",))
_builder("unet2d", _unet2d,
         tuples=("block_out_channels", "attn_down", "attn_up"))
_builder("mlp", _mlp("MLPUncond"), tuples=("hidden_dims",))
_builder("mlp_cond", _mlp("MLPCond"), tuples=("hidden_dims",))


def _dit():
    from diffsci_tpu_torch.models.nets.dit import DiffusionTransformer
    return DiffusionTransformer


def _moe_dit():
    from diffsci_tpu_torch.models.nets.moe import MoEDiffusionTransformer
    return MoEDiffusionTransformer


_builder("dit", _dit)
_builder("moe_dit", _moe_dit)


@register_net_kind("convit")
def _build_convit(config: dict, conditional_embedding=None, device=None):
    from diffsci_tpu_torch.models.nets.convit import ConVit, ConVitConfig
    return ConVit(ConVitConfig(**config),
                  conditional_embedding=conditional_embedding, device=device)


@register_net_kind("adm")
def _build_adm(config: dict, conditional_embedding=None, device=None):
    from diffsci_tpu_torch.models.nets.adm import ADM, ADMConfig
    return ADM(ADMConfig.from_description(config),
               conditional_embedding=conditional_embedding, device=device)


@register_net_kind("punetg")
def _build_punetg(config: dict, conditional_embedding=None, device=None):
    from diffsci_tpu_torch.models.nets.punetg import PUNetG, PUNetGConfig
    return PUNetG(PUNetGConfig.from_description(config),
                  conditional_embedding=conditional_embedding, device=device)


@register_net_kind("punetg_cond")
def _build_punetg_cond(config: dict, conditional_embedding=None,
                       device=None):
    from diffsci_tpu_torch.models.nets.punetg import PUNetGCond, PUNetGConfig
    config = dict(config)
    items = tuple(config.pop("channel_conditional_items", ()))
    return PUNetGCond(PUNetGConfig.from_description(config),
                      conditional_embedding=conditional_embedding,
                      channel_conditional_items=items, device=device)


def net_from_description(net_desc: dict, conditional_embedding=None,
                         device=None):
    """Rebuild a net from its exported description, on ``device``.

    Accepts both shapes in the wild: ``{"kind", "config", ...}`` and the
    legacy PUNetG exports (``{"config": {...}, has_conditional_embedding,
    ...}`` or a bare PUNetGConfig kwargs dict), which default to
    kind="punetg" (="punetg_cond" when channel_conditional_items is
    present)."""
    net_desc = dict(net_desc)
    kind = net_desc.get("kind")
    config = net_desc.get("config", None)
    if config is None:  # bare config-kwargs dict (oldest shape)
        config = {k: v for k, v in net_desc.items()
                  if k not in ("kind", "has_conditional_embedding",
                               "conditional_embedding_args",
                               "channel_conditional_items")}
    if kind is None:
        kind = ("punetg_cond" if net_desc.get("channel_conditional_items")
                else "punetg")
    if kind == "punetg_cond" and "channel_conditional_items" in net_desc:
        config = dict(config,
                      channel_conditional_items=net_desc[
                          "channel_conditional_items"])
    builder = NET_KINDS.get(kind)
    if builder is None:
        raise ValueError(
            f"unknown net kind {kind!r}; known: {sorted(NET_KINDS)}")
    return builder(config, conditional_embedding=conditional_embedding,
                   device=device)
