"""Model-surgery converters on state dicts.

Port of ``transfer_params`` and ``convert_conv_params_to_circular`` of
``diffsci_tpu/extra/converters.py`` (the reference's
``diffsci/extra/punetg_converters.py:13-60``). The JAX package copies
between variable trees by path; here the paths are a state dict's dotted
names, with the same rule: a name normalizes by renaming the wrapper
scopes ``CircularConv_i`` to ``Conv_i`` and dropping the
``strip_segments`` that sit directly above the leaf, so that a wrapped
convolution's ``conv1.conv.weight`` and a plain ``conv1.weight`` match.

The JAX package's ``import_reference_*`` importers have no counterpart:
the port keeps the torch reference's names and loads its state dicts with
``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import torch

_WRAPPER_RENAMES = [(re.compile(r"^CircularConv_(\d+)$"), r"Conv_\1")]


def _normalize(name: str, strip_segments) -> tuple:
    # 1. rename wrapper scopes to their plain equivalents
    renamed = []
    for seg in name.split("."):
        for pat, repl in _WRAPPER_RENAMES:
            seg = pat.sub(repl, seg)
        renamed.append(seg)
    # 2. repeatedly drop a stripped wrapper scope sitting directly above
    #    the leaf until fixpoint, so `convin.Conv_0.weight` and
    #    `convin.weight` normalize identically
    out = list(renamed)
    while len(out) >= 2 and out[-2] in strip_segments:
        out.pop(-2)
    return tuple(out)


def transfer_params(src: Mapping[str, torch.Tensor],
                    dst_template: Mapping[str, torch.Tensor],
                    strip_segments: Sequence[str] = ("Conv_0", "conv"),
                    strict: bool = True,
                    verbose: bool = False) -> dict[str, torch.Tensor]:
    """Copy the tensors of state dict ``src`` into the names of
    ``dst_template``, matching names after removing ``strip_segments``
    wrapper scopes and requiring equal shapes.

    The canonical use is conv <-> circular model surgery
    (punetg_converters.py:13-60): a circular convolution holds the same
    kernel, so weights transfer unchanged. Returns a new state dict in the
    template's order; unmatched destination entries keep the template's
    tensors (or raise a ValueError when ``strict``)."""
    src_norm: dict = {}
    for name, value in src.items():
        src_norm.setdefault(_normalize(name, strip_segments), value)

    out = {}
    missing = []
    for name, value in dst_template.items():
        key = _normalize(name, strip_segments)
        if key in src_norm and tuple(src_norm[key].shape) == \
                tuple(value.shape):
            out[name] = src_norm[key]
            if verbose:
                print(f"copied {name}")
        else:
            missing.append(name)
            out[name] = value
    if missing and strict:
        raise ValueError(f"unmatched destination params: {missing[:10]}"
                         + ("..." if len(missing) > 10 else ""))
    return out


def convert_conv_params_to_circular(params: Mapping[str, torch.Tensor],
                                    circular_template: Mapping[
                                        str, torch.Tensor],
                                    strict: bool = True
                                    ) -> dict[str, torch.Tensor]:
    """Post-training periodization (punetg_converters.py:13-60): move a
    default-conv model's state dict into the circular-conv variant's
    names. ``circular_template`` is the circular model's own state dict
    (``model.state_dict()``); load the result with ``load_state_dict``."""
    return transfer_params(params, circular_template,
                           strip_segments=("Conv_0",), strict=strict)


__all__ = ["convert_conv_params_to_circular", "transfer_params"]
