"""What the port's scripts share: the ``--device`` flag, the mesh of
``--n-devices``, and the weights a trained state samples with."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises when CUDA is absent) "
                         "or cpu")


def mesh_of(n_devices: int | None, device: torch.device):
    """The data-parallel mesh of ``--n-devices`` (one rank a device, the
    process group of ``torchrun``'s environment, NCCL on the card and
    gloo on the CPU), or None."""
    if not n_devices:
        return None
    from diffsci_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed(device_type=device.type)
    return make_mesh(n_devices, device_type=device.type)


def writes(mesh) -> bool:
    """Whether this process writes the script's files (rank 0 of a mesh,
    or no mesh)."""
    return mesh is None or torch.distributed.get_rank() == 0


def use_weights(model, weights: dict) -> None:
    """Load ``weights`` (a state's ``ema_variables`` or ``params``, or a
    state dict, by name) into the model's network in place, so its
    samplers (and their CUDA graphs) read them; a compute dtype's cast
    copy follows. Every parameter of the network must be among them
    and every name of them a name of the network's: only buffers the
    weights do not carry (a batch norm's statistics) keep their values."""
    with torch.no_grad():
        missing, unexpected = model.net.load_state_dict(weights,
                                                        strict=False)
    params = {k for k, _ in model.net.named_parameters()}
    missing = [k for k in missing if k in params]
    if missing or unexpected:
        raise KeyError(f"the weights do not match the network: missing "
                       f"parameters {missing}, unexpected names "
                       f"{unexpected}")
    model._masters_changed()


def host(x) -> np.ndarray:
    """A tensor as a float32 numpy array on the host."""
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def channels_first(a: np.ndarray) -> np.ndarray:
    """[N, *spatial, C] -> [N, C, *spatial] (a network's layout for its
    channel conditions), contiguous."""
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))
