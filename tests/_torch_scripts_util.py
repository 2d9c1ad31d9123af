"""What the script tests share (torch only, no JAX): the 15 scripts of the
port's slice, a script's argparse parser captured without running it,
and a script's ``main()`` run in-process under a given ``sys.argv``."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import pathlib
import sys

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
NAMES = ("train_diffusion_mnist", "eval_fid", "train_diffusion_toy",
         "train_diffusion_cifar10", "train_diffusion_shapes",
         "train_diffusion_conditional", "train_super_resolution",
         "train_ensemble_forecast", "train_vae", "sampler_comparison",
         "anomaly_detection", "inpainting_demo", "distill_study",
         "entropy_time_profile", "correlation_thresholds")


def port(name: str):
    return importlib.import_module(f"diffsci_tpu_torch.scripts.{name}")


def jax_script(name: str):
    """The JAX package's script module (its imports of the JAX package
    are inside ``main()``)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


class _Parsed(Exception):
    pass


def parser_of(module) -> argparse.ArgumentParser:
    """The parser ``module.main()`` builds, taken at its ``parse_args``
    (which raises there, so nothing of the script runs)."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    argparse.ArgumentParser.parse_args = capture
    try:
        module.main()
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen[0]


def flags(parser) -> dict:
    """dest -> (option strings, default, nargs, type, choices, action)."""
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type,
                     a.choices, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@contextlib.contextmanager
def argv(name: str, args: list):
    old = sys.argv
    sys.argv = [f"{name}.py"] + [str(a) for a in args]
    try:
        yield
    finally:
        sys.argv = old


def run_main(module, name: str, args: list):
    """``module.main()`` under ``sys.argv`` = [name, *args], on one torch
    thread (restored after): a script at test sizes is thousands of small
    operations, whose intra-op threads contend with pytest-xdist's other
    workers (``tests/test_torch_metrics.py``'s reason; ``eval_fid
    --fld`` took 4 s alone and 34–67 s beside them)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with argv(name, args):
            return module.main()
    finally:
        torch.set_num_threads(threads)
