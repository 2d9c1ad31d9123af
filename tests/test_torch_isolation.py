"""The port imports nothing of JAX, flax or the JAX package.

``diffsci_tpu_torch`` keeps its own copies of what it needs from
``diffsci_tpu`` (even of modules there that do not import JAX), so it runs
where JAX is not installed.
"""

import pathlib
import re
import subprocess
import sys
from tests import _torch_warmup  # noqa: F401  (MKL's first exp, CPU threads)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "diffsci_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|diffsci_tpu)\b",
    re.M)


def test_import_loads_no_jax():
    """Importing every module of the port pulls in no JAX module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffsci_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'diffsci_tpu'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('diffsci_tpu_torch')]), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    count, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(count) >= 15


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
