"""The port imports no JAX: every module of multi_modal_image_fusion_tpu_torch
(and chip_smoke.py) is imported in a fresh interpreter, which must end with
no jax, flax or multi_modal_image_fusion_tpu module loaded; and no source
of the port names them in an import."""

import os
import pkgutil
import re
import subprocess
import sys

import multi_modal_image_fusion_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_modal_image_fusion_tpu")


def _modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages([PKG_DIR], prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|flax|"
    r"multi_modal_image_fusion_tpu)(?![\w])", re.M)


def test_no_jax_import_in_port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if _IMPORT.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
