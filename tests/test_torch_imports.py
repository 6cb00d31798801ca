"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` and ``kernel_ab.py`` imports ``jax`` or the JAX package
``repro``, every module
imports on a machine with no GPU, no ``nvcc`` and no ``triton``, and the
kernels' sources carry the notes a reader needs."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.M)


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_module_of_the_port_imports_jax_or_repro():
    files = _sources()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = FORBIDDEN.search(f.read())
        assert hit is None, f"{os.path.relpath(path, REPO)}: {hit.group(0)!r}"


def test_the_guard_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                "  from repro.core import dps", "import repro", "from repro import x"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import dps",
               "# import jax", "x = 'import jax'", "import jaxtyping"):
        assert not FORBIDDEN.search(ok), ok


def test_every_module_imports_without_a_gpu_and_pulls_in_no_jax():
    names = [m.name for m in pkgutil.walk_packages([PKG], "repro_torch.")]
    assert "repro_torch.kernels.paged_attn" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("src,replaces", [
    ("dps_quant.cu", "_group_kernel"), ("paged_attn.cu", "_paged_attn_kernel"),
    ("dps_quant.cu", "emit_wire=False"), ("dps_quant.cu", "emit_wire=True"),
    ("dps_quant.cu", "_wire_reduce_kernel")])
def test_kernel_sources_carry_their_notes(src, replaces):
    """Which TPU kernel it replaces, what bounds it on this card; a plain C
    interface with PyTorch's headers kept out; no float atomics."""
    with open(os.path.join(PKG, "kernels", "csrc", src)) as f:
        text = f.read()
    assert replaces in text and "Bound on this card" in text
    assert 'extern "C"' in text
    assert "torch/extension.h" not in text and "atomicAdd" not in text


def test_the_library_builds_for_sm_90a_from_the_package_sources():
    from repro_torch.kernels import _build
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert [p.name for p in _build.sources()] == ["dps_quant.cu", "paged_attn.cu"]
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")
