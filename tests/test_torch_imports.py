"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and none of the port's scripts imports JAX or anything of
the JAX package ``repro``."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(repro_torch.__file__).resolve().parent
# the twins of the reference's scripts
SCRIPTS = ("examples/placement_explorer_torch.py",
           "examples/quickstart_torch.py",
           "benchmarks/paper_figs_torch.py",
           "benchmarks/kernel_bench_torch.py")
# ``import repro`` / ``from repro.x import`` -- but not ``repro_torch``
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)(?!_))",
    re.MULTILINE)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    names = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.kernels.dispatch",
            "repro_torch.bridge", "repro_torch.kernels.quant_gemv",
            "repro_torch.kernels.kv_quant", "repro_torch.kernels.triton_gemv",
            "repro_torch.kernels.backends.gpu",
            "repro_torch.kernels.attention",
            "repro_torch.serving.prefix_cache", "repro_torch.models.ssm",
            "repro_torch.serving.bench", "repro_torch.core.placement",
            "repro_torch.pim.timing", "repro_torch.pim.e2e",
            "repro_torch.calibration.fit",
            "repro_torch.calibration.artifact"} <= set(names)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        f"for i, rel in enumerate({SCRIPTS!r}):\n"
        f"    spec = importlib.util.spec_from_file_location(\n"
        f"        f'script{{i}}', {str(ROOT)!r} + '/' + rel)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_source_scan_finds_no_jax_or_repro_import():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / rel for rel in SCRIPTS])
    assert len(files) > 20
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # the pattern itself does catch what it is meant to
    assert FORBIDDEN.search("from repro.kernels import ops")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.kernels import ops")
