"""The port stands alone: no ``repro_torch`` module and not ``chip_smoke.py``
imports ``jax`` or the JAX package ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("import jax", "from jax", "import repro.", "from repro.")


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    for m in ("repro_torch.core.rps", "repro_torch.launch.serve",
              "repro_torch.launch.steps", "repro_torch.models.lm",
              "repro_torch.models.blocks", "repro_torch.models.layers",
              "repro_torch.models.config", "repro_torch.configs",
              "repro_torch.configs.internlm2_1_8b",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.decode_attention.kernel",
              "repro_torch.kernels.moe_gmm.kernel",
              "repro_torch.kernels.moe_gmm.ops",
              "repro_torch.kernels.rglru_scan.kernel",
              "repro_torch.kernels.rglru_scan.ops",
              "repro_torch.configs.llama4_scout",
              "repro_torch.configs.recurrentgemma_2b",
              "repro_torch.perf", "repro_torch.perf.cost_model",
              "repro_torch.runtime", "repro_torch.runtime.placement",
              "repro_torch.runtime.router",
              "repro_torch.runtime.adaptation",
              "repro_torch.distributed", "repro_torch.distributed.api",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.fault_tolerance",
              "repro_torch.launch.mesh", "repro_torch.perf.roofline",
              "repro_torch.optim.grad_compression",
              "repro_torch.launch.dryrun", "repro_torch.perf.hlo_analysis"):
        assert m in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_module_imports_first():
    """Each module imports in a fresh package state, so an import cycle
    that a sorted walk hides (a package reached first through another
    one) shows: every ``repro_torch`` entry is dropped before each
    import, and every module that fails is named."""
    mods = list(_modules())
    code = ("import importlib, sys, traceback\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "bad = []\n"
            f"for m in {mods!r}:\n"
            "    for k in [k for k in sys.modules\n"
            "              if k == 'repro_torch' or k.startswith('repro_torch.')]:\n"
            "        del sys.modules[k]\n"
            "    try:\n"
            "        importlib.import_module(m)\n"
            "    except Exception as e:\n"
            "        bad.append(f'{m}: {type(e).__name__}: {e}')\n"
            "print('\\n'.join(bad) if bad else 'ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok", (
        f"modules that do not import first:\n{proc.stdout}")


def test_no_source_names_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").is_file()
    bad = [(str(f.relative_to(ROOT)), s) for f in files
           for s in FORBIDDEN if s in f.read_text()]
    assert not bad, f"names jax or repro: {bad}"
