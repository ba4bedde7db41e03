"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax``, the JAX package ``repro``, or
``msgpack`` and ``ml_dtypes`` (the card's machine has neither), and every
module imports without ``nvcc`` or a GPU (kernels build at first launch,
never at import)."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_module_imports_jax_or_reference():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20
    bad = {str(p.relative_to(ROOT)): [n for n in _imports(p) if _banned(n)]
           for p in FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_every_module_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = "\n".join([
        "import importlib, importlib.util, sys",
        f"for b in {BANNED!r}:",
        "    sys.modules[b] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "from repro_torch.kernels import cuda",
        "assert not cuda._Build.libs, 'a kernel library loaded at import'",
        "print('ok', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH="/usr/bin:/bin", CUDA_HOME="")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_mesh_modules_stand_alone():
    """The mesh slice's modules are among those checked above, and
    importing them joins no process group (ranks join inside
    ``launch.mesh.run_ranks``)."""
    rel = {p.relative_to(PKG).as_posix() for p in FILES
           if p.is_relative_to(PKG)}
    assert {"distributed/sharding.py", "launch/mesh.py", "core/engine.py",
            "train/train_step.py"} <= rel
    code = "\n".join([
        "import sys",
        f"for b in {BANNED!r}:",
        "    sys.modules[b] = None",
        "import torch.distributed as dist",
        "from repro_torch.distributed import sharding",
        "from repro_torch.launch import mesh",
        "from repro_torch.core.engine import ShardedCimEngine",
        "from repro_torch.train import train_step",
        "assert not dist.is_initialized()",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
