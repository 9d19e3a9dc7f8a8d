"""The port stands alone: ``dpvo_tpu_torch``, its entry points
(``bench_torch.py``, ``demo_torch.py``, ``train_torch.py``, the five
``evaluate_*_torch.py``, ``scripts/dev/corr_variants_torch.py``,
``scripts/build_redwood_pickle_torch.py``, ``scripts/multi_gpu_torch.py``),
the dev benches ``scripts/dev/*_torch.py`` and ``benchmarks/*_torch.py``,
the spawned ranks' ``tests/torch_ranks.py`` and ``chip_smoke.py`` import
nothing of JAX, flax or the JAX package, and the
smoke script refuses to run without a CUDA card or outside the
repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dpvo_tpu")
PORT_FILES = sorted((ROOT / "dpvo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "demo_torch.py",
    ROOT / "train_torch.py", ROOT / "scripts" / "dev" / "corr_variants_torch.py",
    ROOT / "scripts" / "build_redwood_pickle_torch.py",
    ROOT / "scripts" / "multi_gpu_torch.py", ROOT / "tests" / "torch_ranks.py",
    *(ROOT / f"evaluate_{name}_torch.py"
      for name in ("tartan", "euroc", "kitti", "tum", "icl_nuim")),
    *(ROOT / "scripts" / "dev" / f"{name}_torch.py"
      for name in ("microbench", "frame_profile", "bench_profile",
                   "bench_ablate", "update_net_profile", "corr_block_profile",
                   "ba_bench", "train_bench", "roofline", "lc_match_bench")),
    *(ROOT / "benchmarks" / f"{name}_torch.py"
      for name in ("compare_scatter", "benchmark_dataloader"))]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "dpvo_tpu_torch/engine/dpvo.py" in names
    assert "dpvo_tpu_torch/ops/corr_cuda.py" in names
    assert all(p.exists() for p in PORT_FILES)
    assert len(names) >= 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    """Importing every module of the port in a fresh interpreter loads no
    JAX module."""
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT_FILES if p.name != "chip_smoke.py"})
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    # the dev benches import their harness (scripts/dev) by name
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "scripts" / "dev")]))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Without CUDA, or in a directory holding only the script, it exits
    non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [tmp_path]
    if not torch.cuda.is_available():
        runs.append(ROOT)
    for cwd in runs:
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0, (cwd, res.stdout)
        assert '"ok"' not in res.stdout
