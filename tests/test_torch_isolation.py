"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports JAX or anything of the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.models.convert, "
            "repro_torch.core, repro_torch.core.api, repro_torch.graphs, "
            "repro_torch.launch.optimize, repro_torch.kernels.calibrate, "
            "repro_torch.sharding.mcm_planner, repro_torch.core.ga_torch, "
            "repro_torch.core.pipelining_torch, repro_torch.kernels.sgs, "
            "repro_torch.kernels.sgs.ops, repro_torch.core.netsim, "
            "repro_torch.core.netsim_torch, repro_torch.kernels.netsim.ops, "
            "repro_torch.core.multitenant, repro_torch.core.sweep_shard, "
            "repro_torch.serve.coalesce, repro_torch.serve.optserver, "
            "repro_torch.runtime.fault_tolerance, repro_torch.train, "
            "repro_torch.train.train_step, repro_torch.train.optimizer, "
            "repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.models.loss, "
            "repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh, repro_torch.launch.specs, "
            "repro_torch.launch.policies, repro_torch.sharding.logical, "
            "repro_torch.sharding.partition_specs, "
            "repro_torch.roofline.analysis, "
            "repro_torch.train.grad_compress, "
            "repro_torch.launch.plan_mesh, "
            "repro_torch.launch.optserve_client, "
            "repro_torch.kernels.flash_attention.ops; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
