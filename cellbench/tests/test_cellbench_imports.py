"""Nothing the benchmark loads is JAX or the JAX package, and the reference
imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from cellbench.manifest import PKG
from cellbench.run import forbidden_modules


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("playground3d_tpu", ["playground3d_tpu"]), ("playground3d_tpu.models.retinanet", ["playground3d_tpu"]),
    ("playground3d_tpu_torch", []), ("playground3d_tpu_torch.models.retinanet", []), ("jaxtyping", []),
])
def test_forbidden_top_level_names(name, found):
    assert forbidden_modules({"torch": None, name: None}) == found


def test_reference_sources_import_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("playground3d_tpu_torch", "playground3d_tpu", "jax"), (path, m)


def test_reference_loads_alone():
    code = ("import sys, cellbench.check, cellbench.reference.pipeline.clip, cellbench.reference.models.quant; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'playground3d_tpu_torch', 'playground3d_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=PKG.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_sources_name_no_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "playground3d_tpu") for m in mods), path
