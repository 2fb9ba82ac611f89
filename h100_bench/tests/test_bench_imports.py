"""No module a run loads is JAX or the JAX package, by top-level name; the
reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from h100_bench import imports, spec


def test_top_level_names_compared_whole():
    assert imports.forbidden_loaded(["jax.numpy", "flax", "os"]) == [
        "flax", "jax.numpy"]
    assert imports.forbidden_loaded(["closerlook3d_tpu.ops"]) == [
        "closerlook3d_tpu.ops"]
    assert imports.forbidden_loaded(["closerlook3d_tpu_torch.ops",
                                     "jaxtyping", "jax_like"]) == []


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                          recursive=True):
        for name in _imported(path):
            assert name.split(".")[0] not in imports.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(spec.HERE, "reference", "*.py")):
        for name in _imported(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "__future__", "typing"), (path,
                                                                    name)
    code = ("import sys; import h100_bench.reference.model, "
            "h100_bench.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "closerlook3d_tpu_torch" not in out.stdout
    assert "'jax'" not in out.stdout


def test_a_run_loads_no_jax(tmp_path):
    """The harness with the program imported, as a run has it."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from h100_bench import core, imports; "
            "import closerlook3d_tpu_torch.train.step, "
            "closerlook3d_tpu_torch.serving.predictor, "
            "closerlook3d_tpu_torch.models.build; "
            "print(imports.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
