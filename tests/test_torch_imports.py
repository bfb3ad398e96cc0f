"""The port stands alone: no file of torchacc_tpu_torch/ and no line of
chip_smoke.py imports jax, flax or the JAX package, and the package
imports in a process where jax cannot be imported."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "torchacc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "torchacc_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_sources_exist():
    srcs = _sources()
    assert os.path.exists(srcs[0]) and len(srcs) > 10


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'torchacc_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torchacc_tpu_torch\n"
        "import torchacc_tpu_torch.ops.paged_attention\n"
        "import torchacc_tpu_torch.ops._build\n"
        "import torchacc_tpu_torch.serve.engine\n"
        "import torchacc_tpu_torch.models.convert\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') and "
        "sys.modules[m] is not None for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
