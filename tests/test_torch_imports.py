"""The port stands alone: no file of torchacc_tpu_torch/ and no line of
chip_smoke.py or of the port's scripts imports jax, flax, the JAX
package, transformers or safetensors (the port reads Hugging Face
checkpoints itself), and the package imports in a process where none of
them can be imported."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "torchacc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "torchacc_tpu",
             "transformers", "safetensors")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "torch_flash_turns.py"),
           os.path.join(ROOT, "scripts", "torch_cp_ring_profile.py"),
           os.path.join(ROOT, "scripts", "torch_pp_cards.py")]
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
    assert os.path.join(PKG, "ops", "quantized_matmul.py") in srcs


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'torchacc_tpu', "
        "'transformers', 'safetensors'):\n"
        "    sys.modules[m] = None\n"
        "import torchacc_tpu_torch\n"
        "import torchacc_tpu_torch.ops.paged_attention\n"
        "import torchacc_tpu_torch.ops._build\n"
        "import torchacc_tpu_torch.serve.engine\n"
        "import torchacc_tpu_torch.models.convert\n"
        "import torchacc_tpu_torch.ops.attention\n"
        "import torchacc_tpu_torch.ops.attn\n"
        "import torchacc_tpu_torch.ops.flash_attention\n"
        "import torchacc_tpu_torch.ops.fused\n"
        "import torchacc_tpu_torch.ops.quantized_matmul\n"
        "import torchacc_tpu_torch.ops._common\n"
        "import torchacc_tpu_torch.utils.remat\n"
        "import torchacc_tpu_torch.train\n"
        "import torchacc_tpu_torch.train.accelerate\n"
        "import torchacc_tpu_torch.train.amp\n"
        "import torchacc_tpu_torch.train.schedules\n"
        "import torchacc_tpu_torch.train.state\n"
        "import torchacc_tpu_torch.train.trainer\n"
        "import torchacc_tpu_torch.data.packing\n"
        "import torchacc_tpu_torch.data.bucketing\n"
        "import torchacc_tpu_torch.data.dataset\n"
        "import torchacc_tpu_torch.data.async_loader\n"
        "import torchacc_tpu_torch.checkpoint\n"
        "import torchacc_tpu_torch.checkpoint.cli\n"
        "import torchacc_tpu_torch.checkpoint.io\n"
        "import torchacc_tpu_torch.checkpoint.reshard\n"
        "import torchacc_tpu_torch.checkpoint.schema\n"
        "import torchacc_tpu_torch.utils.retry\n"
        "import torchacc_tpu_torch.errors\n"
        "import torchacc_tpu_torch.models.hf\n"
        "import torchacc_tpu_torch.models.hf_stream\n"
        "import torchacc_tpu_torch.models.generate\n"
        "import torchacc_tpu_torch.train.hf_trainer\n"
        "from torchacc_tpu_torch import (load_hf_model, config_from_hf, "
        "HFTrainerAdapter)\n"
        "from torchacc_tpu_torch import (Trainer, accelerate, "
        "ComputeConfig, MemoryConfig, ConfigError, DataConfig, "
        "AsyncLoader, PackedDataset, pack_sequences)\n"
        "from torchacc_tpu_torch.ops.quantized_matmul import ("
        "QuantLinear, quantized_dot)\n"
        "from torchacc_tpu_torch.models.convert import (quant_from_jax, "
        "state_from_jax, state_to_jax)\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'transformers', "
        "'safetensors') and "
        "sys.modules[m] is not None for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
