"""The port stands alone: neither ``openviic_tpu_torch`` nor ``chip_smoke.py``
imports JAX, Flax, Optax, the JAX package, PyYAML, Pillow, Grain, OpenCV or
the HuggingFace packages (transformers, safetensors, huggingface_hub) at
import time (the machine with the card has none of them; the ``hf:`` ViT
reads its directory without them).

``chip_smoke.py --cpu`` runs in a subprocess whose imports of those
packages raise; a static scan checks every import statement of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "flax", "optax", "openviic_tpu", "yaml", "PIL", "grain", "cv2",
           "transformers", "safetensors", "huggingface_hub")
# PyYAML is imported inside the one function that parses a config file,
# Pillow inside the one that decodes an image file, OpenCV inside
# ImageDataset's item read
LAZY_ALLOWED = {("openviic_tpu_torch/config/loader.py", "yaml"),
                ("openviic_tpu_torch/data/extraction.py", "PIL"),
                ("openviic_tpu_torch/data/datasets.py", "cv2")}

_RUNNER = """
import runpy, sys

BLOCKED = {blocked!r}


class BlockImports:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {{name}} is blocked")
        return None


sys.meta_path.insert(0, BlockImports())
sys.argv = ["chip_smoke.py", "--cpu"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
finally:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print("blocked modules loaded:", loaded)
"""


def _port_sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "openviic_tpu_torch").rglob("*.py"))


def test_chip_smoke_cpu_rehearsal_runs_without_jax_or_yaml():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER.format(blocked=BLOCKED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "cpu rehearsal ok" in proc.stdout
    assert "blocked modules loaded: []" in proc.stdout


def test_port_modules_never_import_the_jax_stack():
    offenders, scanned = [], set()
    for path in _port_sources():
        rel = path.relative_to(ROOT).as_posix()
        scanned.add(rel)
        tree = ast.parse(path.read_text(), filename=rel)
        module_level = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top not in BLOCKED:
                    continue
                if (rel, top) in LAZY_ALLOWED and id(node) not in module_level:
                    continue
                offenders.append(f"{rel}:{node.lineno} imports {name}")
    assert {"chip_smoke.py", "openviic_tpu_torch/config/loader.py"} <= scanned
    assert {f"openviic_tpu_torch/{m}.py" for m in NEW_MODULES} <= scanned
    assert not offenders, offenders


# the trained-artifact decode, the scorers, XE training, the native
# scorers' binding, SCST, the data side, the trainer lifecycle, serving, the
# parallel layouts, the checkpoint backend, the build cache, the word
# vectors, the host-local launcher and the hf: backbone's ViT
NEW_MODULES = (
    "artifact", "data/preprocess", "data/datasets", "data/vocab", "evaluation/__init__",
    "evaluation/bleu", "evaluation/cider", "evaluation/meteor", "evaluation/meteor15",
    "evaluation/ngram", "evaluation/porter", "evaluation/ptb_tokenizer", "evaluation/rouge",
    "training/__init__", "training/optim", "training/steps", "native/__init__", "rng",
    "training/device_reward", "training/trainer", "data/loader", "training/checkpoint",
    "utils/__init__", "utils/logging", "utils/metrics", "train", "serving", "server",
    "data/extraction", "serve", "predict", "extract_features", "data/grain_loader",
    "parallel/__init__", "parallel/runtime", "parallel/mesh", "parallel/dryrun",
    "parallel/collectives", "parallel/tensor_parallel", "parallel/ring_attention",
    "parallel/ulysses", "parallel/pipeline", "parallel/layouts_dryrun", "parallel/gloo_probe",
    "training/orbax_backend", "utils/compile_cache", "data/word_embedding", "parallel/launch",
    "data/vit",
)

_IMPORT_ALL = """
import importlib, pkgutil, sys

BLOCKED = {blocked!r}


class BlockImports:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {{name}} is blocked")
        return None


sys.meta_path.insert(0, BlockImports())
import openviic_tpu_torch

names = [m.name for m in pkgutil.walk_packages(openviic_tpu_torch.__path__, "openviic_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("imported", len(names), sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""


def test_every_port_module_imports_with_the_jax_stack_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(blocked=BLOCKED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    count = int(proc.stdout.split()[1])
    assert count >= 40 and proc.stdout.strip().endswith("[]"), proc.stdout
