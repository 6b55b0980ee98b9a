"""Nothing the harness runs imports JAX or the JAX package (top-level
names compared whole: ray_tpu_torch is not ray_tpu), and the reference
imports nothing of the port."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules() -> list:
    mods = []
    for d, _, files in os.walk(PKG):
        if os.path.basename(d) == "tests" or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.join(d, f))
    return sorted(mods)


def test_every_harness_module_loads_without_jax():
    code = ["import importlib", "from gpubench.common import load_module"]
    for path in _modules():
        rel = os.path.relpath(path, ROOT)[:-3]
        if "." in os.path.basename(rel):  # a metric reader: by path
            code.append(f"load_module({path!r}, {rel!r})")
        else:
            code.append(f"importlib.import_module("
                        f"{rel.replace(os.sep, '.').removesuffix('.__init__')!r})")
    code.append("import gpubench.run, gpubench.sweep")
    code.append("from gpubench.drivers import serve_http, engine, trainer")
    code.append("import ray_tpu_torch.llm, ray_tpu_torch.train, "
                "ray_tpu_torch.serve")
    loaded = _loaded("\n".join(code))
    assert "ray_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_source_names_a_forbidden_module():
    for path in _modules():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".", 1)[0] not in FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(PKG, "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.split(".")[0] != "ray_tpu_torch", f
                if node.module.startswith("gpubench"):
                    assert node.module in ("gpubench", "gpubench.weights",
                                           "gpubench.common") \
                        or node.module.startswith("gpubench.reference"), f
            if isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] != "ray_tpu_torch", f
    loaded = _loaded("import gpubench.reference.serve, "
                     "gpubench.reference.train")
    assert "ray_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_run_refuses_without_the_port(tmp_path):
    """A checkout holding only BENCHMARK.json and gpubench/ exits
    non-zero and prints no result line."""
    import shutil

    shutil.copytree(PKG, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mixtral-docs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "mixtral-docs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "cuda" in out.stderr.lower()
