"""Nothing a run loads is JAX or the JAX package, and the plain reference
loads nothing of the program it checks (CPU, in fresh processes).

Top-level module names (the part before the first dot) are compared
whole: ``linalg_tpu_torch`` is the port and allowed; ``linalg_tpu`` is
not."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from portbench.tests import tiny

BENCH = tiny.REPO / "portbench"
BANNED = {"jax", "jaxlib", "flax", "linalg_tpu"}

RUN_ALL = """
import json, pathlib, sys, warnings
warnings.filterwarnings("ignore")
import torch
from portbench import control, manifest
from portbench.run import run_cell
from portbench.tests import tiny
root = tiny.make_root(pathlib.Path(sys.argv[1]))
bench = manifest.load(root)
for m in bench["per_layer"]:
    manifest.reader(root, m["name"])
for name in sorted(tiny.CELLS):
    for tr in (False, True):
        run_cell(root, name, 99, 0.3, tr, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import portbench.reference.gpt
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_modules(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         cwd=tiny.REPO, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    mods = _top_level_modules(RUN_ALL, tmp_path / "checkout")
    assert "linalg_tpu_torch" in mods and "portbench" in mods
    assert not mods & BANNED, sorted(mods & BANNED)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE_ONLY)
    assert not mods & (BANNED | {"linalg_tpu_torch"})


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.level == 0):
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = set(_imports(path))
    assert not names & BANNED
    if "reference" in path.parts:
        assert "linalg_tpu_torch" not in names
