"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import harness

IMPORT_ALL = r"""
import importlib, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root.parent))
import benchmark.run
from benchmark import harness
for p in sorted(root.rglob("*.py")):
    rel = p.relative_to(root)
    if rel.parts[0] == "tests":
        continue
    if "." in p.stem:  # per-layer readers named after their metric
        harness.load(p, "bench_" + p.stem.replace(".", "_"))
    else:
        importlib.import_module(".".join(("benchmark",) + rel.with_suffix("").parts)
                                if rel.stem != "__init__" else
                                ".".join(("benchmark",) + rel.parts[:-1]))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(harness.ROOT)],
                         check=True, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"},
                         timeout=300).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "benchmark" in top and "pedoni_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((harness.ROOT / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("pedoni_tpu_torch", *harness.FORBIDDEN), (p.name, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pedoni_tpu_torch_x", sys)
    assert "pedoni_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pedoni_tpu.sim", sys)
    assert harness.forbidden_modules() == ["pedoni_tpu"]
