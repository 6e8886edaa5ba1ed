"""Nothing the harness or the reference imports is JAX or the JAX package
(compared by whole top-level name), and the reference imports nothing of
the program."""

import ast
import json
import subprocess
import sys

from slam_bench import registry

JAX_NAMES = {"jax", "jaxlib", "flax", "gfplslam_tpu"}
ROOT = registry.HERE.parent


def _top_names(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_harness_names_jax():
    for path in registry.HERE.rglob("*.py"):
        assert not _top_names(path) & JAX_NAMES, path


def test_the_reference_names_nothing_of_the_program():
    for name in ("reference.py", "synth.py", "roofline.py", "window.py"):
        assert "gfplslam_torch" not in _top_names(registry.HERE / name), name


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_what_the_harness_loads_holds_no_jax():
    code = ("import json, sys\n"
            "from slam_bench import registry, run, checks, plants, trace, taps, smi\n"
            "from slam_bench.tests.conftest import small_cell\n"
            "for kind in ('drivers', 'metrics'):\n"
            "    for n in registry.names(kind):\n"
            "        registry.module(kind, n)\n"
            "import gfplslam_torch.models.slam, gfplslam_torch.models.ba\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    found = _loaded(code)
    assert "gfplslam_torch" in found and not found & JAX_NAMES


def test_what_the_reference_loads_holds_nothing_of_the_program():
    code = ("import json, sys\n"
            "from slam_bench import reference, synth, roofline, window\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    found = _loaded(code)
    assert not found & (JAX_NAMES | {"gfplslam_torch"})
