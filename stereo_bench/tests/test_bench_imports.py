"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their
top-level part whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from stereo_bench.tests.tiny import BENCH, ROOT, make_tiny_root

JAX_SIDE = {"jax", "jaxlib", "flax", "real_time_self_adaptive_deep_stereo_tpu"}
PORT = "real_time_self_adaptive_deep_stereo_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(d: Path):
    return [p for p in d.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_source_imports_jax():
    for p in _sources(BENCH):
        assert not set(_imports(p)) & JAX_SIDE, p


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(BENCH / "reference"):
        assert PORT not in set(_imports(p)), p


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell on the CPU, every per-layer reader
    included, then the modules it holds."""
    root = make_tiny_root(tmp_path)
    loaded = _modules_after(
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from stereo_bench import run, calibrate, sets, opcount\n"
        "from stereo_bench.harness import run_cell\n"
        "from stereo_bench.spec import Cell\n"
        "run_cell('madnet-mad-stream', 5, 0.5, True, 'cpu', root=__import__('pathlib').Path(%r))\n"
        "cell = Cell('madnet-mad-stream')\n"
        "[cell.reader(m['name']) for m in cell.per_layer]\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n" % (str(ROOT), str(root)))
    assert PORT in loaded
    assert not loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import stereo_bench.reference.session, stereo_bench.reference.models, "
                            "stereo_bench.reference.loss, stereo_bench.reference.ops")
    assert PORT not in loaded
    assert not loaded & JAX_SIDE


def test_forbidden_compares_whole_names(monkeypatch):
    from stereo_bench import run

    for name in (PORT, "real_time_self_adaptive_deep_stereo_tpu_like", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in run.forbidden_modules()
