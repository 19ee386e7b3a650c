"""The check on loaded modules compares whole top-level names; the
benchmark's own reference imports nothing of the program."""

import ast
import sys

from benchmark import harness


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mercury_tpu_torch.fake", object())
    assert "mercury_tpu" not in harness.forbidden_modules()
    for name in ("mercury_tpu", "mercury_tpu.modem", "jax.numpy", "jaxlib",
                 "flax.linen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in harness.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources():
    """No file of the benchmark imports JAX or the JAX package; the
    transmitter, the traffic and the arithmetic import nothing of the
    program either."""
    for path in harness.HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path
    for name in ("txref.py", "traffic.py", "yardstick.py"):
        assert "mercury_tpu_torch" not in set(_imports(harness.HERE / name))
