"""Nothing the benchmark loads brings in JAX or the JAX package, and the
reference loads nothing of the port. Each check imports in a fresh process
and compares top-level module names whole (the port's name begins with the
JAX package's)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hyperpose_tpu"}


def _modules(prefix: str) -> list[str]:
    base = REPO / prefix
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in base.rglob("*.py")
                  if "tests" not in p.relative_to(REPO).parts and "." not in p.stem)


def _loaded_after(imports: list[str], program: bool) -> set[str]:
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {imports!r}:\n"
        "    importlib.import_module(m)\n"
        + ("from posebench import program, harness\n"
           "import hyperpose_torch.runtime.engine, hyperpose_torch.runtime.stream\n"
           "import hyperpose_torch.train.trainer, hyperpose_torch.quant\n"
           "from hyperpose_torch import Model, config\n" if program else "")
        + "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO), env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_benchmark_and_the_port_load_no_jax():
    loaded = _loaded_after(_modules("posebench"), program=True)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "hyperpose_torch" in loaded


def test_metric_readers_load_no_jax():
    code = ("import sys, json, importlib.util\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for p in {sorted(str(p) for p in (REPO / 'posebench' / 'metrics').glob('*.py'))!r}:\n"
            "    s = importlib.util.spec_from_file_location('m', p); m = importlib.util.module_from_spec(s)\n"
            "    s.loader.exec_module(m)\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"hyperpose_torch"})


@pytest.mark.parametrize("module", _modules("posebench/reference"))
def test_the_reference_loads_nothing_of_the_port(module):
    loaded = _loaded_after([module], program=False)
    assert not loaded & (FORBIDDEN | {"hyperpose_torch"}), loaded & (FORBIDDEN | {"hyperpose_torch"})


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, monkeypatch, capsys):
    """The look at the loaded modules comes after the per-layer readers: a
    reader that imports a module named jax inside `read` (here a stub) turns
    the run into one with no result line."""
    from tiny import cell, run, tiny_tree

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    (tmp_path / "tree").mkdir()
    bench = tiny_tree(tmp_path / "tree")
    (bench / "metrics" / "device_idle.offline.py").write_text(
        "def read(summary):\n    import jax  # noqa: F401\n    return 1.0\n")
    assert run(cell("lwopenpose-tinyvgg.offline-b32", bench), trace=True) is None
    assert "modules of JAX or the JAX package are loaded: ['jax']" in capsys.readouterr().err
    sys.modules.pop("jax", None)
