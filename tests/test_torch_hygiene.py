"""Import hygiene of the port: presto_tpu_torch, chip_smoke.py and
profile_port.py import neither JAX nor anything of the JAX package
(presto_tpu).

The test process itself already has JAX loaded (conftest.py), so the
runtime check imports every module of the port in a fresh interpreter.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "presto_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "presto_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_port.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "presto_tpu_torch" + (
            "." + ".".join(p.relative_to(PORT).with_suffix("").parts)
            if p.relative_to(PORT).parts != ("__init__.py",) else "")
        for p in PORT.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _profile_port(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import profile_port
    return profile_port


def test_profile_port_classes_every_kernel(monkeypatch):
    """Every __global__ function of csrc/ counts as hand-written in
    profile_port's breakdown, under its own source."""
    found = _profile_port(monkeypatch)._hand_written()
    for path in sorted((PORT / "csrc").glob("*.cu")):
        n = path.read_text().count("__global__")
        assert sum(src == path.stem for src in found.values()) == n, path.name


@pytest.mark.parametrize("text", [
    "__global__ void k(int a) {",
    "template <class R>\n__global__ void k(R r) {",
    "__global__ void __launch_bounds__(256) k(int a) {",
    "__global__ __launch_bounds__(256, 2) void k (int a) {"])
def test_profile_port_kernel_pattern_takes_qualifiers(monkeypatch, text):
    assert _profile_port(monkeypatch)._KERNEL.findall(text) == ["k"]
