"""The port's layering, on the CPU: the imports of the package form no
cycle, the cluster modules sit below the mesh engine, ``ops`` reaches up
into ``models`` only where the mesh renderers drive the lane state; and the
kernel wrappers' shared check (``utils.kernels.check``)."""

import ast
import os

import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.utils import kernels

PKG = "cpu_based_ray_tracer_tpu_torch"
ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), PKG)


def _modules() -> dict:
    """Dotted module name under the package -> its file."""
    mods = {}
    for d, _, files in os.walk(ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
                name = rel.replace(os.sep, ".")
                mods[name.removesuffix(".__init__")
                     .removesuffix("__init__")] = os.path.join(d, f)
    return mods


def _imports(path: str, mods: dict):
    """(imported module, enclosing function or None) for each import of
    the package in the file, function-local imports included."""
    def target(module: str, name: str | None):
        if module != PKG and not module.startswith(PKG + "."):
            return None
        base = module[len(PKG) + 1:]
        sub = f"{base}.{name}" if base else name
        return sub if name is not None and sub in mods else base

    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                out.extend((target(a.name, None), fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.extend((target(child.module, a.name), fn)
                           for a in child.names)
            visit(child, fn)
    visit(ast.parse(open(path).read()), None)
    return [(m, fn) for m, fn in out if m]


def test_ops_import_graph():
    mods = _modules()
    edges = {m: _imports(p, mods) for m, p in mods.items()}
    graph = {m: {t for t, _ in e} - {m} for m, e in edges.items()}

    # no cycle: a depth-first walk never meets a module on its own path
    state = {}

    def walk(m, path):
        state[m] = "open"
        for t in sorted(graph.get(m, ())):
            assert state.get(t) != "open", f"import cycle {path + [t]}"
            if t not in state:
                walk(t, path + [t])
        state[m] = "done"
    for m in sorted(graph):
        if m not in state:
            walk(m, [m])

    def below(m):
        seen, todo = set(), [m]
        while todo:
            for t in graph.get(todo.pop(), ()):
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        return seen
    for m in ("ops.coherent", "ops.packet", "ops.clusters"):
        assert "ops.fused_mesh" not in below(m), m

    up = {(m, t, fn) for m, e in edges.items() if m.startswith("ops.")
          for t, fn in e if t.startswith("models")}
    assert {(m, t) for m, t, _ in up} == {("ops.fused_mesh",
                                           "models.monte_carlo")}
    assert {fn for _, _, fn in up} == {"_drive", "render_turbo_mesh"}


class _PosingAsCuda(torch.Tensor):
    """A CPU tensor that reports itself a CUDA tensor: the check's dtype
    and layout tests run here on what they would see on the card."""

    @property
    def is_cuda(self):
        return True


def test_check_passes_a_contiguous_cuda_tensor_of_its_dtype():
    x = torch.zeros((4, 3)).as_subclass(_PosingAsCuda)
    kernels.check("k", {"x": (x, torch.float32)})


@pytest.mark.parametrize("case", ["cpu", "dtype", "strided"])
def test_check_refuses(case):
    """A CPU tensor, a wrong dtype and a non-contiguous tensor each raise
    ValueError naming the kernel and the argument."""
    x = torch.zeros((4, 3))
    if case != "cpu":
        x = x.as_subclass(_PosingAsCuda)
    x = {"cpu": x, "dtype": x.double(), "strided": x.T}[case]
    with pytest.raises(ValueError, match="kern takes contiguous CUDA .*; "
                                         "planes is not one"):
        kernels.check("kern", {"ok": (torch.zeros(2).as_subclass(
            _PosingAsCuda), torch.float32), "planes": (x, torch.float32)})
