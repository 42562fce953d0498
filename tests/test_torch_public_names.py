"""Every public top-level name of each yolo_tpu module has its
counterpart in the port's module of the same path (yolo_tpu_torch/...),
read from the sources by AST on the CPU; what is not ported yet (now
nothing), and what has nothing to port, is listed here by name, and the lists must be
exact: a name ported later leaves them.

A JAX module's public names are the functions, classes and assignments
at its top level whose names do not start with "_"; the port's are
every name bound at its top level, imports included (a name may live in
another port module and be imported where the JAX package defines it).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# not ported yet, by ROADMAP item: nothing since A9g/A12b and A9h
NOT_PORTED: dict = {}
# nothing to port: JAX-only machinery, TPU workarounds and test oracles
NOTHING_TO_PORT = {
    "ops/numpy_ref.py": "*",          # the numpy oracle of the tests
    "ops/pallas/__init__.py": "*",    # the TPU kernels: csrc/, ops/cuda/
    "ops/pallas/conv_kernel.py": "*",
    "ops/pallas/entry_kernel.py": "*",
    "ops/pallas/nms_kernel.py": "*",
    "models/graph.py": {"Params", "apply_layers", "conv_block",
                        "params_to_jax", "params_to_jax_quant"},
    "train/loop.py": {"prewarm"},     # XLA compiles ahead; eager has none
    "utils/profiling.py": {"sync", "scope"},   # host fetch; named_scope
}


def _defined(path) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _bound(path) -> set:
    out = set(_defined(path))
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def _modules():
    root = os.path.join(REPO, "yolo_tpu")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root)


@pytest.mark.parametrize("rel", sorted(_modules()))
def test_public_names_are_ported(rel):
    want = _defined(os.path.join(REPO, "yolo_tpu", rel))
    port = os.path.join(REPO, "yolo_tpu_torch", rel)
    missing = want - (_bound(port) if os.path.exists(port) else set())
    listed = NOT_PORTED.get(rel, NOTHING_TO_PORT.get(rel, set()))
    if listed == "*":
        assert not os.path.exists(port) or not want, rel
        return
    assert missing == listed, (rel, sorted(missing ^ listed))


def test_the_lists_name_existing_modules():
    mods = set(_modules())
    for rel in list(NOT_PORTED) + list(NOTHING_TO_PORT):
        assert rel in mods, rel
