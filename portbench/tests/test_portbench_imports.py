"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), nor
the old bench; the reference imports nothing of the program."""

import ast

from portbench import cells

BANNED = {"jax", "jaxlib", "flax", "rayfinder_tpu", "bench", "chip_smoke"}
PROGRAM = "rayfinder_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files():
    return [p for p in cells.HERE.rglob("*.py") if "cache" not in p.parts]


def test_no_module_imports_jax_or_the_old_bench():
    found = {str(p): sorted(set(_imports(p)) & BANNED) for p in _files()}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in _files() if p.parent.name in ("reference", "scenes")]
    assert ref
    assert not [str(p) for p in ref if PROGRAM in set(_imports(p))]


def test_no_file_names_the_old_bench():
    old = ("BENCH" + "_r0", "MULTICHIP" + "_r0")
    for p in _files():
        text = p.read_text()
        assert not any(name in text for name in old), p
