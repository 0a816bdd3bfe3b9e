"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (``repro_torch`` begins with ``repro``), and the
yardstick's modules import nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the references, the traffic, the counts and the trace reduction
YARDSTICK = ("refcache.py", "refmodel.py", "weights.py", "workload.py",
             "counts.py", "devtrace.py")


def _tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    tops = _tops(BENCH / name)
    assert "repro_torch" not in tops
    assert not tops & FORBIDDEN


def test_whole_name_check_sees_the_jax_package(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nimport repro_torch\n")
    assert _tops(bad) & FORBIDDEN == {"repro"}
