"""The port stands alone: no file of ``sushi_tpu_torch/``, and no
``chip_*.py`` script at the root, imports ``jax`` or anything of the JAX package
(``sushi_tpu`` and its submodules), at any depth: imports inside functions
and ``importlib.import_module`` / ``__import__`` calls with a literal name
count too.  A static check with ``ast``; the subprocess tests in
``test_torch_pipeline.py`` and ``test_torch_season.py`` check the same at
run time."""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "sushi_tpu")


def _port_files():
    files = [os.path.join(REPO_ROOT, name) for name in os.listdir(REPO_ROOT)
             if name.startswith("chip_") and name.endswith(".py")]
    for directory, _, names in os.walk(os.path.join(REPO_ROOT, "sushi_tpu_torch")):
        files += [os.path.join(directory, name) for name in names if name.endswith(".py")]
    return sorted(os.path.relpath(path, REPO_ROOT) for path in files)


def _forbidden(module):
    return any(module == root or module.startswith(root + ".") for root in FORBIDDEN)


def forbidden_imports(source, filename="<source>"):
    """(line, module) of every import of a forbidden module in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, alias.name) for alias in node.names if _forbidden(alias.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            function = node.func
            name = function.attr if isinstance(function, ast.Attribute) else getattr(function, "id", None)
            module = node.args[0].value
            if name in ("import_module", "__import__") and isinstance(module, str) and _forbidden(module):
                found.append((node.lineno, module))
    return found


PORT_FILES = _port_files()


def test_port_files_found():
    for script in ("chip_smoke.py", "chip_kernels.py", "chip_row_locality.py", "chip_warm.py", "chip_soak.py",
                   "chip_regression.py", "chip_bench.py"):
        assert script in PORT_FILES
    for module in ("cli.py", "season.py", "errors.py", os.path.join("media", "stream_cache.py"),
                   os.path.join("align", "machine.py"), os.path.join("ops", "coarse.py")):
        assert os.path.join("sushi_tpu_torch", module) in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_jax(path):
    with open(os.path.join(REPO_ROOT, path), encoding="utf-8") as handle:
        found = forbidden_imports(handle.read(), path)
    assert found == [], "%s imports %s" % (path, found)


@pytest.mark.parametrize(
    "source,module",
    [
        ("import jax\n", "jax"),
        ("import jax.numpy as jnp\n", "jax.numpy"),
        ("from sushi_tpu.errors import SushiError\n", "sushi_tpu.errors"),
        ("from sushi_tpu import season\n", "sushi_tpu"),
        ("def f():\n    if True:\n        from sushi_tpu.align import machine\n", "sushi_tpu.align"),
        ("class C:\n    def m(self):\n        import sushi_tpu.media.stream\n", "sushi_tpu.media.stream"),
        ("import importlib\nimportlib.import_module('sushi_tpu.ops.sqdiff')\n", "sushi_tpu.ops.sqdiff"),
        ("__import__('jax')\n", "jax"),
    ],
)
def test_checker_finds_forbidden_imports(source, module):
    assert [found for _, found in forbidden_imports(source)] == [module]


@pytest.mark.parametrize(
    "source",
    [
        "import sushi_tpu_torch\nfrom sushi_tpu_torch.errors import SushiError\n",
        "from . import sqdiff\nfrom .media import stream\n",
        "import logging\nlogging.getLogger('sushi_tpu')\n",
        "import jaxtyping_like_name_is_not_jax as j\n",
    ],
)
def test_checker_allows_the_port(source):
    assert forbidden_imports(source) == []
