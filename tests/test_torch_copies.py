"""The port's copies of the JAX package's host modules are the same programs.

``sushi_tpu_torch`` keeps its own copy of each host module it needs (it
imports nothing of ``sushi_tpu``), and a fix in a copied module is made in
both packages.  This holds each copy to its original: the same syntax tree
once docstrings are dropped and the package name ``sushi_tpu`` reads
``sushi_tpu_torch``, up to the differences named below.
"""

import ast
import os

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = (
    "errors", "version",
    "text/chapters", "text/keyframes", "text/subs", "text/timefmt",
    "media/riff", "media/stream", "media/resample", "media/native", "media/demux",
    "media/timecodes", "media/stream_cache",
    "align/machine", "align/groups", "align/heuristics", "align/snapping",
)

# the allowed differences, by module:
# * media/native: where the library's source and build directory lie (the
#   port builds into build/sushi_tpu_torch/ beside the package);
# * media/stream_cache: load_stream and load_pair take the device to upload
#   to, ``device``, and pass it on; the upload resolves it
#   (``upload_stream(stream, resolve_device(device))`` for the JAX
#   package's ``upload_stream(stream)``); and load_stream counts the level
#   at which each lookup was answered into the port's search telemetry
#   (``_count_memo(level)`` statements, and the function that defines it).
LOCATION_NAMES = {"media/native": {"_PACKAGE_DIR", "_SOURCE", "_CACHE_DIR"}}
DEVICE_FUNCTIONS = {"media/stream_cache": {"load_stream", "load_pair"}}
COUNTERS = {"media/stream_cache": {"_count_memo"}}


def _rename(name):
    if name == "sushi_tpu" or name.startswith("sushi_tpu."):
        return "sushi_tpu_torch" + name[len("sushi_tpu"):]
    return name


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and the allowed differences of ``module``; renames
    the JAX package to the port in imports."""

    def __init__(self, module):
        self.locations = LOCATION_NAMES.get(module, set())
        self.device_functions = DEVICE_FUNCTIONS.get(module, set())
        self.counters = COUNTERS.get(module, set())
        self.in_device_function = False

    def _drop_docstring(self, node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self.generic_visit(node)
        node.body = [
            statement for statement in node.body
            if not (isinstance(statement, ast.Assign)
                    and {getattr(target, "id", None) for target in statement.targets} & self.locations)
            and not (isinstance(statement, ast.FunctionDef) and statement.name in self.counters)
        ]
        return self._drop_docstring(node)

    def visit_Expr(self, node):
        self.generic_visit(node)
        if isinstance(node.value, ast.Call) and getattr(node.value.func, "id", None) in self.counters:
            return None
        return node

    def visit_ClassDef(self, node):
        self.generic_visit(node)
        return self._drop_docstring(node)

    def visit_FunctionDef(self, node):
        device = node.name in self.device_functions
        self.in_device_function = device
        self.generic_visit(node)
        self.in_device_function = False
        if device:
            args = node.args
            names = [arg.arg for arg in args.args]
            if names and names[-1] == "device":
                args.args = args.args[:-1]
                args.defaults = args.defaults[:-1]
        return self._drop_docstring(node)

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = _rename(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = _rename(node.module)
        if self.in_device_function and node.module == "sushi_tpu_torch" \
                and [alias.name for alias in node.names] == ["resolve_device"]:
            return None
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        if not self.in_device_function:
            return node
        if node.args and isinstance(node.args[-1], ast.Name) and node.args[-1].id == "device":
            node.args = node.args[:-1]
        if getattr(node.func, "id", None) == "upload_stream" and len(node.args) == 2:
            resolved = node.args[1]
            if isinstance(resolved, ast.Call) and getattr(resolved.func, "id", None) == "resolve_device":
                node.args = node.args[:1]
        return node


def _tree(path, module):
    with open(path, encoding="utf-8") as handle:
        tree = ast.parse(handle.read(), path)
    return ast.dump(_Normalise(module).visit(tree), include_attributes=False)


@pytest.mark.parametrize("module", COPIED)
def test_copy_is_the_same_program(module):
    original = _tree(os.path.join(REPO_ROOT, "sushi_tpu", module + ".py"), module)
    copy = _tree(os.path.join(REPO_ROOT, "sushi_tpu_torch", module + ".py"), module)
    assert copy == original, "sushi_tpu_torch/%s.py differs from sushi_tpu/%s.py" % (module, module)


def test_normaliser_sees_a_changed_line(tmp_path):
    """The comparison is not blind: one changed constant in a copy differs."""
    source = os.path.join(REPO_ROOT, "sushi_tpu_torch", "media", "stream_cache.py")
    with open(source, encoding="utf-8") as handle:
        text = handle.read()
    changed = tmp_path / "stream_cache.py"
    changed.write_text(text.replace("_MAX_ENTRIES = 64", "_MAX_ENTRIES = 65"), encoding="utf-8")
    module = "media/stream_cache"
    assert _tree(str(changed), module) != _tree(source, module)
    assert _tree(source, module) == _tree(os.path.join(REPO_ROOT, "sushi_tpu", module + ".py"), module)
