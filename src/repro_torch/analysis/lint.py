"""AST linter of the port's boundaries
(``python -m repro_torch.analysis.lint``).

Counterpart of ``src/repro/analysis/lint.py``, in PyTorch's spellings.
Each rule has a stable id and can be waived per statement with a pragma
comment ``# repro: allow-<rule-name> (reason)`` on the offending line or
the line directly above it (through comment blocks and wrapped
statements); the reason is mandatory, and the waivers stay grep-able.

* **torch-private-import** (the reference's RA001) -- a private torch
  module (``torch._*``, ``torch.<any>._*``) is imported only by
  ``kernels/compat.py``, the port's shim module. PyTorch moves its private
  modules between releases (the tests here and the card run different
  ones), so every other import of one carries a pragma that says why no
  public path serves.
* **raw-param-matmul** (RA002) -- inside ``models/``, ``optim/`` and
  ``serve/``, ``torch.matmul`` / ``torch.mm`` / ``torch.bmm`` /
  ``torch.einsum`` / ``F.linear`` / ``@`` over a *parameter-shaped*
  operand must route through ``repro_torch.core.tsmm``, so that the policy
  scope, the classifier and the kernels see it. An operand is
  parameter-shaped when its name follows the weight convention (``w``,
  ``wq``, ``w_up``, ``gate_w``, ``weight``, ``table``), when it is indexed
  out of a parameter dict by such a key (``params["w_up"]``), or when it
  is a module attribute of that name (``self.w``, ``p.wq``). The rule is
  name-based: false positives are waived with a documented pragma.
* **env-read** (RA003) -- ``os.environ`` / ``os.getenv`` reads happen only
  in the default-policy constructor (``core/tsmm.py::_policy_from_env``),
  under ``launch/`` (process launchers), and in
  ``kernels/_build.py::nvcc``, which reads ``CUDA_HOME`` to find the CUDA
  compiler: a toolchain path that changes where a kernel is built from,
  never what a GEMM computes. Anywhere else an environment read is hidden
  state that bypasses ``GemmPolicy``.
* **executor-contract** (RA004) -- every ``register_executor`` call
  declares its reduce contract (``reduce=``).
* **raw-linalg-qr** (RA005) -- inside the same three directories,
  ``torch.linalg.qr`` / ``cholesky`` / ``cholesky_ex`` (and the numpy and
  scipy spellings) route through ``repro_torch.linalg``, so that the Gram
  and apply GEMMs reach the TSM2X kernels.
* **kernel-launch-boundary** (takes RA006's place: the port has no
  ``pallas_call``) -- ``ctypes`` is imported only by ``kernels/_build.py``
  and ``kernels/_launch.py``, and nothing else calls a ``_build`` function
  that launches a kernel (``launcher``, ``library``, ``*_launch``,
  ``transpose_q8``): every wrapper launches through ``_launch.launch``,
  where the operand checks and the launch counts live.

Import discipline: stdlib only (``ast`` and ``pathlib``), so the linter
runs in a bare interpreter.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path

__all__ = ["LintError", "lint_source", "lint_file", "lint_paths", "main",
           "RULES"]

RULES = {
    "torch-private-import": "private torch module imported outside "
                            "kernels/compat.py",
    "raw-param-matmul": "raw matmul on parameter-shaped operands in "
                        "models//optim//serve/ (route through tsmm)",
    "env-read": "os.environ/getenv read outside the default-policy "
                "constructor, launch/ or the nvcc lookup",
    "executor-contract": "register_executor without an explicit reduce= "
                         "contract declaration",
    "raw-linalg-qr": "raw qr/cholesky factorization in models//optim//"
                     "serve/ (route through repro_torch.linalg)",
    "kernel-launch-boundary": "ctypes or a kernel launch outside "
                              "kernels/_build.py and kernels/_launch.py",
}

# Directories (relative to the package root) of the parameter layers.
_PARAM_MATMUL_DIRS = ("models", "optim", "serve")

# env-read allowlist: (path suffix, enclosing function) pairs, plus dirs.
# kernels/_build.py::nvcc reads CUDA_HOME: where the compiler lives, not
# what a GEMM computes.
_ENV_READ_FUNC_ALLOW = (("core/tsmm.py", "_policy_from_env"),
                        ("kernels/_build.py", "nvcc"))
_ENV_READ_DIR_ALLOW = ("launch",)

# kernel-launch-boundary: the two modules that own the ctypes launch.
_LAUNCH_OWNERS = ("kernels/_build.py", "kernels/_launch.py")
_LAUNCHING = ("launcher", "library", "transpose_q8")

# The reference's weight-naming patterns (bare "w", "w" + head letters,
# w_*, *_w, weight(s), a "table"), and the containers parameters are
# indexed out of.
_PARAM_NAME = re.compile(r"^(w|w[a-z]{1,3}|w_\w+|\w+_w|weights?|table)$")
_PARAM_KEY = re.compile(
    r"^(w|w[a-z]{1,3}|w_\w+|\w+_w|weights?|table|embed\w*)$")
_PARAM_CONTAINERS = ("params", "param", "weights", "ew")

_PRAGMA = re.compile(r"#\s*repro:\s*allow-([a-z0-9-]+)\s*(\(.*\))?")


@dataclasses.dataclass(frozen=True)
class LintError:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _waivers(source: str, tree: ast.AST) -> dict[int, set[str]]:
    """line number -> rule names waived there.

    A pragma on line L waives L itself (trailing-comment form) and the
    whole *statement* that starts at the next non-comment line (leading-
    comment form), wrapped lines and continuation comments included. A
    pragma without a reason waives nothing.
    """
    lines = source.splitlines()
    # statement start line -> largest end line of a statement starting there
    stmt_end: dict[int, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.stmt):
            end = node.end_lineno or node.lineno
            stmt_end[node.lineno] = max(stmt_end.get(node.lineno, 0), end)
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA.search(text)
        if not m or not _has_reason(lines, i, m):
            continue
        rule = m.group(1)
        out.setdefault(i, set()).add(rule)
        j = i + 1
        while j <= len(lines) and (not lines[j - 1].strip()
                                   or lines[j - 1].lstrip().startswith("#")):
            j += 1
        for ln in range(j, stmt_end.get(j, j) + 1):
            out.setdefault(ln, set()).add(rule)
    return out


def _has_reason(lines: list[str], i: int, m: re.Match) -> bool:
    """Whether the pragma on line ``i`` gives a reason: a non-empty "(...",
    closed on its line or on the comment lines that continue it."""
    rest = lines[i - 1][m.end(1):].strip()
    if not rest.startswith("("):
        return False
    text, j = rest[1:], i
    while ")" not in text and j < len(lines) \
            and lines[j].lstrip().startswith("#"):
        text += " " + lines[j].lstrip().lstrip("#")
        j += 1
    return ")" in text and bool(text.split(")", 1)[0].strip())


def _unwrap(node: ast.AST) -> ast.AST:
    """Strip .T/.t()/.to(...)/.reshape(...)/slicing wrappers so the
    underlying operand expression is what gets name-matched."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "t", "to", "float", "half",
                             "bfloat16", "reshape", "view", "transpose",
                             "swapaxes", "contiguous", "type_as"):
                node = node.value
            else:
                break
        elif isinstance(node, ast.Subscript):
            # peel positional slicing (x[..., :n]) but KEEP string-keyed
            # subscripts: those are the params["w_*"] accesses
            if _string_key(node) is not None:
                break
            node = node.value
        else:
            break
    return node


def _string_key(node: ast.Subscript) -> str | None:
    s = node.slice
    if isinstance(s, ast.Constant) and isinstance(s.value, str):
        return s.value
    return None


def _is_param_shaped(node: ast.AST) -> bool:
    node = _unwrap(node)
    if isinstance(node, ast.Name):
        return bool(_PARAM_NAME.match(node.id))
    if isinstance(node, ast.Attribute):       # self.w, p.wq
        return bool(_PARAM_NAME.match(node.attr))
    if isinstance(node, ast.Subscript):
        key = _string_key(node)
        if key is not None and _PARAM_KEY.match(key):
            return True
        base = _unwrap(node.value)
        if (key is not None and isinstance(base, ast.Name)
                and base.id in _PARAM_CONTAINERS):
            return True
    return False


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('torch.einsum', ...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


_MATMUL_CALLS = {
    "torch.matmul", "torch.mm", "torch.bmm", "torch.einsum",
    "torch.tensordot", "torch.dot", "torch.mv", "torch.addmm",
    "F.linear", "torch.nn.functional.linear", "nn.functional.linear",
    "np.dot", "numpy.dot",
}

# The dense factorizations that belong on repro_torch.linalg inside the
# parameter layers.
_LINALG_FACTOR_CALLS = {
    "torch.linalg.qr", "torch.linalg.cholesky", "torch.linalg.cholesky_ex",
    "torch.qr", "torch.cholesky",
    "np.linalg.qr", "np.linalg.cholesky",
    "numpy.linalg.qr", "numpy.linalg.cholesky",
    "scipy.linalg.qr", "scipy.linalg.cholesky",
    "sp_linalg.qr", "sp_linalg.cholesky",
}


def _private_torch(module: str) -> bool:
    parts = module.split(".")
    return parts[0] == "torch" and any(p.startswith("_") for p in parts[1:])


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, waivers: dict[int, set[str]]):
        self.path = path
        self.rel = rel  # path relative to the package root, '/'-separated
        self.waivers = waivers
        self.errors: list[LintError] = []
        self._func_stack: list[str] = []
        self.check_param_matmul = any(
            f"/{d}/" in f"/{rel}" for d in _PARAM_MATMUL_DIRS)
        self.env_read_allowed_file = any(
            f"/{d}/" in f"/{rel}" for d in _ENV_READ_DIR_ALLOW)
        self.owns_launch = rel.endswith(_LAUNCH_OWNERS)
        # names bound to _build's launching functions by from-imports
        self._build_names: set[str] = set()

    # -- plumbing -----------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.waivers.get(line, ()):
            return
        self.errors.append(LintError(rule, self.path, line, message))

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- torch-private-import and ctypes ------------------------------------

    def _check_import(self, node, module: str) -> None:
        if _private_torch(module) and not self.rel.endswith(
                "kernels/compat.py"):
            self._emit("torch-private-import", node,
                       f"import of private module {module!r} outside "
                       "kernels/compat.py (or waive with a documented "
                       "pragma)")
        if module.split(".")[0] == "ctypes" and not self.owns_launch:
            self._emit("kernel-launch-boundary", node,
                       "ctypes imported outside kernels/_build.py and "
                       "kernels/_launch.py: launch through _launch.launch")

    def visit_Import(self, node):
        for alias in node.names:
            self._check_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if node.module and node.level == 0:
            self._check_import(node, node.module)
            if node.module.split(".")[0] == "torch":   # torch.utils._pytree
                for a in node.names:
                    if a.name.startswith("_"):
                        self._check_import(node, f"{node.module}.{a.name}")
            if node.module.endswith("kernels._build"):
                self._build_names.update(a.asname or a.name
                                         for a in node.names)
        self.generic_visit(node)

    # -- calls --------------------------------------------------------------

    def _launching(self, name: str) -> bool:
        parts = name.split(".")
        fn = parts[-1]
        if not (fn in _LAUNCHING or fn.endswith("_launch")):
            return False
        return (len(parts) >= 2 and parts[-2] == "_build") or (
            len(parts) == 1 and fn in self._build_names)

    def visit_Call(self, node):
        name = _dotted(node.func)

        if self.check_param_matmul and name in _MATMUL_CALLS:
            operands = [a for a in node.args
                        if not (isinstance(a, ast.Constant)
                                and isinstance(a.value, str))]
            hits = [a for a in operands if _is_param_shaped(a)]
            if hits:
                self._emit(
                    "raw-param-matmul", node,
                    f"{name} over parameter-shaped operand "
                    f"{ast.unparse(hits[0])!r}: route through "
                    "repro_torch.core.tsmm (or waive with a documented "
                    "pragma)")

        if self.check_param_matmul and name in _LINALG_FACTOR_CALLS:
            self._emit(
                "raw-linalg-qr", node,
                f"{name} in a parameter layer: orthogonalization of tall "
                "operands routes through repro_torch.linalg (qr, tsqr, "
                "tree_tsqr) so the Gram and apply GEMMs reach the "
                "policy-scoped kernels (or waive with a documented pragma)")

        if name in ("os.getenv", "getenv"):
            self._check_env_read(node)
        if name.endswith("environ.get") and name.startswith("os"):
            self._check_env_read(node)

        if name.split(".")[-1] == "register_executor":
            kw = {k.arg for k in node.keywords}
            if "reduce" not in kw:
                self._emit(
                    "executor-contract", node,
                    "register_executor without reduce=: every in-repo "
                    "executor must declare which GemmPolicy.reduce modes "
                    "it implements")

        if not self.owns_launch and self._launching(name):
            self._emit(
                "kernel-launch-boundary", node,
                f"{name}(...) launches a kernel outside kernels/_build.py "
                "and kernels/_launch.py: launch through _launch.launch")

        self.generic_visit(node)

    def visit_BinOp(self, node):
        # the `@` operator form of raw-param-matmul
        if self.check_param_matmul and isinstance(node.op, ast.MatMult):
            hits = [a for a in (node.left, node.right)
                    if _is_param_shaped(a)]
            if hits:
                self._emit(
                    "raw-param-matmul", node,
                    f"@ over parameter-shaped operand "
                    f"{ast.unparse(hits[0])!r}: route through "
                    "repro_torch.core.tsmm (or waive with a documented "
                    "pragma)")
        self.generic_visit(node)

    def _env_read_allowed(self) -> bool:
        if self.env_read_allowed_file:
            return True
        return any(self.rel.endswith(suffix) and fn in self._func_stack
                   for suffix, fn in _ENV_READ_FUNC_ALLOW)

    def _check_env_read(self, node) -> None:
        if not self._env_read_allowed():
            self._emit(
                "env-read", node,
                "os.environ read outside the default-policy constructor "
                "(core/tsmm.py::_policy_from_env), launch/ or "
                "kernels/_build.py::nvcc: state must flow through "
                "GemmPolicy, not the environment")

    def visit_Subscript(self, node):
        # os.environ["X"] reads (writes are assignments: Store context)
        if (_dotted(node.value) == "os.environ"
                and isinstance(node.ctx, ast.Load)):
            self._check_env_read(node)
        self.generic_visit(node)


def lint_source(source: str, path: str, rel: str | None = None
                ) -> list[LintError]:
    """Lint one file's source text. ``rel`` is the path relative to the
    scanned package root ('/'-separated); defaults to ``path``. A syntax
    error is reported as a ``syntax-error``, not raised."""
    rel = (rel if rel is not None else path).replace("\\", "/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintError("syntax-error", path, e.lineno or 0, str(e.msg))]
    v = _Visitor(path, rel, _waivers(source, tree))
    v.visit(tree)
    return sorted(v.errors, key=lambda e: (e.path, e.line, e.rule))


def lint_file(path) -> list[LintError]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), None)


def _package_root(root) -> Path:
    return Path(root) if root is not None else (
        Path(__file__).resolve().parents[1])


def lint_paths(root=None) -> list[LintError]:
    """Lint every ``*.py`` under ``root`` (default: the ``repro_torch``
    package this module lies in), with paths relative to ``root`` so the
    directory-scoped rules fire."""
    rootp = _package_root(root)
    errors: list[LintError] = []
    for p in sorted(rootp.rglob("*.py")):
        rel = p.relative_to(rootp).as_posix()
        errors.extend(lint_source(p.read_text(), str(p), rel))
    return errors


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    roots = args or [None]
    errors: list[LintError] = []
    for r in roots:
        errors.extend(lint_paths(r))
    for e in errors:
        print(e)
    n = len(errors)
    print(f"repro_torch.analysis.lint: {n} violation(s)"
          + ("" if n else " -- clean"))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
