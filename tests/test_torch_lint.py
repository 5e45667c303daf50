"""The port's linter (``repro_torch.analysis.lint``) against its rules, in
PyTorch's spellings: one fixture per rule, the pragma semantics (a reason
required), a syntax error reported, ``main``'s exit codes, the committed
package lint-clean, the two repairs it found (dryrun's shape-only
executor's reduce contract, tsm2r_q8's transpose launched through
``_launch.launch``), and the same waiver map as the JAX package's
``_waivers`` on the same sources."""

import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _lint(src, rel="models/thing.py"):
    return lint.lint_source(textwrap.dedent(src), rel, rel)


def _rules(errors):
    return [e.rule for e in errors]


# ---------------------------------------------------------------------------
# torch-private-import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "import torch._dynamo\n",
    "from torch._subclasses.fake_tensor import FakeTensorMode\n",
    "from torch.utils._python_dispatch import TorchDispatchMode\n",
    "from torch.utils import _pytree\n",
    "import torch.testing._internal.common_utils as cu\n",
])
def test_private_torch_import_flagged_outside_compat(src):
    assert _rules(_lint(src, rel="roofline/analyze.py")) == [
        "torch-private-import"]


def test_private_torch_import_allowed_in_compat():
    assert _lint("from torch._subclasses import FakeTensor\n",
                 rel="kernels/compat.py") == []


def test_public_torch_imports_are_fine():
    assert _lint("import torch\nfrom torch.utils import checkpoint\n"
                 "import torch.distributed as dist\n",
                 rel="kernels/tsm2r.py") == []


# ---------------------------------------------------------------------------
# raw-param-matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "torch.matmul(x, params['w_out'])",
    "torch.mm(x, w)",
    "torch.bmm(x, w_up)",
    "torch.einsum('td,df->tf', x, wuk)",
    "F.linear(x, weight)",
    "x @ w",
    "x @ self.w",
    "torch.matmul(x, p.wq)",
    "torch.matmul(x, w_q.float().t())",
    "x @ table.transpose(0, 1)",
])
def test_raw_param_matmul_flagged_in_models(expr):
    errs = _lint(f"""\
        import torch
        import torch.nn.functional as F

        def f(self, p, params, w, w_up, wuk, weight, w_q, table, x):
            return {expr}
        """)
    assert _rules(errs) == ["raw-param-matmul"]


def test_activation_matmul_not_flagged():
    errs = _lint("""\
        import torch

        def f(q, k, v):
            s = torch.einsum("thd,shd->tsh", q, k)
            return s @ v
        """)
    assert errs == []


@pytest.mark.parametrize("rel", ["kernels/ref.py", "linalg/tsqr.py",
                                 "core/tsmm.py"])
def test_raw_param_matmul_ignored_outside_scoped_dirs(rel):
    assert _lint("import torch\n\ndef f(w, x):\n    return "
                 "torch.mm(x, w)\n", rel=rel) == []


def test_einsum_spec_string_is_not_an_operand():
    errs = _lint("""\
        import torch

        def f(a, b):
            return torch.einsum("wx,xy->wy", a, b)
        """, rel="optim/powersgd.py")
    assert errs == []


# ---------------------------------------------------------------------------
# env-read
# ---------------------------------------------------------------------------

def test_env_read_flagged():
    errs = _lint("""\
        import os

        def f():
            a = os.getenv("REPRO_TSMM")
            b = os.environ.get("REPRO_SPEC", "h100")
            c = os.environ["HOME"]
            return a, b, c
        """, rel="core/perf_model.py")
    assert _rules(errs) == ["env-read"] * 3


def test_env_read_allowed_in_policy_constructor_launch_and_nvcc():
    src = """\
        import os

        def _policy_from_env():
            return os.getenv("REPRO_TSMM")
        """
    assert _lint(src, rel="core/tsmm.py") == []
    assert _lint("import os\nv = os.getenv('X')\n",
                 rel="launch/run.py") == []
    assert _lint("import os\n\ndef nvcc():\n    return os.environ.get("
                 "'CUDA_HOME', '')\n", rel="kernels/_build.py") == []
    # the same function name in another file is NOT exempt
    assert _rules(_lint(src, rel="core/autotune.py")) == ["env-read"]
    assert _rules(_lint("import os\n\ndef build():\n    return os.environ"
                        ".get('CUDA_HOME')\n", rel="kernels/_build.py")) == [
        "env-read"]


def test_import_reads_no_environment_rule_holds_on_the_package():
    """The rule the policy test checks at run time, over every module."""
    assert [e for e in lint.lint_paths() if e.rule == "env-read"] == []


# ---------------------------------------------------------------------------
# executor-contract
# ---------------------------------------------------------------------------

def test_register_executor_without_reduce_flagged():
    errs = _lint("""\
        from repro_torch.core import tsmm

        tsmm.register_executor("my-exec", lambda *a: None)
        """, rel="core/extras.py")
    assert _rules(errs) == ["executor-contract"]


def test_register_executor_with_reduce_ok():
    errs = _lint("""\
        from repro_torch.core import tsmm

        tsmm.register_executor("my-exec", lambda *a: None,
                               reduce=("psum",))
        """, rel="core/extras.py")
    assert errs == []


# ---------------------------------------------------------------------------
# raw-linalg-qr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "torch.linalg.qr(p)", "torch.linalg.cholesky(p)",
    "torch.linalg.cholesky_ex(p)", "np.linalg.qr(p)",
    "np.linalg.cholesky(p)", "scipy.linalg.cholesky(p)",
])
def test_raw_factorizations_flagged_in_parameter_layers(call):
    errs = _lint(f"""\
        import numpy as np
        import scipy
        import torch

        def orth(p):
            return {call}
        """, rel="optim/powersgd.py")
    assert _rules(errs) == ["raw-linalg-qr"]


def test_repro_linalg_call_not_flagged():
    errs = _lint("""\
        from repro_torch import linalg

        def orth(p):
            q, _ = linalg.tsqr(p)
            return q
        """, rel="optim/powersgd.py")
    assert errs == []


def test_raw_linalg_qr_exempt_outside_scoped_dirs():
    src = "import torch\nq = torch.linalg.qr(x)\n"
    assert _lint(src, rel="linalg/tsqr.py") == []
    assert _lint(src, rel="analysis/audit.py") == []


# ---------------------------------------------------------------------------
# kernel-launch-boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "import ctypes\n",
    "from ctypes import c_int\n",
    "from repro_torch.kernels import _build\n_build.transpose_q8(1, 2, 3, "
    "4, 5)\n",
    "from repro_torch.kernels import _build\nf = _build.launcher('tsm2r', "
    "'f32')\n",
    "from repro_torch.kernels import _build\nlib = _build.library('tsmt')\n",
    "from repro_torch.kernels import _build\n_build.sweep_launch(0)\n",
    "from repro_torch.kernels._build import launcher\nf = launcher('tsm2r', "
    "'f32')\n",
])
def test_kernel_launch_outside_the_launch_modules_flagged(src):
    assert _rules(_lint(src, rel="kernels/tsm2r.py")) == [
        "kernel-launch-boundary"]


def test_kernel_launch_allowed_in_build_and_launch():
    src = ("import ctypes\nfrom repro_torch.kernels import _build\n"
           "f = _build.launcher('tsm2r', 'f32')\n")
    assert _lint(src, rel="kernels/_launch.py") == []
    assert _lint(src, rel="kernels/_build.py") == []


def test_plan_queries_are_not_launches():
    src = ("from repro_torch.kernels import _build\n"
           "b = _build.plan(1, 2, 3, 'f32', 0, 0)\n"
           "g = _build.grid('tsmt_split', 1, 2, 3, 4)\n")
    assert _lint(src, rel="kernels/tsm2r.py") == []


# ---------------------------------------------------------------------------
# Pragma waivers
# ---------------------------------------------------------------------------

def test_pragma_waives_same_and_next_line():
    errs = _lint("""\
        import torch

        def f(w, x):
            # repro: allow-raw-param-matmul (tested exemption)
            return torch.mm(x, w)
        """)
    assert errs == []
    errs = _lint("""\
        import torch

        def f(w, x):
            return torch.mm(x, w)  # repro: allow-raw-param-matmul (inline)
        """)
    assert errs == []


def test_pragma_carries_through_comment_block_and_wrapped_stmt():
    errs = _lint("""\
        import torch

        def f(ew, buf, wsc):
            # repro: allow-raw-param-matmul (grouped per-expert bmm:
            # no 2-D rhs form tsmm accepts; the contraction must stay one
            # op)
            g = wsc(torch.einsum("gecd,edf->gecf", buf, ew["w_gate"]),
                    "model")
            return g
        """)
    assert errs == []


def test_pragma_waives_only_its_rule_and_statement():
    errs = _lint("""\
        import torch

        def f(w, x):
            # repro: allow-env-read (wrong rule)
            a = torch.mm(x, w)
            b = torch.mm(x, w)
            return a + b
        """)
    assert _rules(errs) == ["raw-param-matmul"] * 2
    errs = _lint("""\
        import torch

        def f(w, x):
            # repro: allow-raw-param-matmul (first only)
            a = torch.mm(x, w)
            b = torch.mm(x, w)
            return a + b
        """)
    assert _rules(errs) == ["raw-param-matmul"]


@pytest.mark.parametrize("pragma", [
    "# repro: allow-raw-param-matmul",
    "# repro: allow-raw-param-matmul ()",
    "# repro: allow-raw-param-matmul (   )",
    "# repro: allow-raw-param-matmul because",
])
def test_pragma_without_a_reason_waives_nothing(pragma):
    errs = _lint(f"""\
        import torch

        def f(w, x):
            {pragma}
            return torch.mm(x, w)
        """)
    assert _rules(errs) == ["raw-param-matmul"]


def test_pragma_reason_may_continue_on_the_next_comment_line():
    errs = _lint("""\
        import torch

        def f(b):
            # repro: allow-raw-linalg-qr (
            #   a (k, k) host-shaped factor)
            return torch.linalg.qr(b)
        """, rel="models/layers.py")
    assert errs == []


def test_syntax_error_is_reported_not_raised():
    errs = _lint("def f(:\n", rel="models/broken.py")
    assert _rules(errs) == ["syntax-error"]


# ---------------------------------------------------------------------------
# The committed tree, main, the repairs
# ---------------------------------------------------------------------------

def test_committed_tree_is_lint_clean():
    """Every legitimate exemption in ``src/repro_torch`` carries a
    documented pragma."""
    errors = lint.lint_paths()
    assert errors == [], "\n".join(str(e) for e in errors)


def test_main_exit_codes(capsys, tmp_path):
    assert lint.main([]) == 0
    assert "clean" in capsys.readouterr().out
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "bad.py").write_text(
        "import torch\n\ndef f(w, x):\n    return torch.mm(x, w)\n")
    assert lint.main([str(tmp_path)]) == 1
    assert "raw-param-matmul" in capsys.readouterr().out


def test_dryrun_shape_only_executor_declares_its_contract():
    """The repair of ``launch/dryrun.py``'s ``register_executor``: lint-clean,
    and the "meta" executor keeps the reduce contract of the per-shard
    executor on the card that it stands in for."""
    from repro_torch.core import tsmm
    from repro_torch.launch import dryrun

    path = PKG / "launch" / "dryrun.py"
    assert [e for e in lint.lint_source(path.read_text(), str(path),
                                        "launch/dryrun.py")
            if e.rule == "executor-contract"] == []
    assert tsmm.executor_reduce_contract(dryrun.SHAPE_ONLY) == \
        tsmm.executor_reduce_contract("cuda")


def test_q8_transpose_launches_through_launch(monkeypatch):
    """The repair of ``kernels/tsm2r.py``'s transpose: lint-clean, and
    ``q8_transpose`` hands the copy to ``_launch.launch`` (by the
    library's launcher name), where the checks and the launch live."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels import tsm2r as k_tsm2r

    path = PKG / "kernels" / "tsm2r.py"
    assert lint.lint_source(path.read_text(), str(path),
                            "kernels/tsm2r.py") == []
    calls = []
    monkeypatch.setattr(_launch, "launch",
                        lambda *a, **kw: calls.append((a, kw)))
    b = torch.empty((64, 48), dtype=torch.int8, device="meta")
    before = k_tsm2r.q8_transpose_launches
    out = k_tsm2r.q8_transpose(b)
    assert len(calls) == 1
    (name, dtype, src, dst, rows, cols), kw = calls[0]
    assert (name, dtype, rows, cols) == ("tsm2r_q8", None, 64, 48)
    assert kw == {"symbol": "tsm2r_q8_transpose"}
    assert src.shape == (64, 48) and dst.shape == (48, 64)
    assert out.shape == (64, 48) and k_tsm2r.is_kmajor(out)
    assert k_tsm2r.q8_transpose_launches == before + 1


# ---------------------------------------------------------------------------
# Parity with the JAX package's pragma grammar
# ---------------------------------------------------------------------------

def _sources():
    """Every source of the port's package (all of its pragmas carry a
    reason) and the reference's own lint fixtures."""
    out = [p.read_text() for p in sorted(PKG.rglob("*.py"))]
    out.append(textwrap.dedent("""\
        import jax.numpy as jnp

        def f(ew, buf, wsc, w, x):
            # repro: allow-raw-param-matmul (grouped per-expert einsum:
            # no 2-D rhs form)
            g = wsc(jnp.einsum("gecd,edf->gecf", buf, ew["w_gate"]),
                    "model")
            a = jnp.dot(x, w)  # repro: allow-raw-param-matmul (inline)

            # repro: allow-env-read (wrong rule)
            b = jnp.dot(x, w)
            return g + a + b
        """))
    return out


@pytest.mark.parametrize("i", range(len(_sources())))
def test_waiver_map_matches_the_jax_package(i):
    import ast

    from repro.analysis import lint as jax_lint

    src = _sources()[i]
    tree = ast.parse(src)
    assert lint._waivers(src, tree) == jax_lint._waivers(src, tree)
