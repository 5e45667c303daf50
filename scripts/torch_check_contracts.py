#!/usr/bin/env python
"""The port's static-analysis entry: the contract audit and the linter.

Runs ``repro_torch.analysis.audit --strict`` (kernel-launch contracts over
the reachable configuration space, the block-map dataflow verifier, a
tuning table given with ``--table``) and ``repro_torch.analysis.lint``
(the port's boundaries) in one process, on the CPU, with no card; exits
non-zero if either finds a violation. Other flags go to the auditor, so
``--json report.json`` writes the machine-readable report.

``--dataflow-json PATH`` also writes the ``kernel-dataflow`` section
(write races, coverage, reduction slices, bounds, accumulators, the
one-launch tsmt's finalizer, grid drift, and which grids were
corner-sampled: ``repro_torch.analysis.kernel_verify``) to its own file.

Equivalent to::

    PYTHONPATH=src python -m repro_torch.analysis.audit --strict [flags]
    PYTHONPATH=src python -m repro_torch.analysis.lint

The CPU run checks the plans' statement of every block against itself;
that the CUDA kernels write what the statement says is checked on the
card, by ``chip_smoke.py``'s dataflow phase.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis import audit, lint  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dataflow_path = None
    with tempfile.TemporaryDirectory() as tmp:
        if "--dataflow-json" in argv:
            i = argv.index("--dataflow-json")
            dataflow_path = pathlib.Path(argv[i + 1])
            del argv[i:i + 2]
            if "--json" not in argv:
                argv += ["--json", str(pathlib.Path(tmp) / "audit.json")]
        if "--strict" not in argv:
            argv.append("--strict")
        audit_rc = audit.main(argv)
        if dataflow_path is not None:
            report_path = pathlib.Path(argv[argv.index("--json") + 1])
            report = json.loads(report_path.read_text())
            section = report["sections"]["kernel-dataflow"]
            dataflow_path.write_text(json.dumps(
                {"schema": report["schema"], "section": "kernel-dataflow",
                 **section}, indent=2, sort_keys=True) + "\n")
    lint_rc = lint.main([])
    return audit_rc or lint_rc


if __name__ == "__main__":
    sys.exit(main())
