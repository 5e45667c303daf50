"""The port's contract audit (``repro_torch.analysis.audit``): each section
clean on the committed tree, the QR sweep's count by the reference's
formula, the tuning-table rejections, the CLI under ``--strict`` and
``--json``, ``scripts/torch_check_contracts.py`` in a subprocess, and the
backward policies it derives against the JAX package's."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import audit, contracts
from repro_torch.core import autotune, perf_model, tsmm

ROOT = Path(__file__).resolve().parents[1]


def _rules(vios):
    return {v.rule for v in vios}


@pytest.fixture(scope="module")
def report():
    return audit.run_audit()


def test_audit_clean_on_committed_tree(report):
    assert report["schema"] == audit.AUDIT_SCHEMA == \
        "repro-torch-analysis-audit/1"
    assert report["ok"], [v for s in report["sections"].values()
                          for v in s["violations"]][:5]
    assert report["checked"] > 1000
    assert set(report["sections"]) == {
        "candidate-grids", "resolved-configs", "quant-resolved",
        "qr-resolved", "abft-resolved", "policies", "kernel-dataflow"}
    df = report["sections"]["kernel-dataflow"]
    assert df["cell_limit"] == 4096
    assert all(s["cells"] > 4096 for s in df["sampled"])


@pytest.mark.parametrize("kind", ["tsm2r", "tsm2l", "tsmt"])
def test_candidates_are_contract_clean(kind):
    for shape in audit.SWEEP_SHAPES[kind]:
        checked, vios = audit.audit_candidate_grids(shapes={kind: (shape,)})
        assert checked > 0 and vios == [], [v.to_json() for v in vios]


def test_second_spec_moves_the_chooser():
    """SWEEP_SPECS' second card changes S somewhere in the sweep (else it
    would sweep nothing new)."""
    base, other = audit.SWEEP_SPECS
    moved = [(kind, shape) for kind in ("tsm2r", "tsmt")
             for shape in audit.SWEEP_SHAPES[kind]
             if (perf_model.choose_splits_tsm2r if kind == "tsm2r"
                 else perf_model.choose_splits_tsmt)(*shape, base)
             != (perf_model.choose_splits_tsm2r if kind == "tsm2r"
                 else perf_model.choose_splits_tsmt)(*shape, other)]
    assert moved


def test_resolved_sweeps_cover_pointer_and_split_arms():
    launches = audit.resolved_launches()
    residues = {tuple(v % 16 for v in p["ptrs"].values())
                for k, _, p, _, _ in launches if k != "quantize"}
    assert (0, 0) in residues and (4, 4) in residues
    bodies = {(k, p.get("body")) for k, _, p, _, _ in launches}
    assert ("tsm2r", "skinny") in bodies and ("tsm2r", "simt") in bodies
    assert any(k == "reduce" for k, *_ in launches)


def test_resolver_sweep_is_contract_clean():
    checked, vios = audit.audit_resolved_configs()
    assert checked > 0 and vios == [], [v.to_json() for v in vios]


def test_quant_sweep_is_contract_clean():
    checked, vios = audit.audit_quant_configs()
    assert checked > 0 and vios == [], [v.to_json() for v in vios]


def test_audit_qr_sweep_clean_and_counts():
    checked, vios = audit.audit_qr_configs()
    assert vios == [], vios
    # two stages (Gram + apply) per (shape, shard count) cell that tiles
    cells = sum(1 for m, r in audit.QR_SWEEP_SHAPES
                for s in audit.QR_SWEEP_SHARDS if m % s == 0)
    assert checked >= cells * 2, (checked, cells)
    # the reference's formula: tsmt under every split arm, tsm2l once
    assert checked == cells * (len(audit.SWEEP_SPLITS) + 1)


def test_abft_sweep_is_clean():
    checked, vios = audit.audit_abft_configs()
    assert checked >= 18 and vios == []


def test_policies_sweep_is_clean_and_counts():
    checked, vios = audit.audit_policies()
    assert vios == []
    combos = (len(audit._POLICY_MODES) * 3 * len(audit._POLICY_SPLITS)
              * len(audit._POLICY_EXECUTORS))
    assert checked == combos + len(tsmm.executors())


def test_policies_catch_a_malformed_executor_contract(monkeypatch):
    monkeypatch.setitem(tsmm._EXECUTOR_CONTRACTS, "cuda", ())
    _, vios = audit.audit_policies()
    assert "executor-contract-modes" in _rules(vios)


def test_kernel_dataflow_section_is_clean():
    checked, vios, meta = audit.audit_kernel_dataflow()
    assert checked == len(audit.resolved_launches()) and vios == []
    assert meta["cell_limit"] == 4096


# ---------------------------------------------------------------------------
# Tuning-table rejections
# ---------------------------------------------------------------------------

def _record(kind="tsm2r", shape=(4096, 4096, 16), splits=4,
            executor="cuda", bucket=None):
    return autotune.TuningRecord(
        kind=kind, bucket=bucket or autotune.bucket_shape(*shape),
        dtype="float32", spec_name="h100", executor=executor, shape=shape,
        params=(("splits", splits),), measured_us=10.0, model_us=11.0,
        model_error=0.1, model_pick=(("splits", splits),),
        model_pick_measured_us=10.0)


def test_audit_accepts_a_good_tuning_record():
    checked, vios = audit.audit_tuning_table(
        autotune.TuningTable.from_records([_record()]))
    assert checked == 1 and vios == []


@pytest.mark.parametrize("rec,rule", [
    (dict(executor="pallas-tpu"), "unknown-executor"),
    (dict(bucket=(1, 2, 3)), "bucket-mismatch"),
    (dict(splits=3), "tuning-splits"),
    (dict(splits=256), "tuning-splits"),
])
def test_audit_rejects_bad_tuning_records(rec, rule):
    _, vios = audit.audit_tuning_table(
        autotune.TuningTable.from_records([_record(**rec)]))
    assert rule in _rules(vios)


def test_audit_cli_reads_a_table(tmp_path, capsys):
    path = tmp_path / "table.json"
    autotune.TuningTable.from_records([_record(splits=3)]).save(path)
    assert audit.main(["--strict", "--table", str(path)]) == 1
    assert "tuning-splits" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# CLI and the contract-check script
# ---------------------------------------------------------------------------

def test_audit_cli_strict_and_json(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert audit.main(["--strict", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "0 violation(s) -- clean" in text
    data = json.loads(out.read_text())
    assert data["schema"] == audit.AUDIT_SCHEMA and data["ok"]
    for sec in data["sections"].values():
        assert {"checked", "violations"} <= set(sec)


def test_check_contracts_script_exits_zero(tmp_path):
    df = tmp_path / "dataflow.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_check_contracts.py"),
         "--dataflow-json", str(df)], capture_output=True, text=True,
        timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "repro_torch.analysis.lint: 0 violation(s) -- clean" in \
        proc.stdout
    section = json.loads(df.read_text())
    assert section["section"] == "kernel-dataflow"
    assert section["violations"] == []


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

_JAX_EXECUTOR = {None: None, "cuda": "pallas-tpu", "torch-ref": "interpret",
                 "torch-dense": "dense-xla", "shard_map": "shard_map",
                 "shard_map-scatter": "shard_map-scatter"}


def test_backward_policies_match_the_jax_package():
    from repro.core import tsmm as jax_tsmm

    n = 0
    for mode in audit._POLICY_MODES:
        for reduce_ in ("psum", "psum_scatter", "none"):
            for split in audit._POLICY_SPLITS:
                for ex in audit._POLICY_EXECUTORS:
                    p = tsmm.GemmPolicy(mode=mode, reduce=reduce_,
                                        split=split, executor=ex)
                    jp = jax_tsmm.GemmPolicy(mode=mode, reduce=reduce_,
                                             split=split,
                                             executor=_JAX_EXECUTOR[ex])
                    b, jb = tsmm.backward_policy(p), \
                        jax_tsmm.backward_policy(jp)
                    assert (b.mode, b.reduce, b.split) == \
                        (jb.mode, jb.reduce, jb.split), (p, jp)
                    assert _JAX_EXECUTOR[b.executor] == jb.executor
                    assert contracts.check_backward_policy(p, b) == []
                    n += 1
    assert n == (len(audit._POLICY_MODES) * 3 * len(audit._POLICY_SPLITS)
                 * len(audit._POLICY_EXECUTORS))


def test_quant_and_abft_survive_the_backward_like_the_jax_package():
    from repro.core import tsmm as jax_tsmm

    for abft in ("none", "verify", "correct"):
        for quant in ("none", "int8"):
            b = tsmm.backward_policy(tsmm.GemmPolicy(abft=abft, quant=quant,
                                                     split=4))
            jb = jax_tsmm.backward_policy(jax_tsmm.GemmPolicy(
                abft=abft, quant=quant, split=4))
            assert (b.abft, b.quant, b.split) == (jb.abft, jb.quant,
                                                  jb.split)


def test_sweep_shapes_are_the_references():
    from repro.analysis import audit as jax_audit

    assert audit.SWEEP_SHAPES == jax_audit.SWEEP_SHAPES
    assert audit.QR_SWEEP_SHAPES == jax_audit.QR_SWEEP_SHAPES
    assert audit.QR_SWEEP_SHARDS == jax_audit.QR_SWEEP_SHARDS
    assert audit.SWEEP_SPLITS == jax_audit.SWEEP_SPLITS
    assert dataclasses.replace(audit.SWEEP_SPECS[0]) == perf_model.H100
    assert torch.float32 in audit.SWEEP_DTYPES
