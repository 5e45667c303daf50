"""The port's autotuner (``repro_torch.core.autotune``) against the JAX
package's (``repro.core.autotune``), on the CPU.

Keys, bucketing and the JSON schemas against JAX's strings (a JAX table
loads in the port with its records and without its TPU fit cells; JAX
refuses a port table); a tuned S = 4 record steering ``tsmm.tsmm`` in
both packages (JAX in interpret mode) to the same launch and, at the f32
tolerance of ``tests/test_torch_dispatch.py``, the same product; the
resolution order of ``ops.resolve_params`` (pin, record, CPU rule, the
chooser under fitted constants) and the backward; the fits, calibration
on synthetic timings and ``autotune_shape`` on the plain versions; and
``contracts.check_tuning_record``.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import tsmm as jtsmm
from repro_torch.analysis import contracts
from repro_torch.core import autotune, perf_model, tsmm
from repro_torch.kernels import ops

TOL = dict(rtol=1e-3, atol=1e-4)
DIMS = (1, 16, 127, 128, 129, 4096, 65024, 128256)
DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.int8, jnp.int8))
SHAPE = (4096, 1024, 8)
ABFT_STAGE = (4096, 256, 2)
ROUTER = (8192, 4096, 8)


def _record(kind="tsm2r", shape=SHAPE, dtype="float32", splits=4,
            executor="torch-ref", pick=None):
    params = () if splits is None else (("splits", splits),)
    return autotune.TuningRecord(
        kind=kind, bucket=autotune.bucket_shape(*shape), dtype=dtype,
        spec_name="h100", executor=executor, shape=shape, params=params,
        measured_us=120.0, model_us=100.0, model_error=0.2,
        model_pick=params if pick is None else (("splits", pick),),
        model_pick_measured_us=150.0)


def _table(*records, fits=()):
    return autotune.TuningTable.from_records(records, fits)


def _jrecord(params, shape=SHAPE, kind="tsm2r"):
    return jautotune.TuningRecord(
        kind=kind, bucket=jautotune.bucket_shape(*shape), dtype="float32",
        spec_name="tpu_v5e", executor="interpret", shape=shape,
        params=tuple(sorted(params.items())), measured_us=120.0,
        model_us=100.0, model_error=0.2,
        model_pick=tuple(sorted(params.items())),
        model_pick_measured_us=150.0)


def _pair(seed, sa, sb):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, sa).astype(np.float32),
            rng.uniform(-1, 1, sb).astype(np.float32))


def _splits(log, kind):
    return [lm.splits for e in log for lm in e.launches
            if lm.kind == kind]


def _resolve(kind, shape, dtype=torch.float32, device=None, **pol):
    return ops.resolve_params(kind, *shape, dtype, tsmm.GemmPolicy(**pol),
                              device=device)["splits"]


# ---------------------------------------------------------------------------
# Keys and bucketing: JAX's strings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", DIMS)
def test_keys_equal_jax(d):
    assert autotune.bucket_dim(d) == jautotune.bucket_dim(d)
    shape = (d, min(d, 4096), 16)
    bucket = autotune.bucket_shape(*shape)
    assert bucket == jautotune.bucket_shape(*shape)
    for tdt, jdt in DTYPES:
        name = autotune._dtype_name(tdt)
        assert name == jautotune._dtype_name(jdt)
        for kind in autotune.KINDS:
            assert autotune.record_key(kind, bucket, name, "h100", "cuda") \
                == jautotune.record_key(kind, bucket, name, "h100", "cuda")
            assert autotune.fit_key(kind, bucket, name, "h100") \
                == jautotune.fit_key(kind, bucket, name, "h100")
    assert autotune.fit_key(*autotune.GLOBAL_FIT, "h100") \
        == jautotune.fit_key(*jautotune.GLOBAL_FIT, "h100")


def test_record_key_names_dtype_as_numpy():
    key = autotune.record_key("tsm2r", autotune.bucket_shape(20480, 20480, 16),
                              autotune._dtype_name(torch.bfloat16), "h100",
                              "cuda")
    assert key == "tsm2r|32768x32768x16|bfloat16|h100|cuda"
    assert _record().key == "tsm2r|4096x1024x8|float32|h100|torch-ref"


# ---------------------------------------------------------------------------
# The table: JSON round trip and schemas
# ---------------------------------------------------------------------------

def test_table_roundtrip_and_lookup(tmp_path):
    fits = (autotune.SpecFit("tsm2r", autotune.bucket_shape(*SHAPE),
                             "float32", "h100", 2e-5, 3e12),
            autotune.SpecFit(*autotune.GLOBAL_FIT, "h100", 6e-6, 3.1e12))
    tbl = _table(_record(), _record("tsm2l", (8192, 16, 16), splits=None),
                 fits=fits)
    path = tmp_path / "table.json"
    tbl.save(path)
    data = json.loads(path.read_text())
    assert data["schema"] == autotune.TABLE_SCHEMA == \
        "repro-tsm2x-tuning-gpu/1"
    loaded = autotune.TuningTable.load(path)
    assert loaded == tbl and loaded.fits == fits
    hit = loaded.lookup("tsm2r", 3000, 1000, 8, dtype=torch.float32,
                        spec="h100", executor="torch-ref")
    assert hit == _record() and hit.params_dict == {"splits": 4}
    assert loaded.lookup("tsm2r", 3000, 1000, 16, dtype=torch.float32,
                         spec="h100", executor="torch-ref") is None
    assert loaded.lookup("tsm2r", 3000, 1000, 8, dtype=torch.float32,
                         spec="h100", executor="cuda") is None


def test_table_add_replaces_same_key():
    tbl = _table(_record())
    tbl2 = tbl.add(_record(splits=8))
    assert len(tbl2.records) == 1 and tbl2.records[0].params_dict == \
        {"splits": 8}
    assert tbl.records[0].params_dict == {"splits": 4}   # immutable


def test_table_is_hashable_on_policy():
    tbl = _table(_record())
    pol = tsmm.GemmPolicy(tuning_table=tbl)
    assert hash(pol) == hash(tsmm.GemmPolicy(tuning_table=tbl))
    assert pol != tsmm.GemmPolicy()


def test_from_json_rejects_foreign_schema():
    with pytest.raises(ValueError, match="not a tuning table"):
        autotune.TuningTable.from_json({"schema": "repro-tsm2x-bench/1",
                                        "records": []})


def test_jax_table_loads_without_its_fits():
    jrec = _jrecord({"block_m": 256, "block_k": 128, "splits": 4})
    jfits = (jautotune.SpecFit("tsm2r", jautotune.bucket_shape(*SHAPE),
                               "float32", "tpu_v5e", 1e-6, 2e-6, 0.75),
             jautotune.SpecFit(*jautotune.GLOBAL_FIT, "tpu_v5e", 3e-7,
                               1.5e-6))
    data = jautotune.TuningTable.from_records([jrec], jfits).to_json()
    tbl = autotune.TuningTable.from_json(json.loads(json.dumps(data)))
    assert [r.key for r in tbl.records] == [jrec.key]
    assert tbl.records[0].params == jrec.params
    assert tbl.fits == ()
    assert tbl.fitted_spec("tsm2r", *SHAPE, dtype=torch.float32,
                           spec=perf_model.H100) == perf_model.H100
    # its TPU records steer nothing in the port
    assert _resolve("tsm2r", SHAPE, tuning_table=tbl) == \
        _resolve("tsm2r", SHAPE)


def test_jax_rejects_a_port_table():
    data = _table(_record()).to_json()
    with pytest.raises(ValueError, match="not a tuning table"):
        jautotune.TuningTable.from_json(data)


# ---------------------------------------------------------------------------
# The table steers dispatch as it does in the JAX package
# ---------------------------------------------------------------------------

def test_tuned_splits_drive_dispatch_as_jax():
    a, b = _pair(0, SHAPE[:2], SHAPE[1:])
    jtbl = jautotune.TuningTable.from_records(
        [_jrecord({"block_m": 256, "block_k": 128, "splits": 4})])
    with jtsmm.policy(tuning_table=jtbl, interpret=True), \
            jtsmm.record_dispatches() as jlog:
        want = jtsmm.tsmm(jnp.asarray(a), jnp.asarray(b))
    tbl = _table(_record())
    with tsmm.policy(tuning_table=tbl), tsmm.record_dispatches() as log:
        got = tsmm.tsmm(torch.from_numpy(a), torch.from_numpy(b))
    assert [e.kind for e in log] == [e.kind for e in jlog] == ["tsm2r"]
    assert _splits(log, "tsm2r") == _splits(jlog, "tsm2r") == [4]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without the table each package resolves its own default: the
    # chooser's S in JAX, S = 1 for the port's CPU tensors
    with jtsmm.policy(interpret=True), jtsmm.record_dispatches() as jlog:
        jtsmm.tsmm(jnp.asarray(a), jnp.asarray(b))
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(torch.from_numpy(a), torch.from_numpy(b))
    assert _splits(jlog, "tsm2r") != [4] and _splits(log, "tsm2r") == [1]


@pytest.mark.parametrize("split,want", [("never", 1), (2, 2)])
def test_pinned_split_beats_the_record(split, want):
    tbl = _table(_record())
    assert _resolve("tsm2r", SHAPE, device=torch.device("cpu"), split=split,
                    tuning_table=tbl) == want
    assert _resolve("tsm2r", SHAPE, split=split, tuning_table=_table(
        _record(executor="cuda"))) == want


def test_record_keeps_to_its_executor():
    cuda = _table(_record(splits=16, executor="cuda"))
    cpu = _table(_record(splits=16))
    on_cpu = torch.device("cpu")
    # a card's record never steers a CPU call, nor a CPU record the card
    assert _resolve("tsm2r", SHAPE, device=on_cpu, tuning_table=cuda) == 1
    assert _resolve("tsm2r", SHAPE, device=on_cpu, tuning_table=cpu) == 16
    assert _resolve("tsm2r", SHAPE, tuning_table=cuda) == 16
    assert _resolve("tsm2r", SHAPE, tuning_table=cpu) == \
        perf_model.choose_splits_tsm2r(*SHAPE) != 16


def test_int8_record_steers_only_under_int8():
    tbl = _table(_record(dtype="int8", splits=2, executor="cuda"))
    assert _resolve("tsm2r", SHAPE, quant="int8", tuning_table=tbl) == 2
    assert _resolve("tsm2r", SHAPE, tuning_table=tbl) == \
        perf_model.choose_splits_tsm2r(*SHAPE)
    assert _resolve("tsm2r", SHAPE, quant="int8", tuning_table=_table(
        _record(splits=2, executor="cuda"))) == \
        perf_model.choose_splits_tsm2r(*SHAPE, dtype=torch.int8)


def test_tuned_splits_are_clamped_like_chosen_ones():
    # a record tuned on the deepest shape of the bucket: S = 32 slices of
    # 32-deep blocks do not fit k = 600, so the resolution clamps it
    tbl = _table(_record(splits=32, executor="cuda"))
    got = _resolve("tsm2r", (4096, 600, 8), tuning_table=tbl)
    assert got == _resolve("tsm2r", (4096, 600, 8), split=32) == 19


def test_backward_keeps_the_table():
    tbl = _table(_record("tsmt", SHAPE, splits=4))
    pol = tsmm.GemmPolicy(tuning_table=tbl, split=2)
    assert tsmm.backward_policy(pol).tuning_table is tbl
    assert not contracts.check_backward_policy(pol,
                                               tsmm.backward_policy(pol))
    a, b = _pair(1, SHAPE[:2], SHAPE[1:])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b).requires_grad_()
    for table, want in ((tbl, [4]), (None, [1])):
        with tsmm.policy(tuning_table=table):
            out = tsmm.tsmm(ta, tb)
            with tsmm.record_dispatches() as log:
                out.sum().backward()
        assert [e.kind for e in log] == ["tsmt"]
        assert _splits(log, "tsmt") == want
        np.testing.assert_allclose(
            tb.grad.numpy(), a.T @ np.ones((SHAPE[0], SHAPE[2]), np.float32),
            rtol=1e-3, atol=1e-3)
        tb.grad = None


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

def test_fitted_spec_prefers_bucket_then_global():
    bucket = autotune.SpecFit("tsm2r", autotune.bucket_shape(*SHAPE),
                              "float32", "h100", 2e-5, 2e12)
    glob = autotune.SpecFit(*autotune.GLOBAL_FIT, "h100", 7e-6, 3e12)
    spec = dataclasses.replace(perf_model.H100, n_sms=114)
    tbl = _table(fits=(bucket, glob))
    local = tbl.fitted_spec("tsm2r", *SHAPE, dtype=torch.float32, spec=spec)
    assert (local.launch_s, local.hbm_bw, local.n_sms) == (2e-5, 2e12, 114)
    other = tbl.fitted_spec("tsmt", 65536, 64, 8, dtype=torch.float32,
                            spec=spec)
    assert (other.launch_s, other.hbm_bw, other.n_sms) == (7e-6, 3e12, 114)
    assert _table(fits=(bucket,)).fitted_spec(
        "tsmt", 65536, 64, 8, dtype=torch.float32, spec=spec) == spec
    assert _table(_record()).fitted_spec(
        "tsm2r", *SHAPE, dtype=torch.float32, spec=spec) == spec


def test_launch_fit_moves_the_abft_stage_but_not_the_router():
    bw = perf_model.H100.hbm_bw
    fits = (autotune.SpecFit("tsmt", autotune.bucket_shape(*ABFT_STAGE),
                             "float32", "h100", 1e-3, bw),
            autotune.SpecFit("tsm2r", autotune.bucket_shape(*ROUTER),
                             "bfloat16", "h100", 1e-3, bw))
    tbl = _table(fits=fits)
    assert _resolve("tsmt", ABFT_STAGE) == 64
    assert _resolve("tsmt", ABFT_STAGE, tuning_table=tbl) == 1
    # the router's split epilogue is a torch.sum, which the model prices
    # at no launch (tsm2r_model_time), so a dear launch leaves it split
    assert _resolve("tsm2r", ROUTER, torch.bfloat16) == 4
    assert _resolve("tsm2r", ROUTER, torch.bfloat16, tuning_table=tbl) == 4


def test_fit_spec_empty_observations_is_identity():
    result = autotune.fit_spec(perf_model.H100, [])
    assert result.spec == perf_model.H100
    assert result.error_before == result.error_after == 0.0


CAL_SHAPES = (("tsm2r", 4096, 1024, 8), ("tsmt", *ABFT_STAGE),
              ("tsm2l", 8192, 16, 16), ("tsmt", 4096, 64, 8))


def _true_spec():
    return dataclasses.replace(perf_model.H100,
                               launch_s=perf_model.H100.launch_s * 8,
                               hbm_bw=perf_model.H100.hbm_bw * 0.6)


def _synthetic_time(spec):
    """A ``time_call`` that runs the arm once and returns the model's
    time of the launch it recorded, under ``spec``."""
    def fake(fn, *args, reps=3, warmup=1):
        with tsmm.record_dispatches() as log:
            fn(*args)
        (lm,) = [lm for e in log for lm in e.launches if lm.kind != "reduce"]
        m, d1, d2 = lm.shape
        if lm.kind == "tsm2l":
            return perf_model.tsm2l_model_time(m, d1, d2, spec, lm.dtype)
        model = (perf_model.tsm2r_model_time if lm.kind == "tsm2r"
                 else perf_model.tsmt_model_time)
        return model(m, d1, d2, spec, lm.dtype, splits=lm.splits)
    return fake


def test_calibrate_recovers_synthetic_constants(monkeypatch):
    monkeypatch.setattr(autotune, "time_call", _synthetic_time(_true_spec()))
    res = autotune.calibrate(CAL_SHAPES, device="cpu", reps=1, warmup=0)
    assert res.error_before > 0.05
    assert res.error_after < res.error_before * 0.2
    assert res.spec.launch_s > perf_model.H100.launch_s
    assert res.spec.hbm_bw < perf_model.H100.hbm_bw
    cells = {(f.kind, f.bucket, f.dtype) for f in res.table.fits}
    assert (*autotune.GLOBAL_FIT,) in cells
    for kind, *shape in CAL_SHAPES:
        assert (kind, autotune.bucket_shape(*shape), "float32") in cells
    assert len(res.table.records) == len(CAL_SHAPES)
    assert hash(tsmm.GemmPolicy(tuning_table=res.table)) is not None


def test_calibrate_base_table_merges_records_and_ages_out_fits(monkeypatch):
    monkeypatch.setattr(autotune, "time_call", _synthetic_time(_true_spec()))
    base = autotune.calibrate([("tsm2r", 4096, 1024, 8),
                               ("tsm2l", 8192, 16, 16)], device="cpu",
                              reps=1, warmup=0).table
    stale = autotune.SpecFit("tsm2l", autotune.bucket_shape(8192, 16, 16),
                             "float32", "h100", 123.0, 456.0)
    base = autotune.TuningTable(records=base.records, fits=(stale,))
    res = autotune.calibrate([("tsm2r", 4096, 1024, 8)], device="cpu",
                             reps=1, warmup=0, base_table=base)
    kinds = sorted(r.kind for r in res.table.records)
    assert kinds == ["tsm2l", "tsm2r"]
    assert all(f.launch_s != 123.0 for f in res.table.fits)
    assert {f.kind for f in res.table.fits} == {"*", "tsm2r"}


# ---------------------------------------------------------------------------
# autotune_shape and build_table on the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,shape", [("tsm2r", (2048, 512, 8)),
                                        ("tsmt", (4096, 64, 8)),
                                        ("tsm2l", (8192, 16, 16))])
def test_autotune_shape_produces_consistent_record(kind, shape):
    rec = autotune.autotune_shape(kind, *shape, device="cpu", reps=1,
                                  warmup=0)
    assert (rec.kind, rec.shape, rec.dtype) == (kind, shape, "float32")
    assert (rec.executor, rec.spec_name) == ("torch-ref", "h100")
    if kind == "tsm2l":
        assert rec.params == rec.model_pick == ()
        model = perf_model.tsm2l_model_time(*shape)
    else:
        cands = perf_model.split_candidates(kind, *shape)
        assert rec.params_dict["splits"] in cands
        choose = (perf_model.choose_splits_tsm2r if kind == "tsm2r"
                  else perf_model.choose_splits_tsmt)
        assert rec.model_pick == (("splits", choose(*shape)),)
        fn = (perf_model.tsm2r_model_time if kind == "tsm2r"
              else perf_model.tsmt_model_time)
        model = fn(*shape, splits=rec.params_dict["splits"])
    assert rec.model_us == pytest.approx(model * 1e6)
    assert rec.measured_us > 0 and rec.model_pick_measured_us > 0
    assert rec.model_error == pytest.approx(
        abs(rec.model_us - rec.measured_us) / rec.measured_us)
    tbl = _table(rec)
    assert tbl.lookup(kind, *shape, dtype=torch.float32, spec="h100",
                      executor="torch-ref") == rec


def test_autotune_shape_keys_int8_as_int8():
    rec = autotune.autotune_shape("tsmt", 4096, 64, 8, device="cpu", reps=1,
                                  warmup=0,
                                  policy=tsmm.GemmPolicy(quant="int8"))
    assert rec.dtype == "int8"
    assert rec.params_dict["splits"] in perf_model.split_candidates(
        "tsmt", 4096, 64, 8, dtype=torch.int8)


def test_autotune_arms_ignore_the_ambient_pin_and_table(monkeypatch):
    seen = []
    real = autotune.time_call

    def spy(fn, *args, **kw):
        with tsmm.record_dispatches() as log:
            fn(*args)
        seen.extend(_splits(log, "tsm2r"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(autotune, "time_call", spy)
    with tsmm.policy(split=2, tuning_table=_table(_record(splits=8))):
        autotune.autotune_shape("tsm2r", *SHAPE, device="cpu", reps=1,
                                warmup=0)
    assert seen == perf_model.split_candidates("tsm2r", *SHAPE)


def test_autotune_unknown_kind_raises():
    with pytest.raises(ValueError, match="tsm2r, tsm2l, tsmt"):
        autotune.autotune_shape("tsmr", 1024, 256, 8, device="cpu")


def test_autotune_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_shape("tsm2r", 1024, 256, 8)


def test_build_table_warns_on_bucket_collision():
    with pytest.warns(UserWarning, match="share table bucket"):
        tbl = autotune.build_table(
            [("tsm2r", 2000, 512, 8), ("tsm2r", 1500, 512, 8)],
            device="cpu", reps=1, warmup=0)
    assert len(tbl.records) == 1


def test_time_call_median_averages_the_middle_pair(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 4.0, 4.0, 6.0, 6.0, 12.0])
    monkeypatch.setattr(autotune.time, "perf_counter", lambda: next(clock))
    assert autotune.time_call(lambda: None, reps=4, warmup=0) == 2.5


def test_tsm2l_model_time_prices_its_body():
    # the stream body's persistent grid fills the card: the bytes alone
    m, k, n = 1 << 20, 16, 16
    t = perf_model.tsm2l_model_time(m, k, n)
    want = (m * k + k * n + m * n) * 4 / perf_model.H100.hbm_bw
    assert t == pytest.approx(want + perf_model.H100.launch_s)
    # a short tile grid occupies few SMs, and int8 writes f32
    assert perf_model.tsm2l_model_time(512, 300, 16) > \
        (512 * 300 + 300 * 16 + 512 * 16) * 4 / perf_model.H100.hbm_bw
    q8 = perf_model.tsm2l_model_time(m, k, n, dtype=torch.int8)
    assert q8 == pytest.approx((m * k + k * n + 4 * m * n)
                               / perf_model.H100.hbm_bw
                               + perf_model.H100.launch_s)


# ---------------------------------------------------------------------------
# check_tuning_record
# ---------------------------------------------------------------------------

def _check(rec, **kw):
    return contracts.check_tuning_record(
        rec.kind, rec.shape, autotune.record_launch(rec),
        autotune._torch_dtype(rec.dtype), executor=rec.executor,
        known_executors=tuple(tsmm.executors()), **kw)


@pytest.mark.parametrize("rec", [
    _record(), _record(executor="cuda", splits=1),
    _record("tsmt", (65024, 4096, 4), splits=8, executor="cuda"),
    _record("tsmt", ABFT_STAGE, splits=64),
    _record("tsm2l", (65024, 4, 4), splits=None, executor="cuda"),
    _record(dtype="int8", shape=(65024, 4096, 4), splits=16)],
    ids=["tsm2r", "tsm2r-s1", "tsmt-q", "tsmt-abft", "tsm2l", "int8"])
def test_check_tuning_record_passes_sound_records(rec):
    assert _check(rec) == []


def _rules(vs):
    return sorted({v.rule for v in vs})


def test_check_tuning_record_flags_unknown_executor():
    assert _rules(_check(_record(executor="pallas-tpu"))) == \
        ["unknown-executor"]
    # without a registry to hold it against, the executor is not checked
    rec = _record(executor="pallas-tpu")
    assert contracts.check_tuning_record(
        rec.kind, rec.shape, autotune.record_launch(rec), torch.float32,
        executor=rec.executor) == []


@pytest.mark.parametrize("shape,splits", [(SHAPE, 3), (SHAPE, 256),
                                          ((4096, 64, 8), 4)])
def test_check_tuning_record_flags_stale_splits(shape, splits):
    # S = 3 is no candidate; 256 and (k = 64) 4 exceed the whole blocks
    rec = _record(shape=shape, splits=splits)
    assert "tuning-splits" in _rules(_check(rec))


def test_check_tuning_record_flags_a_broken_launch():
    launch = autotune.record_launch(_record())
    bad = {**launch, "smem": 300 * 1024}
    vs = contracts.check_tuning_record("tsm2r", SHAPE, bad, torch.float32)
    assert _rules(vs) == ["smem-budget"]
    del bad["tile"]
    assert _rules(contracts.check_tuning_record(
        "tsm2r", SHAPE, bad, torch.float32)) == ["missing-params"]


def test_new_policy_field_defaults_as_jax():
    assert tsmm.GemmPolicy().tuning_table is None
    assert jtsmm.GemmPolicy().tuning_table is None
