"""The port's int8 path against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages. On the
CPU the port's int8 wrappers run their plain versions (the five CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
the same plain versions); the JAX side runs its int8 Pallas kernels in
interpret mode, as ``tests/test_quant.py`` does.

Tolerances and why:

* helpers (codes, scales, fake-quant, records): bit for bit, since both
  packages upcast to f32, divide, round half to even and clip alike;
* plain versions against the JAX kernels on identical int8 inputs and
  scales: f32 rtol 1e-5 (the integer sums are exact on both sides; only
  where the f32 folds and sums round differs);
* whole ops against the f32 oracle: the JAX tests' max-norm relative 5%
  (6% for bf16 outputs); gradients 10%; int8 PowerSGD 10% of f32 with a
  3.5-4.1x byte ratio (``test_quant.py``);
* serving from records: the JAX serving tests' 1e-4 (the records
  dequantize to the same f32 values on both sides);
* the int8 prefill's normalised distance from its dense arm: the JAX
  package's own distance within 1e-4 (one activation band on both sides);
* an int8 train step: loss within 5e-2 of JAX's (the JAX kernels' scale
  band is their resolved block_m, the port's ``perf_model.Q8_BAND``, so
  activations quantize in different bands).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.kernels import quant as jquant
from repro.models import model as jmodel
from repro.optim import powersgd as jpowersgd
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import _build, ops, quant, ref
from repro_torch.kernels import tsm2l as k_tsm2l
from repro_torch.kernels import tsm2r as k_tsm2r
from repro_torch.kernels import tsmt as k_tsmt
from repro_torch.models import model
from repro_torch.optim import powersgd
from repro_torch.serve import engine

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
REL_TOL = {"f32": 0.05, "bf16": 0.06}
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _pair(seed, shape, name="f32"):
    x = _np(seed, shape)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _t(x):
    """A JAX array as a torch tensor (bf16 by its bits)."""
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


# ---------------------------------------------------------------------------
# Helpers: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,band", [(512, 33, 256), (96, 8, 32),
                                      (64, 1, 64)])
def test_quantize_blocks_matches_jax_bits(m, n, band, name):
    x, jx = _pair(m + n, (m, n), name)
    x = x * 3.0 if name == "f32" else x
    jx = jx * 3.0 if name == "f32" else jx
    jq, js = jquant.quantize_blocks(jx, band)
    q, s = quant.quantize_blocks(x, band)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = quant.dequantize_blocks(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_blocks(jq, js)))


def test_quantize_blocks_short_last_band_equals_zero_padding():
    """A short last band holds only real rows; JAX pads with zeros, which
    change no absmax, so the codes of the real rows and every scale are
    the same."""
    x = _np(3, (1000, 12))
    jq, js = jquant.quantize_blocks(jnp.asarray(np.pad(x, ((0, 24), (0, 0)))),
                                    256)
    q, s = quant.quantize_blocks(torch.from_numpy(x), 256)
    assert tuple(s.shape) == (4, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq)[:1000])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = quant.dequantize_blocks(q, s, block_rows=256)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_blocks(jq, js))[:1000])


def test_zero_band_gets_scale_one():
    x = torch.zeros(16, 8)
    x[8:] = torch.from_numpy(_np(4, (8, 8)))
    q, s = quant.quantize_blocks(x, 8)
    assert float(s[0, 0]) == 1.0 and not q[:8].any()
    torch.testing.assert_close(quant.dequantize_blocks(q, s)[:8], x[:8],
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_quantize_tensor_and_fake_quant_match_jax_bits(name):
    x, jx = _pair(7, (300, 5), name)
    jq, js = jquant.quantize_tensor(jx)
    q, s = quant.quantize_tensor(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    fq, jfq = quant.fake_quant(x), jquant.fake_quant(jx)
    assert fq.dtype == x.dtype
    np.testing.assert_array_equal(fq.float().numpy(),
                                  np.asarray(jfq.astype(jnp.float32)))


def test_weight_records_roundtrip_match_jax():
    w = _np(9, (512, 128))
    jrec = jquant.quantize_param(jnp.asarray(w))
    rec = quant.quantize_param(torch.from_numpy(w))
    assert tuple(rec["q8_scale"].shape) == (2, 1)
    for key in ("q8", "q8_scale"):
        np.testing.assert_array_equal(rec[key].numpy(),
                                      np.asarray(jrec[key]))
    np.testing.assert_array_equal(
        quant.dequantize_param(rec).numpy(),
        np.asarray(jquant.dequantize_param(jrec)))
    # 300 rows: 256 does not divide them, so one per-tensor band (JAX rule)
    odd = quant.quantize_param(torch.from_numpy(_np(10, (300, 16))))
    assert tuple(odd["q8_scale"].shape) == (1, 1)


def _ties(name):
    """Two 8-row bands whose codes land on exact half steps: band 0 has
    absmax 127 (scale 1), band 1 absmax 254 (scale 2)."""
    x = np.zeros((16, 4), np.float32)
    x[:8] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 4
                     ).reshape(4, 8).T
    x[8:] = np.array([254.0, 1.0, 3.0, 5.0, -1.0, -3.0, -5.0, 253.0] * 4
                     ).reshape(4, 8).T
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_round_half_even_ties_match_jax_bits(name):
    x, jx = _ties(name)
    jq, js = jquant.quantize_blocks(jx, 8)
    q, s = quant.quantize_blocks(x, 8)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.flatten().tolist() == [1.0, 2.0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # half steps round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert q[1:4, 0].tolist() == [0, 2, 2] == q[9:12, 0].tolist()
    assert q[4:7, 0].tolist() == [0, -2, -2] == q[12:15, 0].tolist()
    jq, js = jquant.quantize_tensor(jx)
    q, s = quant.quantize_tensor(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_scales_are_ieee_divisions_by_127():
    """scale = absmax / 127 correctly rounded in f32, as JAX divides (a
    reciprocal multiply would move some scales by one bit)."""
    x = _np(31, (4096, 3), 0.0, 50.0)
    _, s = quant.quantize_blocks(torch.from_numpy(x), 1)
    want = np.abs(x).max(axis=1) / np.float32(127.0)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(s.numpy()[:, 0], want)
    recip = np.abs(x).max(axis=1) * (np.float32(1.0) / np.float32(127.0))
    assert (recip != want).any()      # the two roundings do differ here


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 40), (64, 17), (1, 5), (2, 300)])
def test_kmajor_codes_are_the_row_major_codes_transposed(name, shape):
    x, jx = _pair(len(shape) + shape[0], shape, name)
    q, s = quant.quantize_tensor(x)
    qk, sk = quant.quantize_tensor(x, kmajor=True)
    assert qk.shape == x.shape and qk.dtype == torch.int8
    assert qk.t().is_contiguous()
    assert torch.equal(qk, q) and torch.equal(sk, s)
    jq, js = jquant.quantize_tensor(jx)
    np.testing.assert_array_equal(qk.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(js))
    with pytest.raises(ValueError):
        quant.quantize_tensor(x.reshape(-1), kmajor=True)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_tsm2r_q8_wrapper_same_bits_for_kmajor_and_row_major_b(out):
    tdt, jdt = DTYPES[out]
    j, (aq, bq, as_, bs) = _q8_operands(41, (320, 256), (256, 40), 64,
                                        False)
    bk = bq.t().contiguous().t()
    assert k_tsm2r.is_kmajor(bk) and not k_tsm2r.is_kmajor(bq)
    before = k_tsm2r.q8_launches
    got_k = k_tsm2r.tsm2r_q8(aq, bk, as_, bs, 64, tdt)
    got_r = k_tsm2r.tsm2r_q8(aq, bq, as_, bs, 64, tdt)
    assert k_tsm2r.q8_launches == before        # the plain version ran
    assert torch.equal(got_k, got_r)
    want = jquant.tsm2r_q8_pallas(*j, out_dtype=jdt, block_m=64,
                                  block_k=128, interpret=True)
    _close(got_k, want.astype(jnp.float32))
    # Only tsm2r_q8 reads a K-major B; the split kernel wants row-major.
    with pytest.raises(ValueError):
        k_tsm2r.tsm2r_q8_split(aq, bk, as_, bs, 64, 2, 32)


def test_quantize_on_the_cpu_never_reaches_the_cuda_pass(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    for fn in ("build", "library", "launcher", "nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    before = quant.launches
    x = torch.from_numpy(_np(42, (300, 64)))
    quant.quantize_blocks(x, 64)
    quant.quantize_tensor(x, kmajor=True)
    quant.fake_quant(x)
    assert quant.launches == before
    assert "quantize" in _build.KERNELS
    assert (_build.CSRC / "quantize.cu").is_file()
    assert len(_build.SIGNATURES["quantize"]) == 9
    assert _build.TAGS["quantize"] == ("f32", "bf16")


# ---------------------------------------------------------------------------
# The five plain versions against the JAX int8 kernels
# ---------------------------------------------------------------------------

def _q8_operands(seed, a_shape, b_shape, band, b_banded):
    a, ja = _pair(seed, a_shape)
    b, jb = _pair(seed + 1, b_shape)
    jaq, jas = jquant.quantize_blocks(ja, band)
    jbq, jbs = (jquant.quantize_blocks(jb, band) if b_banded
                else jquant.quantize_tensor(jb))
    return (jaq, jbq, jas, jbs), tuple(_t(v) for v in (jaq, jbq, jas, jbs))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_tsm2r_q8_ref_matches_jax(out):
    band = 128
    j, t = _q8_operands(11, (512, 512), (512, 16), band, False)
    tdt, jdt = DTYPES[out]
    want = jquant.tsm2r_q8_pallas(*j, out_dtype=jdt, block_m=band,
                                  block_k=128, interpret=True)
    got = ref.tsm2r_q8_ref(*t, band, tdt)
    assert got.dtype == tdt
    _close(got, want.astype(jnp.float32))


def test_tsm2r_q8_split_ref_matches_jax():
    band, splits, bk = 128, 2, 128
    j, t = _q8_operands(12, (256, 512), (512, 8), band, False)
    want = jquant.tsm2r_q8_pallas_split(*j, block_m=band, block_k=bk,
                                        splits=splits, interpret=True)
    _close(ref.tsm2r_q8_split_ref(*t, band, splits, bk), want)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_tsm2l_q8_ref_matches_jax(out):
    band = 256
    j, t = _q8_operands(13, (1024, 8), (8, 4), band, False)
    tdt, jdt = DTYPES[out]
    want = jquant.tsm2l_q8_pallas(*j, out_dtype=jdt, block_m=band,
                                  interpret=True)
    _close(ref.tsm2l_q8_ref(*t, band, tdt), want.astype(jnp.float32))


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_tsmt_q8_ref_matches_jax(out):
    band = 256
    j, t = _q8_operands(14, (1024, 128), (1024, 8), band, True)
    tdt, jdt = DTYPES[out]
    want = jquant.tsmt_q8_pallas(*j, out_dtype=jdt, block_m=band,
                                 block_a=128, interpret=True)
    _close(ref.tsmt_q8_ref(*t, band, tdt), want.astype(jnp.float32))


def test_tsmt_q8_split_ref_matches_jax():
    band, splits = 128, 2
    j, t = _q8_operands(15, (1024, 128), (1024, 4), band, True)
    want = jquant.tsmt_q8_pallas_split(*j, block_m=band, block_a=128,
                                       splits=splits, interpret=True)
    _close(ref.tsmt_q8_split_ref(*t, band, splits), want)


def test_q8_wrappers_on_the_cpu_run_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build")

    for fn in ("build", "library", "launcher", "nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    # 300 rows: the last of five 64-row bands is short.
    aq, as_ = quant.quantize_blocks(torch.from_numpy(_np(16, (300, 64))), 64)
    bq, bs = quant.quantize_tensor(torch.from_numpy(_np(17, (64, 4))))
    xq, xs = quant.quantize_blocks(torch.from_numpy(_np(18, (300, 16))), 64)
    yq, ys = quant.quantize_blocks(torch.from_numpy(_np(19, (300, 4))), 64)
    cases = [
        (k_tsm2r.tsm2r_q8(aq, bq, as_, bs, 64, torch.bfloat16),
         ref.tsm2r_q8_ref(aq, bq, as_, bs, 64, torch.bfloat16)),
        (k_tsm2r.tsm2r_q8_split(aq, bq, as_, bs, 64, 2, 32),
         ref.tsm2r_q8_split_ref(aq, bq, as_, bs, 64, 2, 32)),
        (k_tsm2l.tsm2l_q8(aq, bq, as_, bs, 64, torch.float32),
         ref.tsm2l_q8_ref(aq, bq, as_, bs, 64, torch.float32)),
        (k_tsmt.tsmt_q8(xq, yq, xs, ys, 64, torch.float32),
         ref.tsmt_q8_ref(xq, yq, xs, ys, 64, torch.float32)),
        (k_tsmt.tsmt_q8_split(xq, yq, xs, ys, 64, 3),
         ref.tsmt_q8_split_ref(xq, yq, xs, ys, 64, 3))]
    for got, want in cases:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["float", "scales", "out", "meta"])
def test_q8_wrappers_reject_bad_operands(case):
    _, (aq, bq, as_, bs) = _q8_operands(18, (128, 64), (64, 4), 64, False)
    args = {"float": (aq.float(), bq, as_, bs, 64, torch.float32),
            "scales": (aq, bq, as_[:1], bs, 64, torch.float32),
            "out": (aq, bq, as_, bs, 64, torch.int32),
            "meta": (aq.to("meta"), bq.to("meta"), as_.to("meta"),
                     bs.to("meta"), 64, torch.float32)}[case]
    before = k_tsm2r.q8_launches
    with pytest.raises((TypeError, ValueError)):
        k_tsm2r.tsm2r_q8(*args)
    assert k_tsm2r.q8_launches == before


def test_build_knows_the_five_int8_kernels():
    q8 = ("tsm2r_q8", "tsm2l_q8", "tsmt_q8", "tsm2r_q8_split",
          "tsmt_q8_split")
    for name in q8:
        assert name in _build.KERNELS
        assert (_build.CSRC / f"{name}.cu").is_file()
        # tsmt_q8 also takes its plan of m slices and their workspace,
        # tsm2r_q8 whether its B is K-major (its wgmma body's layout).
        assert len(_build.SIGNATURES[name]) == {
            "tsmt_q8": 13, "tsm2r_q8": 11}.get(
                name, 12 if "split" in name else 10)
    assert _build.TAGS["tsmt_q8_split"] == ("f32",)
    assert _build.TAGS["tsm2r_q8"] == ("f32", "bf16")


# ---------------------------------------------------------------------------
# Whole ops under GemmPolicy(quant="int8")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,split", [
    (2048, 512, 8, "auto"), (1000, 777, 17, "never"), (3000, 1024, 8, 4)])
def test_tsmm_int8_tsm2r_near_f32_oracle(m, k, n, split, name):
    a, _ = _pair(m + k, (m, k), name)
    b, _ = _pair(m + k + 1, (k, n), name)
    with tsmm.policy(mode="tsm2r", quant="int8", split=split), \
            tsmm.record_dispatches() as log:
        got = tsmm.tsmm(a, b)
    assert got.dtype == a.dtype
    assert [lm.kind for lm in log[0].launches][0] == "tsm2r_q8"
    assert log[0].quant == "int8"
    assert _rel_err(got, a.float() @ b.float()) <= REL_TOL[name]


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_tsmm_int8_tsm2l_near_f32_oracle(name):
    a, _ = _pair(21, (5000, 16), name)
    b, _ = _pair(22, (16, 8), name)
    with tsmm.policy(quant="int8"), tsmm.record_dispatches() as log:
        got = tsmm.tsmm(a, b)
    assert got.dtype == a.dtype
    assert [lm.kind for lm in log[0].launches] == ["tsm2l_q8"]
    assert _rel_err(got, a.float() @ b.float()) <= REL_TOL[name]


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("m,a,b,split", [
    (4096, 64, 4, "auto"), (3000, 100, 16, 2), (2500, 8, 1, "never")])
def test_tsmm_t_int8_near_f32_oracle(m, a, b, split, name):
    x, _ = _pair(m + a, (m, a), name)
    y, _ = _pair(m + a + 1, (m, b), name)
    with tsmm.policy(quant="int8", split=split), \
            tsmm.record_dispatches() as log:
        got = tsmm.tsmm_t(x, y)
    assert got.dtype == x.dtype
    assert log[0].launches[0].kind == "tsmt_q8"
    assert _rel_err(got, x.float().T @ y.float()) <= REL_TOL[name]


def test_int8_split_partials_match_sequential():
    a, _ = _pair(23, (1024, 1024))
    b, _ = _pair(24, (1024, 8))
    x, _ = _pair(25, (4096, 32))
    y, _ = _pair(26, (4096, 4))
    base = tsmm.GemmPolicy(mode="tsm2r", quant="int8")
    outs = {}
    for split in ("never", 4):
        with tsmm.policy(dataclasses.replace(base, split=split)), \
                tsmm.record_dispatches() as log:
            outs[split] = (tsmm.tsmm(a, b), tsmm.tsmm_t(x, y))
        assert {lm.splits for e in log for lm in e.launches
                if lm.kind != "reduce"} == {1 if split == "never" else 4}
    for par, seq in zip(outs[4], outs["never"]):
        torch.testing.assert_close(par, seq, rtol=1e-5, atol=1e-5)


def test_int8_tsmt_slices_are_whole_bands():
    """Under int8 the tsmt slice quantum is the scale band, so a pinned S
    is clamped to the bands there are."""
    pol = tsmm.GemmPolicy(quant="int8", split=64)
    p = ops.resolve_params("tsmt", 1000, 16, 4, torch.float32, pol)
    assert p == {"splits": 4, "block_m": perf_model.Q8_BAND}
    p = ops.resolve_params("tsmt", 1000, 16, 4, torch.float32,
                           dataclasses.replace(pol, quant="none"))
    # 8-row blocks: S = 64 slices of 16 rows cover 1000 rows in 63.
    assert p == {"splits": 63, "block_m": perf_model.TSMT_BLOCK_M}


def test_int8_chooser_prices_one_byte_operands():
    """On the modelled H100 the int8 chooser runs PowerSGD's Q projection
    (32 output tiles) on the one-launch tsmt_q8, whose own plan spreads m
    over 8 slices, and keeps its P projection (508 row tiles) sequential,
    as the train-int8 path expects; int8 operands are priced below f32
    ones at the split kernel's S = 8 and at S = 1 alike."""
    assert perf_model.choose_splits_tsmt(65024, 4096, 4,
                                         dtype=torch.int8) == 1
    assert perf_model.tsmt_slices(65024, 4096, 4, dtype=torch.int8)[0] > 1
    assert perf_model.choose_splits_tsm2r(65024, 4096, 4,
                                          dtype=torch.int8) == 1
    for q in (1, 8):
        t8 = perf_model.tsmt_model_time(65024, 4096, 4, dtype=torch.int8,
                                        splits=q)
        t32 = perf_model.tsmt_model_time(65024, 4096, 4,
                                         dtype=torch.float32, splits=q)
        assert t8 < t32


def test_int8_grads_near_f32_autograd():
    a0, _ = _pair(27, (512, 256))
    b0, _ = _pair(28, (256, 8))
    grads = []
    for pol in (tsmm.GemmPolicy(quant="int8", **THRESH), None):
        a = a0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        if pol is None:
            loss = ((a @ b) ** 2).sum()
        else:
            with tsmm.policy(pol):
                loss = (tsmm.tsmm(a, b) ** 2).sum()
        loss.backward()
        grads.append((a.grad, b.grad))
    (ga, gb), (ga0, gb0) = grads
    assert _rel_err(ga, ga0) <= 0.1 and _rel_err(gb, gb0) <= 0.1


# ---------------------------------------------------------------------------
# The policy knob
# ---------------------------------------------------------------------------

def test_policy_quant_validated():
    with pytest.raises(ValueError, match="quant"):
        tsmm.GemmPolicy(quant="fp8")
    assert tsmm.GemmPolicy(quant="int8").quant == "int8"
    assert tsmm.GemmPolicy().quant == "none"


def test_backward_policy_keeps_quant():
    fwd = tsmm.GemmPolicy(quant="int8", split=4, mode="tsm2r")
    bwd = tsmm.backward_policy(fwd)
    assert bwd.quant == "int8" and bwd.split == "auto" and bwd.mode == "auto"
    assert bwd.quant == jtsmm.backward_policy(
        jtsmm.GemmPolicy(quant="int8", split=4)).quant


def test_dispatch_event_carries_quant():
    a, _ = _pair(29, (2048, 512))
    b, _ = _pair(30, (512, 8))
    with tsmm.policy(quant="int8"), tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b)
    assert log and all(e.quant == "int8" for e in log)
    with tsmm.record_dispatches() as log:
        tsmm.tsmm(a, b)
    assert [e.quant for e in log] == ["none"]


def test_dense_arm_ignores_quant():
    a, _ = _pair(31, (512, 128))
    b, _ = _pair(32, (128, 8))
    with tsmm.policy(mode="dense", quant="int8"), \
            tsmm.record_dispatches() as log:
        got = tsmm.tsmm(a, b)
    assert [(e.executor, e.launches) for e in log] == [("torch-dense", ())]
    torch.testing.assert_close(got, a @ b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Weight records on the chatglm3 smoke config
# ---------------------------------------------------------------------------

def _record_paths(tree, prefix=""):
    if jquant._is_qrec(tree):
        return [prefix]
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    return [p for k, v in items
            for p in _record_paths(v, f"{prefix}.{k}" if prefix else str(k))]


@pytest.fixture(scope="module")
def smoke_tree():
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    seg = tree["segments"][0]
    for key in ("bq", "bk", "bv"):
        seg["attn"][key] = rng.normal(0, 0.1, seg["attn"][key].shape
                                      ).astype(np.float32)
    for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
    return jcfg, registry.get_config("chatglm3-6b", smoke=True), tree


@pytest.mark.parametrize("min_size", [4096, 64])
def test_quantize_weights_picks_the_jax_leaves(smoke_tree, min_size):
    """The port decides on the JAX layout: the same leaves, and the same
    codes and scales, including the stacked (L, d) biases and norm scales
    at a low ``min_size``; the 3-D layer weights stay dense."""
    _, cfg, tree = smoke_tree
    jq = jax.tree.map(np.asarray, jquant.quantize_weights(
        jax.tree.map(jnp.asarray, tree), min_size=min_size))
    jpaths = sorted(_record_paths(jq))
    qw = quant.quantize_weights(params_from_jax(cfg, tree, device="cpu"),
                                min_size=min_size)
    assert sorted(qw.records) == jpaths
    if min_size == 64:
        assert "segments.0.attn.bq" in jpaths
    assert all(not p.startswith("segments.0.attn.w") for p in jpaths)
    for path, rec in qw.records.items():
        node = jq
        for key in path.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        for key in ("q8", "q8_scale"):
            np.testing.assert_array_equal(rec[key].numpy(), node[key])
    released = [p for p in qw.model.parameters() if p.numel() == 0]
    assert released and quant.has_quantized_weights(qw)
    assert qw.nbytes() == sum(
        node.numel() * node.element_size()
        for rec in qw.records.values() for node in rec.values())


def test_serving_from_records_matches_jax(smoke_tree):
    """Both packages serve from the same records (the JAX tree's, carried
    by ``params_from_jax``); each step dequantizes at its entry."""
    from repro.serve import engine as jengine

    jcfg, cfg, tree = smoke_tree
    jqtree = jquant.quantize_weights(jax.tree.map(jnp.asarray, tree),
                                     min_size=64)
    qw = params_from_jax(cfg, jax.tree.map(np.asarray, jqtree),
                         device="cpu")
    assert isinstance(qw, quant.QuantizedWeights)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jpre, _ = jengine.make_serve_fns(jcfg, jtsmm.GemmPolicy(**THRESH))
    pre, _ = engine.make_serve_fns(cfg, tsmm.GemmPolicy(**THRESH))
    jlogits, _ = jax.jit(jpre)(jqtree, {"tokens": jnp.asarray(prompts)},
                               jmodel.init_cache(jcfg, 2, 30))
    logits, _ = pre(qw, {"tokens": torch.from_numpy(prompts).long()},
                    model.init_cache(cfg, 2, 30, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    # The step freed the dense tensors again; generate runs from records.
    assert any(p.numel() == 0 for p in qw.model.parameters())
    jout = jengine.generate(jqtree, jcfg, jnp.asarray(prompts), 4,
                            policy=jtsmm.GemmPolicy(**THRESH))
    out = engine.generate(qw, cfg, torch.from_numpy(prompts).long(), 4,
                          policy=tsmm.GemmPolicy(**THRESH), device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_int8_prefill_from_records_near_dense_arm(smoke_tree):
    """The serve-int8 path in small: records, an int8 scope whose wk/wv
    projections go through tsm2r_q8, against a dense arm on the same
    records (normalised error <= 5e-2, chip_smoke.py's limit)."""
    _, cfg, tree = smoke_tree
    qw = quant.quantize_weights(params_from_jax(cfg, tree, device="cpu"))
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 24))).long()
    out = {}
    for mode in ("auto", "dense"):
        pre, _ = engine.make_serve_fns(
            cfg, tsmm.GemmPolicy(mode=mode, quant="int8", **THRESH))
        with tsmm.record_dispatches() as log:
            out[mode], _ = pre(qw, {"tokens": prompts},
                               model.init_cache(cfg, 4, 24, device="cpu"))
        kinds = [lm.kind for e in log for lm in e.launches]
        if mode == "auto":
            assert kinds.count("tsm2r_q8") == 2 * cfg.n_layers
        else:
            assert kinds == []
    err = float((out["auto"] - out["dense"]).abs().max()
                / out["dense"].abs().max())
    assert err <= 5e-2


@pytest.mark.parametrize("batch,seq", [(4, 24), (4, 64)])
def test_int8_prefill_distance_from_dense_is_the_jax_schemes(smoke_tree,
                                                             batch, seq):
    """The int8 prefill's distance from the dense arm belongs to the JAX
    int8 scheme: on the same records and prompts, the JAX package's int8
    prefill reads the port's distance from its own dense arm. With at most
    256 prompt rows both packages quantize the activations in one band
    (JAX pads its block_m band with zeros), so the int8 logits agree to
    f32 rounding (the JAX serving tests' 1e-4)."""
    from repro.serve import engine as jengine

    jcfg, cfg, tree = smoke_tree
    jqtree = jquant.quantize_weights(jax.tree.map(jnp.asarray, tree))
    qw = params_from_jax(cfg, jax.tree.map(np.asarray, jqtree),
                         device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    jout, out = {}, {}
    for mode in ("auto", "dense"):
        jpre, _ = jengine.make_serve_fns(
            jcfg, jtsmm.GemmPolicy(mode=mode, quant="int8", **THRESH))
        jout[mode], _ = jax.jit(jpre)(
            jqtree, {"tokens": jnp.asarray(prompts)},
            jmodel.init_cache(jcfg, batch, seq))
        pre, _ = engine.make_serve_fns(
            cfg, tsmm.GemmPolicy(mode=mode, quant="int8", **THRESH))
        out[mode], _ = pre(qw, {"tokens": torch.from_numpy(prompts).long()},
                           model.init_cache(cfg, batch, seq, device="cpu"))
    jlogits = {k: _t(v) for k, v in jout.items()}
    np.testing.assert_allclose(out["auto"].numpy(), jlogits["auto"].numpy(),
                               rtol=1e-4, atol=1e-4)
    jgap = _rel_err(jlogits["auto"], jlogits["dense"])
    gap = _rel_err(out["auto"], out["dense"])
    assert jgap > 1e-3   # the JAX int8 arm did quantize
    assert abs(gap - jgap) <= 1e-4


# ---------------------------------------------------------------------------
# PowerSGD compress="int8"
# ---------------------------------------------------------------------------

def test_powersgd_int8_near_f32_and_counts_bytes():
    g = torch.from_numpy(_np(33, (512, 256)))
    st = {"err": torch.zeros(512, 256),
          "q": torch.from_numpy(_np(34, (256, 4)))}
    cfg8 = powersgd.PowerSGDConfig(rank=4, min_size=0, compress="int8")
    cfg0 = powersgd.PowerSGDConfig(rank=4, min_size=0)
    a8, _ = powersgd.compress_one(cfg8, g, st)
    a0, _ = powersgd.compress_one(cfg0, g, st)
    assert _rel_err(a8, a0) <= 0.1
    jcfg8 = jpowersgd.PowerSGDConfig(rank=4, min_size=0, compress="int8")
    ja8, _ = jpowersgd.compress_one(
        jcfg8, jnp.asarray(g.numpy()),
        {"err": jnp.zeros((512, 256)), "q": jnp.asarray(st["q"].numpy())})
    np.testing.assert_allclose(a8.numpy(), np.asarray(ja8), rtol=1e-4,
                               atol=1e-4)

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(512, 256))

    state = powersgd.init(cfg8, One())
    state["w"]["q"] = st["q"]
    _, _, m8 = powersgd.compress_tree(cfg8, {"w": g}, state)
    _, _, m0 = powersgd.compress_tree(cfg0, {"w": g}, state)
    ratio = m8["powersgd_compression"] / m0["powersgd_compression"]
    assert 3.5 <= ratio <= 4.1


def test_powersgd_compress_validated_and_tsqr_constructs():
    with pytest.raises(ValueError, match="compress"):
        powersgd.PowerSGDConfig(compress="fp4")
    assert powersgd.PowerSGDConfig(compress="int8").compress == "int8"
    assert powersgd.PowerSGDConfig(orth="tsqr").orth == "tsqr"
    with pytest.raises(ValueError, match="orth"):
        powersgd.PowerSGDConfig(orth="householder")


def test_int8_train_step_matches_jax():
    """One train step of the chatglm3 smoke config under
    ``GemmPolicy(quant="int8")`` with ``compress="int8"`` PowerSGD, both
    packages from the JAX train state: loss and grad norm within 5e-2."""
    from repro.data import pipeline as jpipeline
    from repro.optim import adamw as jadamw
    from repro.train import train_step as jtrain
    from repro_torch.convert import state_from_jax
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import train_step

    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024, compress="int8")
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024, compress="int8")
    jopt, opt = jadamw.AdamWConfig(eps=1e-6), adamw.AdamWConfig(eps=1e-6)
    params0 = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jstate = jtrain.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt,
        extra=jpowersgd.init(jps, params0, jax.random.PRNGKey(17)))
    state = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                           device="cpu")
    data = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)
    jb = jpipeline.batch_for_step(jpipeline.DataConfig(**data), 0)
    b = pipeline.batch_for_step(pipeline.DataConfig(**data), 0)
    jstep = jtrain.make_train_step(
        jcfg, jopt, n_micro=2,
        grad_transform=lambda g, st: jpowersgd.compress_tree(jps, g, st))
    step = train_step.make_train_step(
        cfg, opt, n_micro=2,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    with jtsmm.policy(jtsmm.GemmPolicy(**THRESH, quant="int8")):
        _, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
    with tsmm.policy(tsmm.GemmPolicy(**THRESH, quant="int8")), \
            tsmm.record_dispatches() as log:
        _, m = step(state, {k: torch.from_numpy(v).long()
                            for k, v in b.items()})
    kinds = {lm.kind for e in log for lm in e.launches}
    assert {"tsm2r_q8", "tsmt_q8"} <= kinds
    assert not kinds & {"tsm2r", "tsm2l", "tsmt"}
    assert bool(m["step_ok"]) and bool(jm["step_ok"])
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= 5e-2 * abs(
            float(jm[key])), key
    np.testing.assert_allclose(float(m["powersgd_compression"]),
                               float(jm["powersgd_compression"]), rtol=1e-6)
