"""repro_torch.linalg: CholeskyQR2 against the JAX package's tsqr, on the
CPU.

Mirrors ``tests/test_linalg.py``: orthogonality (``max|Q^T Q - I|``) and
reconstruction across condition numbers 1e0-1e7 at f32 (<= 1e-4 through
cond 1e6, 1e-3 at 1e7), Q and R against the JAX ``tsqr`` (Pallas in
interpret mode) at rtol 1e-4 x cond for cond 1e0 and 1e2, bf16 input,
both stages on the kernel kinds (the plain versions here), policy scoping,
the gradient against ``jax.vjp`` of the JAX ``tsqr`` (rtol 1e-3, atol
1e-4), the shift fallback on a rank-deficient input, validation, and one
PowerSGD ``orth="tsqr"`` train step against the JAX package's from its
train state (``state_from_jax``). Inputs are made with numpy from a seed
and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import linalg as jlinalg
from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.train import train_step as jtrain
from repro_torch import linalg
from repro_torch.analysis import contracts
from repro_torch.configs import registry
from repro_torch.convert import state_from_jax
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.optim import adamw, powersgd
from repro_torch.train import train_step

M, R = 4096, 16


def _conditioned(m, r, cond, key=0):
    """A = U diag(logspace) V^T with exactly the requested 2-norm cond,
    as float32 numpy."""
    rng = np.random.default_rng(key)
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((r, r)))
    s = np.logspace(0, -np.log10(cond), r)
    return ((u * s) @ v.T).astype(np.float32)


def _orth_err(q):
    q = q.detach().float().numpy()
    return float(np.max(np.abs(q.T @ q - np.eye(q.shape[1]))))


def _rec_err(q, r, a):
    a = a.float()
    return float(torch.linalg.norm(q.float() @ r - a) / torch.linalg.norm(a))


@pytest.mark.parametrize("cond", [1e0, 1e2, 1e4, 1e6, 1e7])
def test_orthogonality_and_reconstruction_f32(cond):
    a = torch.from_numpy(_conditioned(M, R, cond))
    q, r = linalg.qr(a)
    assert q.dtype == r.dtype == torch.float32
    assert _orth_err(q) <= (1e-4 if cond <= 1e6 else 1e-3)
    assert _rec_err(q, r, a) <= 1e-5
    # R upper-triangular with a non-negative diagonal
    assert float(torch.tril(r, -1).abs().max()) == 0.0
    assert float(torch.diagonal(r).min()) >= 0.0


def test_default_passes_rule():
    """Three passes where one shifted pass is recovered by the next (the
    JAX package's default), four past ``RECOVERY_SHIFT_REL``, where the
    shift grows with sqrt(m r)."""
    assert linalg.DEFAULT_PASSES == jlinalg.DEFAULT_PASSES == 3
    for m, r, want in [(8192, 16, 3), (65024, 4, 3), (65536, 16, 4),
                       (1 << 20, 16, 4), (2048, 8, 3)]:
        assert linalg.default_passes(m, r) == want, (m, r)
    assert linalg.default_passes(1 << 20, 16, shift_rel=1e-4) == 3
    a = torch.zeros(65536, 16)
    a[:16] = torch.eye(16)
    with tsmm.record_dispatches() as log:
        linalg.tsqr(a)
    assert sum(e.kind == "tsm2l" for e in log) == 4
    with tsmm.record_dispatches() as log:
        linalg.tsqr(a, passes=2)
    assert sum(e.kind == "tsm2l" for e in log) == 2


@pytest.mark.parametrize("seed", range(12))
def test_orthogonality_past_the_recovery_shift(seed):
    """[262144,16] at cond 1e6 (shift 2.4e-3): the default four passes hold
    the 1e-4 bar on every seed. Three left half of these inputs at 1e-4 to
    1e-3, where the second pass's plain Cholesky failed on its last pivot
    and shifted again; the JAX package's three passes miss the bar on such
    inputs too."""
    a = torch.from_numpy(_conditioned(262144, 16, 1e6, key=100 + seed))
    q, r = linalg.qr(a)
    assert _orth_err(q) <= 1e-4
    assert _rec_err(q, r, a) <= 1e-5


def _recovery_inputs():
    return [_conditioned(262144, 16, 1e6, key=100 + seed)
            for seed in range(12)]


def three_pass_misses():
    """|Q^T Q - I| after three passes, the JAX package's default, on the
    recovery test's 12 inputs: (port, JAX tsqr)."""
    port, ref = [], []
    for a in _recovery_inputs():
        port.append(_orth_err(linalg.qr(torch.from_numpy(a), passes=3)[0]))
        q = np.asarray(jlinalg.qr(jnp.asarray(a))[0])
        ref.append(_orth_err(torch.from_numpy(q)))
    return port, ref


def test_three_passes_miss_past_the_recovery_shift():
    """Why ``default_passes`` adds a pass past ``RECOVERY_SHIFT_REL``: on
    the recovery test's inputs three passes leave |Q^T Q - I| above 1e-4
    on some, in the port and in the JAX tsqr alike."""
    port, ref = three_pass_misses()
    assert sum(x > 1e-4 for x in port) >= 1, port
    assert sum(x > 1e-4 for x in ref) >= 1, ref


@pytest.mark.parametrize("cond", [1e0, 1e2])
def test_matches_jax_tsqr(cond):
    a = _conditioned(M, R, cond, key=1)
    q, r = linalg.tsqr(torch.from_numpy(a))
    jq, jr = jlinalg.tsqr(jnp.asarray(a))
    # both sign conventions fixed: the factorization is unique
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-4 * cond,
                               atol=1e-4 * cond)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4 * cond,
                               atol=1e-5)


def test_bf16_input():
    a = _conditioned(M, R, 1e2, key=2)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    q, r = linalg.qr(ab)
    assert q.dtype == torch.bfloat16 and r.dtype == torch.float32
    # orthogonality is bounded by the bf16 rounding of Q itself
    assert _orth_err(q) <= 0.05
    assert _rec_err(q, r, ab) <= 0.05
    jq, jr = jlinalg.qr(jnp.asarray(a, jnp.bfloat16))
    np.testing.assert_allclose(q.float().numpy(),
                               np.asarray(jq, np.float32), atol=2e-2)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-2,
                               atol=1e-3)


def test_both_stages_dispatch_on_kernels():
    a = torch.from_numpy(_conditioned(M, R, 1e2, key=3))
    with tsmm.record_dispatches() as log:
        linalg.qr(a)
    assert {e.executor for e in log} == {"torch-ref"}, log
    assert linalg.default_passes(M, R) == linalg.DEFAULT_PASSES
    assert [e.kind for e in log] == ["tsmt", "tsm2l"] * linalg.DEFAULT_PASSES
    # each pass resolves exactly the contract's two stage shapes, both as
    # single kernel launches
    stages = contracts.qr_stage_shapes(M, R)
    assert [(e.kind, e.shape) for e in log[:2]] == list(stages)
    assert all([lm.kind for lm in e.launches] == [e.kind] for e in log)


def test_policy_scope_threads_through_both_stages():
    a = torch.from_numpy(_conditioned(M, R, 1e2, key=3))
    with tsmm.policy(mode="dense"):
        with tsmm.record_dispatches() as log:
            q_dense, r_dense = linalg.qr(a)
    assert {e.executor for e in log} == {"torch-dense"}, log
    q, r = linalg.qr(a)
    np.testing.assert_allclose(q.numpy(), q_dense.numpy(), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), r_dense.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_explicit_policy_wins_over_scope():
    a = torch.from_numpy(_conditioned(M, R, 1e2, key=3))
    with tsmm.policy(mode="dense"):
        with tsmm.record_dispatches() as log:
            linalg.qr(a, policy=tsmm.GemmPolicy())
    assert {e.executor for e in log} == {"torch-ref"}, log


def _weights(m, r):
    w_q = np.cos(np.arange(m * r, dtype=np.float32).reshape(m, r))
    w_r = np.sin(np.arange(r * r, dtype=np.float32).reshape(r, r))
    return w_q, w_r


def test_grad_matches_jax_vjp():
    a = _conditioned(2048, 8, 1e1, key=4)
    w_q, w_r = _weights(2048, 8)
    _, vjp = jax.vjp(jlinalg.qr, jnp.asarray(a))
    (g_ref,) = vjp((jnp.asarray(w_q), jnp.asarray(w_r)))
    at = torch.from_numpy(a).requires_grad_(True)
    q, r = linalg.qr(at)
    (torch.sum(q * torch.from_numpy(w_q))
     + torch.sum(r * torch.from_numpy(w_r))).backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-3, atol=1e-4)


def test_grad_dispatches_tall_skinny():
    a = torch.from_numpy(_conditioned(M, R, 1e2, key=5)).requires_grad_(True)
    with tsmm.record_dispatches() as log:
        linalg.qr(a)[0].sum().backward()
    # the forward's tsmt + tsm2l a pass, and the cotangent GEMMs (dQ^T Q on
    # tsmt, the two R^-T applies on tsm2l), all on the kernel kinds
    assert {e.executor for e in log} == {"torch-ref"}, log
    bwd = log[2 * linalg.DEFAULT_PASSES:]
    assert sorted(e.kind for e in bwd) == ["tsm2l", "tsm2l", "tsmt"], log
    assert torch.isfinite(a.grad).all()


def test_rank_deficient_shift_fallback():
    a = _conditioned(4096, 8, 1e2, key=6)
    a[:, 3] = a[:, 2]      # an exactly dependent column
    at = torch.from_numpy(a)
    q, r = linalg.qr(at)
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(r).all())
    # the shifted factor still reconstructs (Q R = A holds through shifts)
    assert _rec_err(q, r, at) <= 1e-4
    # Past the dependent column the factors are not unique; the columns
    # before it are, and agree with the JAX package's.
    jq, jr = jlinalg.qr(jnp.asarray(a))
    assert bool(jnp.all(jnp.isfinite(jq)))
    np.testing.assert_allclose(q[:, :3].numpy(), np.asarray(jq)[:, :3],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r[:3, :3].numpy(), np.asarray(jr)[:3, :3],
                               rtol=1e-4, atol=1e-5)


def test_ops_reexport():
    a = torch.from_numpy(_conditioned(M, R, 1e2, key=7))
    q, r = linalg.tsqr(a)
    q2, r2 = ops.tsqr(a)
    assert torch.equal(q, q2) and torch.equal(r, r2)


def test_validation():
    with pytest.raises(ValueError, match="2-D"):
        linalg.qr(torch.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match="tall-skinny"):
        linalg.qr(torch.zeros((8, 16)))
    with pytest.raises(ValueError, match="passes"):
        linalg.qr(torch.zeros((64, 4)), passes=0)


@pytest.mark.parametrize("m,r", [(8, 1), (300, 7), (1000, 40), (2999, 13)])
def test_odd_shapes(m, r):
    rng = np.random.default_rng(m * 41 + r)
    a = torch.from_numpy(rng.standard_normal((m, r)).astype(np.float32))
    q, rr = linalg.qr(a)
    assert q.shape == (m, r) and rr.shape == (r, r)
    assert _orth_err(q) <= 1e-3
    assert _rec_err(q, rr, a) <= 1e-3


def test_powersgd_tsqr_step_matches_jax():
    """One train step of the chatglm3 smoke config with PowerSGD's
    ``orth="tsqr"``, both packages from the JAX train state, under a
    policy whose lowered thresholds route PowerSGD's P factors (64 x 4 at
    the smoke width) through tsmt and tsm2l: metrics, the updated
    parameters and the PowerSGD state agree at rtol = atol = 1e-4."""
    thresh = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024, orth="tsqr")
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024, orth="tsqr")
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
    with jtsmm.policy(jtsmm.GemmPolicy(**thresh)):
        jstate, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v)
                                             for k, v in jb.items()})
    with tsmm.policy(tsmm.GemmPolicy(**thresh)), \
            tsmm.record_dispatches() as log:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
    # P of each of the two compressed leaves, factored in 3 passes
    p_rows = {e.shape[0] for e in log if e.kind == "tsm2l"}
    assert sum(e.kind == "tsm2l" for e in log) == 2 * linalg.DEFAULT_PASSES
    assert len(p_rows) == 1
    assert bool(m["step_ok"]) and bool(jm["step_ok"])
    for key in ("loss", "grad_norm", "powersgd_compression"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-4)
    want = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                          device="cpu")
    for path, st in want["extra"].items():
        for f, t in st.items():
            np.testing.assert_allclose(state["extra"][path][f].numpy(),
                                       t.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{path}.{f}")
    for (n, p), (_, wp) in zip(state["params"].named_parameters(),
                               want["params"].named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), wp.detach().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=n)
