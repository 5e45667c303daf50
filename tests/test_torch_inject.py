"""The port's GEMM fault injection (``ft/inject.py``) against the JAX
package's, on the CPU: bit-flip mechanics (the same bits as JAX's
``flip_bit`` for float32 and bfloat16), fault validation, scope and site
semantics, tree poisoning, and a fault inside a checkpointed segment,
whose recompute must replay it as the reference's traced checkpoint does
(f32 values at the JAX dispatch tests' rtol=1e-3, atol=1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tsmm as jtsmm
from repro.ft import inject as jinject
from repro.models import layers as jlayers
from repro_torch.core import tsmm
from repro_torch.ft import inject
from repro_torch.models import layers


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]).numpy()


def _jbits(a):
    return np.asarray(a).view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


# bf16 is float32's top half: its bits 0, 13, 15 sit where float32's 16,
# 29 and 31 do.
@pytest.mark.parametrize("dtype,jdt,bits", [
    (torch.float32, jnp.float32, (0, 13, 29, 31)),
    (torch.bfloat16, jnp.bfloat16, (0, 13, 15))])
def test_flip_bit_roundtrip_equals_jax(dtype, jdt, bits):
    x32 = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    x = torch.from_numpy(x32).to(dtype)
    jx = jnp.asarray(x32).astype(jdt)
    assert np.array_equal(_bits(x), _jbits(jx))
    for bit in bits:
        y = inject.flip_bit(x, 3, 5, bit)
        assert np.array_equal(_bits(y), _jbits(jinject.flip_bit(jx, 3, 5, bit)))
        diff = _bits(y) != _bits(x)
        assert diff.sum() == 1 and diff[3, 5]
        assert torch.equal(_bits_t(inject.flip_bit(y, 3, 5, bit)), _bits_t(x))
    assert x.data_ptr() != y.data_ptr()


def _bits_t(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def test_flip_bit_top_bit_is_the_sign():
    x = torch.tensor([[1.5, -2.0]])
    assert inject.flip_bit(x, 0, 0, 31).tolist() == [[-1.5, -2.0]]
    assert inject.flip_bit(x.bfloat16(), 0, 1, 15).float().tolist() == \
        [[1.5, 2.0]]


def test_flip_bit_bf16_ndim_and_range():
    x = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    y = inject.flip_bit(x, 1, 2, 14)            # the 2-D view is (6, 4)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert int((y.float() != x.float()).sum()) == 1
    assert y.reshape(6, 4)[1, 2] != 1
    with pytest.raises(ValueError, match=r"\[inject-bit\]"):
        inject.flip_bit(x, 0, 0, 16)
    with pytest.raises(ValueError, match=r"\[inject-bit\]"):
        inject.flip_bit(torch.ones(2, 2), 0, 0, 32)


def test_flip_bit_passes_the_gradient_through():
    x = torch.randn(4, 3, requires_grad=True)
    y = inject.flip_bit(x * 2.0, 1, 1, 22)
    (g,) = torch.autograd.grad((y * 3.0).sum(), x)
    assert torch.equal(g, torch.full_like(x, 6.0))


def test_fault_validation():
    with pytest.raises(ValueError, match=r"\[inject-operand\]"):
        inject.GemmFault(site=0, operand="c")
    with pytest.raises(ValueError, match=r"\[inject-fault\]"):
        inject.GemmFault(site=-1)
    with pytest.raises(TypeError, match=r"\[inject-plan\]"):
        with inject.faults("not-a-fault"):
            pass


def test_scope_inactive_is_noop():
    assert not inject.active() and inject.current_scope() is None
    x, y = torch.ones((4096, 16)), torch.ones((4096, 16))
    a = tsmm.tsmm_t(x, y)
    with inject.faults() as scope:
        assert inject.active() and inject.current_scope() is scope
        b = tsmm.tsmm_t(x, y)
    assert torch.equal(a, b)
    assert scope.sites_seen == 1 and scope.applied == []
    assert not inject.active()


def test_site_counter_is_deterministic():
    x, y = torch.ones((4096, 16)), torch.ones((4096, 16))
    f = inject.GemmFault(site=1, operand="out", row=1, col=1, bit=29)
    outs = []
    for _ in range(2):
        with inject.faults(f) as scope:
            first = tsmm.tsmm_t(x, y)
            outs.append(tsmm.tsmm_t(x, y))
        assert scope.applied == [f] and scope.sites_seen == 2
        assert torch.equal(first, torch.full((16, 16), 4096.0))
    assert torch.equal(outs[0], outs[1])
    assert outs[0][1, 1] != 4096.0
    far = inject.GemmFault(site=99, operand="out")
    with inject.faults(far) as scope:
        tsmm.tsmm_t(x, y)
    assert scope.applied == [] and scope.sites_seen == 1


def test_every_executor_is_a_site():
    """Dense and kernel routes alike go through the tap, as in JAX."""
    a = torch.ones(64, 32)
    with inject.faults() as scope, tsmm.record_dispatches() as log:
        tsmm.tsmm(a, torch.ones(32, 8))                  # dense
        tsmm.tsmm(torch.ones(4096, 16), torch.ones(16, 8))   # tsm2l
    with jinject.faults() as jscope:
        jtsmm.tsmm(jnp.ones((64, 32)), jnp.ones((32, 8)))
        jtsmm.tsmm(jnp.ones((4096, 16)), jnp.ones((16, 8)), interpret=True)
    assert [e.kind for e in log] == ["dense", "tsm2l"]
    assert scope.sites_seen == jscope.sites_seen == 2


def test_replay_and_suspended():
    x, y = torch.ones((4096, 16)), torch.ones((4096, 16))
    f = inject.GemmFault(site=0, operand="out", row=0, col=0, bit=29)
    with inject.faults(f) as scope:
        tsmm.tsmm_t(x, y)
        with inject.replay(scope, 0):
            again = tsmm.tsmm_t(x, y)
        with inject.suspended():
            assert not inject.active()
            tsmm.tsmm_t(x, y)
    assert again[0, 0] != 4096.0
    assert scope.applied == [f] and scope.sites_seen == 1


def _tsm2r_fwd(t):
    return tsmm.tsmm(t, torch.linspace(-1, 1, 512 * 8).view(512, 8))


def _tsmt_fwd(t):
    return tsmm.tsmm_t(t, torch.linspace(-1, 1, 4096 * 4).view(4096, 4))


def _tsqr_fwd(t):
    from repro_torch.linalg import tsqr
    q, r = tsqr(t)
    return q.sum() + r.sum()


def _dense_pg_fwd(t):
    with tsmm.policy(param_dtype_grads=True):
        return layers.dense(torch.linspace(-1, 1, 512 * 8).view(512, 8), t)


@pytest.mark.parametrize("fwd,shape", [
    (_tsm2r_fwd, (4096, 512)),     # kernels/ops.py _MatMul
    (_tsmt_fwd, (4096, 16)),       # kernels/ops.py _MatMulT
    (_tsqr_fwd, (4096, 4)),        # linalg/tsqr.py _QR
    (_dense_pg_fwd, (4096, 512)),  # models/layers.py _DensePG
])
def test_backward_gemms_are_no_sites(fwd, shape):
    """Every autograd Function whose backward re-dispatches does so inside
    ``tsmm.backward_scope``: its GEMMs dispatch, but take no site and see
    no fault (the reference numbers them after the forward's; the port
    does not, as autograd's device thread sees no scope)."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, shape).astype(np.float32)).requires_grad_(True)
    plan = inject.GemmFault(site=99, operand="out")
    with inject.faults(plan) as scope, tsmm.record_dispatches() as log:
        out = fwd(x)
        forward = (len(log), scope.sites_seen)
        (g,) = torch.autograd.grad(out.square().sum(), (x,))
    assert forward[0] >= 1 and forward[1] == forward[0]
    assert len(log) > forward[0] and scope.sites_seen == forward[1]
    assert scope.applied == [] and torch.isfinite(g).all()


def test_backward_scope_is_backward_policy_without_sites():
    p = tsmm.GemmPolicy(mode="tsm2r", executor="torch-ref", split=4,
                        abft="verify")
    with inject.faults() as scope:
        with tsmm.backward_scope(p) as bp:
            assert bp == tsmm.backward_policy(p)
            assert not inject.active()
        assert inject.current_scope() is scope


def test_poison_tree_matches_jax():
    tree = {"b": torch.ones(4), "a": torch.ones(3, 3),
            "n": torch.tensor(2)}
    jtree = {"b": jnp.ones((4,)), "a": jnp.ones((3, 3)), "n": jnp.int32(2)}
    for ix in (0, 1, 2):
        out = inject.poison_tree(tree, leaf_index=ix)
        jout = jinject.poison_tree(jtree, leaf_index=ix)
        for k in ("a", "b"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k]),
                                  equal_nan=True)
        assert int(out["n"]) == 2
    assert not any(torch.isnan(t).any() for t in tree.values())
    with pytest.raises(ValueError, match=r"\[inject-poison\]"):
        inject.poison_tree({"n": torch.tensor(1)})


def test_poison_tree_on_a_module_is_in_place():
    mod = torch.nn.Linear(3, 2)
    assert inject.poison_tree(mod, value=7.0) is mod
    assert float(mod.bias[0]) == 7.0      # "bias" sorts before "weight"


def test_fault_in_checkpointed_segment_replays_as_jax():
    """A fault planned inside a checkpointed segment (abft="none") lands in
    the forward and again in the recompute, as the reference's traced
    checkpoint evaluates its faulted trace twice. The loss and the
    gradient of the weight downstream of the fault equal JAX's; upstream,
    the reference's bitcast carries no tangent while the port's flip
    passes the gradient straight through, so there the checkpointed
    gradients equal the port's plain (uncheckpointed) ones."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(0, 0.3, s).astype(np.float32)
            for s in ((64, 32), (32, 32), (32, 32), (32, 16))]
    fault = dict(site=1, operand="out", row=3, col=5, bit=22)

    def jloss(x, w0, w1, w2):
        def seg(h, w1_, w2_):            # a fresh function: no trace cache
            y = jlayers.dense(w1_, jnp.tanh(h))
            return jlayers.dense(w2_, jnp.tanh(y))
        z = jax.checkpoint(seg)(jlayers.dense(w0, x), w1, w2)
        return jnp.sum(z ** 2)

    with jinject.faults(jinject.GemmFault(**fault)) as jscope:
        jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, arrs))

    def seg(h, w1, w2):
        y = layers.dense(w1, torch.tanh(h))
        return layers.dense(w2, torch.tanh(y))

    def run(ck, plan=(inject.GemmFault(**fault),)):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        x, w0, w1, w2 = ts
        with inject.faults(*plan) as scope:
            h = layers.dense(w0, x)
            z = layers.remat(seg, h, w1, w2) if ck else seg(h, w1, w2)
            loss = (z ** 2).sum()
            grads = torch.autograd.grad(loss, ts)
        return loss, grads, scope

    loss, grads, scope = run(True)
    assert scope.applied == [inject.GemmFault(**fault)]
    assert scope.sites_seen == jscope.sites_seen == 3
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(jg[3]),
                               rtol=1e-3, atol=1e-4)
    assert all(not np.asarray(g).any() for g in jg[:3])
    plain_loss, plain_grads, _ = run(False)
    assert torch.equal(loss, plain_loss)
    for g, g0 in zip(grads, plain_grads):
        torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-7)
    # Without the replay the recompute would see the clean activation.
    clean_loss, clean_grads, _ = run(True, plan=())
    assert float(clean_loss) != float(loss)
    assert not torch.allclose(clean_grads[3], grads[3], rtol=1e-4, atol=0)
