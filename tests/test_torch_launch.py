"""The port's fault-tolerant launcher (``repro_torch.launch.train``) on the
CPU, at the chatglm3 smoke size with the reference rollback test's batch.

Against itself, as ``tests/test_train_rollback.py`` holds the JAX
launcher: a NaN injected before step 3 rolls back to the step-2 snapshot
and the run ends on the clean run's final loss bit for bit; with
snapshots off the fault escalates to the newest committed checkpoint
(written synchronously there, so the test does not race the writer);
with neither it raises ``[ft-retries]``; the online ABFT guard leaves the
loss as it was; a SIGTERM checkpoints and exits 42, and a re-run resumes
to the clean run's final loss bit for bit.

Against the JAX launcher: both run the same argv from the same state (the
port's ``init_train_state`` returns the JAX one carried over by
``convert.state_from_jax``) and agree on the final loss within rtol 1e-4
(``tests/test_torch_train.py``'s tolerance), on the fault counters and on
every ``[chaos]`` / ``[ft]`` line. PowerSGD stays off there: the two
packages draw a degenerate column's fresh direction differently.
"""

import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import train
from repro_torch.train import train_step

_BASE = ["--arch", "chatglm3-6b", "--smoke", "--global-batch", "4",
         "--seq-len", "32", "--log-every", "100"]


def _run(*extra, steps=6):
    return train.main(_BASE + ["--device", "cpu", "--steps", str(steps)]
                      + list(extra))


@pytest.fixture(scope="module")
def clean_metrics():
    return _run()


def test_clean_run_has_no_retries(clean_metrics):
    assert clean_metrics["fault_retries"] == 0
    assert clean_metrics["fault_events"] == 0
    assert clean_metrics["final_step"] == 5
    assert np.isfinite(clean_metrics["final_loss"])


def test_chaos_rollback_reconverges(clean_metrics, capsys):
    chaos = _run("--chaos-step", "3")
    out = capsys.readouterr().out
    assert "[chaos] poisoned state before step 3" in out
    assert "[ft] step 3 fault: rolled back to snapshot at step 2" in out
    assert chaos["fault_events"] == 1
    assert chaos["fault_retries"] == 1
    assert chaos["final_loss"] == clean_metrics["final_loss"]


@pytest.mark.parametrize("abft_every", [0, 2])
def test_chaos_escalates_to_checkpoint(tmp_path, clean_metrics, capsys,
                                       monkeypatch, abft_every):
    """Snapshots off: the fault at step 4 restores the newest committed
    checkpoint, step 2, and still reaches the clean final loss.
    ``--abft-every 2`` runs the offline checksum check before the saves
    at steps 0, 2 and 4. The saves are written before ``save`` returns
    here: escalation sees only committed checkpoints, and an async write
    racing two fast smoke steps would make the test depend on load."""
    real_save = Checkpointer.save
    monkeypatch.setattr(Checkpointer, "save", lambda self, step, tree:
                        real_save(self, step, tree, block=True))
    chaos = _run("--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                 "--snapshot-every", "0", "--chaos-step", "4",
                 "--abft-every", str(abft_every))
    assert "[ft] step 4 fault: retries exhausted, restored checkpoint " \
        "step 2" in capsys.readouterr().out
    assert chaos["fault_retries"] == 1 and chaos["fault_events"] == 1
    assert chaos["final_loss"] == clean_metrics["final_loss"]


def test_fault_with_no_recovery_path_raises():
    with pytest.raises(RuntimeError, match=r"\[ft-retries\]"):
        _run("--snapshot-every", "0", "--chaos-step", "3")


def test_online_abft_scope_trains():
    """``--abft verify`` wraps every training GEMM in the checksum guard;
    a clean run's final loss is the unguarded one's."""
    guarded = _run("--abft", "verify", steps=3)
    plain = _run(steps=3)
    assert guarded["final_loss"] == plain["final_loss"]
    assert guarded["fault_events"] == 0


def test_sigterm_checkpoints_and_resumes(tmp_path, clean_metrics,
                                         monkeypatch, capsys):
    """A SIGTERM during step 2 lets the step finish, checkpoints it and
    exits 42; the re-run restores step 2 and finishes on the clean run's
    final loss bit for bit."""
    real = train_step.make_train_step

    def make(*a, **kw):
        step, calls = real(*a, **kw), []

        def signalled(state, batch):
            calls.append(1)
            if len(calls) == 3:
                signal.raise_signal(signal.SIGTERM)
            return step(state, batch)
        return signalled

    args = ("--ckpt-dir", str(tmp_path), "--ckpt-every", "100")
    seen = []

    def ours(signum, frame):
        seen.append(signum)

    prev = signal.signal(signal.SIGTERM, ours)
    try:
        with monkeypatch.context() as m:
            m.setattr(train_step, "make_train_step", make)
            with pytest.raises(SystemExit) as exc:
                _run(*args)
        assert exc.value.code == 42 and seen == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is ours     # chained back
        assert "preemption requested" in capsys.readouterr().out
        resumed = _run(*args)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert "[train] restored checkpoint at step 2" in capsys.readouterr().out
    assert resumed["final_loss"] == clean_metrics["final_loss"]
    assert resumed["fault_retries"] == 0


def test_main_without_device_refuses_to_run_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_BASE + ["--steps", "1"])


def _lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(("[ft]",
                                                            "[chaos]"))]


def test_launcher_matches_jax_from_the_same_state(monkeypatch, capsys):
    argv = _BASE + ["--steps", "6", "--chaos-step", "3"]
    want = jtrain.main(argv)
    want_lines = _lines(capsys.readouterr().out)

    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)

    def from_jax(seed, cfg, opt_cfg, extra=None, *, device=None):
        assert seed == 0 and extra is None
        jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg,
                                      jadamw.AdamWConfig())
        return convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                      device=device)

    monkeypatch.setattr(train_step, "init_train_state", from_jax)
    got = train.main(argv + ["--device", "cpu"])
    got_lines = _lines(capsys.readouterr().out)
    assert got_lines == want_lines and len(got_lines) == 2
    assert (got["fault_retries"], got["fault_events"]) == \
        (want["fault_retries"], want["fault_events"]) == (1, 1)
    assert got["final_step"] == want["final_step"]
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
