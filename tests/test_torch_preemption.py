"""tpufw_torch.train.preemption, mirroring tests/test_preemption.py for one
process: SIGTERM latches the flag, handlers chain, sync_every amortizes
the stop decision, and Trainer.run leaves the loop with a forced
checkpoint. The two-process gang waits for the multi-GPU port (ROADMAP.md
Queue 1 item 12): with torch.distributed at a world size above 1,
should_stop raises."""

import os
import signal

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.train.preemption import GracefulShutdown as JGracefulShutdown
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import (
    CheckpointManager,
    Trainer,
    TrainerConfig,
    synthetic_batches,
)
from tpufw_torch.train.preemption import (
    GracefulShutdown,
    checkpoint_stop,
    owned_shutdown,
)


def test_sigterm_latches_flag():
    with GracefulShutdown() as sd:
        assert not sd.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert sd.requested
        assert sd.should_stop()
        assert sd.should_stop()  # latched


def test_previous_handler_chains():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with GracefulShutdown() as sd:
            os.kill(os.getpid(), signal.SIGTERM)
            assert sd.requested
            assert hits == [signal.SIGTERM]
        # uninstall restored the handler from before.
        os.kill(os.getpid(), signal.SIGTERM)
        assert hits == [signal.SIGTERM, signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


@pytest.mark.parametrize("cls", [GracefulShutdown, JGracefulShutdown])
def test_sync_every_cadence_matches_tpufw(cls):
    """The same call sequence gives the same decisions in both packages."""
    sd = cls(signals=(), sync_every=2)
    seen = [sd.should_stop()]
    sd.request()
    seen += [sd.should_stop(), sd.should_stop(), sd.should_stop()]
    assert seen == [False, False, True, True]


def test_bad_sync_every():
    with pytest.raises(ValueError):
        GracefulShutdown(signals=(), sync_every=0)


def test_owned_shutdown_and_checkpoint_stop(tmp_path):
    given = GracefulShutdown(signals=())
    assert owned_shutdown(given, True, 1) == (given, False)
    assert owned_shutdown(None, False, 1) == (None, False)
    made, owns = owned_shutdown(None, True, 1)
    try:
        assert owns and isinstance(made, GracefulShutdown)
    finally:
        made.uninstall()
    mgr = CheckpointManager(str(tmp_path))
    assert not checkpoint_stop(given, mgr, 4, {"w": torch.ones(2)})
    given.request()
    assert checkpoint_stop(given, mgr, 4, lambda: {"w": torch.ones(2)})
    mgr.wait()
    assert mgr.all_steps() == [4]


def test_gang_stop_is_an_all_reduce_every_sync(monkeypatch):
    """Under a process group every sync_every-th call all-reduces the
    flag (MAX of an int32); the others return the last decision."""
    import torch.distributed as dist

    from tests.torch_gang import free_port
    from tpufw_torch.cluster import init_process_group

    calls = []
    real = dist.all_reduce

    def counted(t, op=dist.ReduceOp.SUM, **kw):
        calls.append((t.dtype, op))
        return real(t, op=op, **kw)

    init_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        monkeypatch.setattr(dist, "all_reduce", counted)
        sd = GracefulShutdown(signals=(), sync_every=2)
        assert not sd.should_stop()
        sd.request()
        assert not sd.should_stop()  # not a sync call
        assert sd.should_stop() and sd.should_stop()
    finally:
        dist.destroy_process_group()
    assert calls == [(torch.int32, dist.ReduceOp.MAX)] * 2


def test_trainer_stops_and_checkpoints_on_preemption(tmp_path):
    """Trainer.run leaves the loop at the step the request is seen and
    force-saves it, past the periodic schedule (checkpoint_every is far
    beyond total_steps)."""
    tiny = LLAMA_CONFIGS["llama3_tiny"]
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = Trainer(tiny, TrainerConfig(
        batch_size=8, seq_len=17, total_steps=32, lr=1e-3, log_every=1,
        checkpoint_dir=ckpt_dir, checkpoint_every=1000), device="cpu")
    sd = GracefulShutdown(signals=())

    def hook(metrics):
        if metrics.step >= 3:
            sd.request()

    history = trainer.run(synthetic_batches(8, 17, tiny.vocab_size), 1.0,
                          on_metrics=hook, shutdown=sd)
    assert trainer.preempted
    assert trainer.step == 3 and len(history) == 3
    assert CheckpointManager(ckpt_dir).all_steps() == [3]


def test_sigterm_through_the_default_handler(tmp_path):
    """handle_preemption (on by default) installs the handler for the run
    and removes it after."""
    tiny = LLAMA_CONFIGS["llama3_tiny"]
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(tiny, TrainerConfig(
        batch_size=8, seq_len=17, total_steps=20, log_every=1,
        checkpoint_dir=str(tmp_path)), device="cpu")

    def hook(metrics):
        if metrics.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.run(synthetic_batches(8, 17, tiny.vocab_size), 1.0,
                on_metrics=hook)
    assert trainer.preempted and trainer.step == 2
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before
