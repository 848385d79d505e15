"""The gang's stop on the CPU (gloo, 2 processes that import no JAX), as
``tests/test_preemption.py``'s two-process test for ``tpufw``: only rank
1 is signalled (SIGTERM after step 2); the gang's ``any(flag)`` stops both
ranks at step 2 with one forced checkpoint, and that checkpoint (whole
tensors) resumes into a one-process run whose next step equals the
unbroken gang's (rtol 1e-5). Ranks that see different checkpoint
directories raise, every one of them, on the resume and on a save."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_gang import (
    finish,
    read_outputs,
    start_gang,
    WORKER,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.models import LLAMA_CONFIGS, model_for_config
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.checkpoint import CheckpointManager

TCFG = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)


KW = dict(batch_size=8, seq_len=17, total_steps=64, lr=1e-3,
          warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32",
          log_every=1)
FSDP2 = {"data": 1, "fsdp": 2}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One gang for every case: the unbroken run, the stopped one, and
    the ranks on checkpoint directories that disagree (rank 0's holds
    step 1, rank 1's step 2)."""
    tmp = tmp_path_factory.mktemp("gang_stop")
    state = model_for_config(TCFG, device="cpu", seed=0).state_dict()
    it = synthetic_batches(8, 17, TCFG.vocab_size, seed=1)
    batches = [next(it) for _ in range(3)]
    ckpt = str(tmp / "ckpt")
    unbroken = write_case(tmp / "unbroken.pt", "unbroken", TCFG,
                          dict(KW, handle_preemption=False), FSDP2, state,
                          batches)
    # Periodic saves off: only the forced one.
    stopped = write_case(tmp / "stopped.pt", "stopped", TCFG,
                         dict(KW, checkpoint_dir=ckpt, checkpoint_every=1000),
                         FSDP2, state, batches, signal_rank=1, signal_at=2)
    dirs = [str(tmp / f"rank{r}") for r in range(2)]
    for r, d in enumerate(dirs):
        mgr = CheckpointManager(d)
        mgr.save(r + 1, {"x": torch.ones(2)}, force=True)
        mgr.close()
    disagree = write_case(tmp / "disagree.pt", "disagree", TCFG,
                          dict(KW, handle_preemption=False), FSDP2, {}, [],
                          kind="disagree", dirs=dirs, save_step=1)
    finish(start_gang([WORKER, unbroken, stopped, disagree]))
    return {"batches": batches, "ckpt": ckpt,
            **{name: read_outputs(p) for name, p in (
                ("unbroken", unbroken), ("stopped", stopped),
                ("disagree", disagree))}}


def test_only_rank1_signalled_both_stop_and_resume(gang):
    kw, batches, ckpt = KW, gang["batches"], gang["ckpt"]
    full, cut = gang["unbroken"], gang["stopped"]
    assert [o["preempted"] for o in cut] == [True, True]
    assert [o["step"] for o in cut] == [2, 2]
    assert cut[0]["losses"] == cut[1]["losses"] == full[0]["losses"][:2]
    assert CheckpointManager(ckpt).all_steps() == [2]
    # The gang's checkpoint (whole tensors) resumes in one process.
    one = Trainer(TCFG, TrainerConfig(**kw, checkpoint_dir=ckpt,
                                      handle_preemption=False), device="cpu")
    assert one.maybe_restore() and one.step == 2
    losses = []
    step = one.train_step
    one.train_step = lambda b: losses.append(step(b)) or losses[-1]
    one.run(iter(batches[2:]), model_flops_per_token=1.0)
    np.testing.assert_allclose([float(m["loss"]) for m in losses],
                               full[0]["losses"][2:], rtol=1e-5)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), full[0]["params"][k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_ranks_on_different_checkpoint_dirs_raise(gang):
    """Rank 0 sees step 1 as the latest, rank 1 step 2: the resume, and
    then a save of step 1 (on rank 0's disk, not on rank 1's), raise on
    both ranks instead of leaving them in different states or in a
    collective only one enters."""
    for out in gang["disagree"]:
        assert out["restore"] == (
            "the gang's ranks disagree on the latest checkpoint step: from "
            "1 to 2 (does every rank see the same checkpoint directory?)")
        assert out["save"].startswith(
            "the gang's ranks disagree on whether step 1 is on disk: from 0 "
            "to 1")
