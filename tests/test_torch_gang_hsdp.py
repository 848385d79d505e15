"""A 4-rank gloo gang on the CPU through ``scripts/gang_check_torch.py
--cpu``: every rank on ``fsdp`` (4), then a true 2-D mesh, ``data=2`` by
``fsdp=2`` (HSDP: sharded over one dimension, replicated over the other),
that mesh again with ``grad_accum=2``, ``fsdp=2`` by ``sequence=2`` on
ring attention (each rank half of every row), and the pipelines, ``pipe=2``
by ``data=2`` GPipe and ``pipe=4`` 1F1B (a stage a rank), each held (losses
and grad norms) to one process at its ``grad_accum`` (a pipeline: on a
``LocalPipeGroup`` holding every stage) on the same global batches within
1e-5 (llama3_tiny, fp32), and the gang's stop (only the last rank asks)
resumed in one process. The script's processes import no JAX."""

import json
import os
import subprocess
import sys

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_gang import ROOT


def test_four_rank_gang_matches_one_process():
    script = os.path.join(ROOT, "scripts", "gang_check_torch.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    out = subprocess.run(
        [sys.executable, script, "--cpu", "--world", "4", "--model",
         "llama3_tiny", "--batch", "8", "--seq", "33", "--tol", "1e-5",
         "--timeout", "100"],
        capture_output=True, text=True, timeout=150,
        env=env | {"OMP_NUM_THREADS": "1"})
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert out.returncode == 0, out.stdout + out.stderr
    checks = {ln["check"]: ln for ln in lines if "check" in ln}
    assert set(checks) == {"gang_fsdp4_vs_one_process",
                           "gang_data2_fsdp2_vs_one_process",
                           "gang_data2_fsdp2_accum2_vs_one_process",
                           "gang_fsdp2_sequence2_ring_vs_one_process",
                           "gang_pipe2_data2_gpipe_vs_one_process",
                           "gang_pipe4_1f1b_vs_one_process",
                           "gang_stop_and_one_process_resume"}
    assert all(c["ok"] for c in checks.values())
    for name in ("data2_fsdp2", "data2_fsdp2_accum2"):
        assert checks[f"gang_{name}_vs_one_process"]["mesh"] == {
            "data": 2, "fsdp": 2, "sequence": 1}
    assert checks["gang_data2_fsdp2_accum2_vs_one_process"]["grad_accum"] == 2
    assert checks["gang_fsdp2_sequence2_ring_vs_one_process"]["mesh"] == {
        "data": 1, "fsdp": 2, "sequence": 2}
    assert checks["gang_pipe2_data2_gpipe_vs_one_process"]["mesh"] == {
        "data": 2, "pipe": 2, "fsdp": 1, "sequence": 1}
    assert checks["gang_pipe4_1f1b_vs_one_process"]["mesh"] == {
        "data": 1, "pipe": 4, "fsdp": 1, "sequence": 1}
    assert checks["gang_fsdp4_vs_one_process"]["ranks_equal"]
    assert lines[-1]["ok"] and lines[-1]["world"] == 4
