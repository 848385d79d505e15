"""One rank of a 2-rank CPU gang (gloo) for the telemetry tests. Imports
no JAX.

    python tests/torch_telemetry_gang.py <out_dir>

The rank trains llama3_tiny (fp32) for 3 steps through ``Trainer.run``
with ``telemetry_dir=<out_dir>/train`` (every rank writes its own
``-p<N>`` files into the shared dir), then feeds the skew monitor of a
telemetry under ``<out_dir>/skew`` three measured windows in which rank 1
sleeps 0.3 s longer, and writes ``<out_dir>/skew.out<rank>.json``: the
ranks each ``record`` flagged.
"""

import dataclasses
import json
import os
import sys
import time


def main(out: str) -> int:
    import torch
    import torch.distributed as dist

    from tpufw_torch.cluster import initialize_cluster
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.obs import Telemetry
    from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches

    torch.set_num_threads(1)
    cluster = initialize_cluster(device="cpu")
    rank = cluster.rank
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                              dtype=torch.float32)
    tr = Trainer(cfg, TrainerConfig(
        batch_size=4, seq_len=17, total_steps=3, log_every=1,
        telemetry_dir=os.path.join(out, "train")), device="cpu")
    tr.init_state()
    tr.run(synthetic_batches(2, 17, cfg.vocab_size, seed=2 * rank),
           model_flops_per_token=cfg.flops_per_token(16))
    # A factor under 2: with two ranks the median is their mean, which a
    # factor of 2 puts above the slower one whatever the gap.
    tel = Telemetry.create(telemetry_dir=os.path.join(out, "skew"),
                           straggler_factor=1.2)
    flagged = []
    for step in (1, 2, 3):
        t0 = time.perf_counter()
        time.sleep(0.05 + 0.3 * rank)
        flagged.append(tel.skew.record(step, time.perf_counter() - t0, 0.0))
    tel.close()
    with open(os.path.join(out, f"skew.out{rank}.json"), "w") as f:
        json.dump(flagged, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
