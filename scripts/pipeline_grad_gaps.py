"""Per-leaf gradient gaps between the GPipe and 1F1B schedules on one GPU.

    python3 scripts/pipeline_grad_gaps.py

Builds the CUDA kernels, draws ``llama3_600m_bench`` from seed 0 in the
pipeline layout (2 stages, 4 microbatches) and one synthetic batch of
4 x 2048 tokens (seed 16, ``chip_smoke.py`` phase 16's), and takes one
step's loss and gradients through both schedules (``LocalPipeGroup``, no
update), once with the chunked CE (512-token chunks, bf16 head products)
and once with full fp32 logits. Prints one JSON line per CE: both losses,
both global gradient norms and their relative gap, and per leaf (GPipe's
norm, 1F1B's norm, the norm of their difference over GPipe's); then the
card's name and power limit.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.ops import _build
    from tpufw_torch.parallel import pipeline as tp
    from tpufw_torch.train import synthetic_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = resolve_model_preset("llama3_600m_bench")
    params = tp.init_pipeline_params(cfg, tp.PipelineConfig(2, 4), seed=0,
                                     device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        synthetic_batches(4, 2048, cfg.vocab_size, seed=16)).items()}
    for chunk in (512, None):
        got = {}
        for schedule in ("gpipe", "1f1b"):
            loss, grads = tp.value_and_grad(
                params, batch, cfg, tp.PipelineConfig(2, 4, schedule),
                loss_chunk_size=chunk)
            got[schedule] = (float(loss), {p: g.float() for p, g in
                                           tp.tree_leaves(grads)})
        leaves = {}
        for path, a in got["gpipe"][1].items():
            b = got["1f1b"][1][path]
            leaves[path] = [float(a.norm()), float(b.norm()),
                            float((a - b).norm() / a.norm().clamp_min(1e-30))]
        norms = [sum(r[i] ** 2 for r in leaves.values()) ** 0.5
                 for i in range(2)]
        print(json.dumps({"loss_chunk_size": chunk,
                          "loss": [got["gpipe"][0], got["1f1b"][0]],
                          "grad_norm": norms,
                          "rel_grad_norm_gap": abs(norms[0] - norms[1])
                          / norms[0], "leaves": leaves}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
