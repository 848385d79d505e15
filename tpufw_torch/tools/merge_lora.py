"""CLI: fold trained LoRA adapters into the base weights (port of
``tpufw.tools.merge_lora``)::

    python -m tpufw_torch.tools.import_hf HF_DIR --out base/
    TPUFW_INIT_FROM=base/ TPUFW_LORA_RANK=16 TPUFW_CHECKPOINT_DIR=ck \\
        python -m tpufw_torch.workloads.train_llama
    python -m tpufw_torch.tools.merge_lora ck/<step> --out merged/ --alpha 16

``SRC`` is a training checkpoint's step directory (``train.checkpoint``:
``state.pt`` and ``meta.json``; its model state and model config are
used, the step and optimizer state dropped) or a bare-params directory.
The output is bare params (safetensors and ``config.json``) of the model
with ``lora_rank`` 0, which ``TPUFW_PARAMS_CHECKPOINT`` serves and
``tools.import_hf --export`` exports. It prints ``{"out", "n_params"}``.
"""

from __future__ import annotations

import json
import os


def read_lora_state(src: str) -> tuple:
    """(model config, state dict on the CPU) of a checkpoint step
    directory or a bare-params directory."""
    import torch

    from tpufw_torch.train.checkpoint import (
        PARAMS_CONFIG,
        check_identity,
        config_from_dict,
        load_params,
    )

    if os.path.isfile(os.path.join(src, PARAMS_CONFIG)):
        return load_params(src)
    state = torch.load(os.path.join(src, "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True)
    if "model_config" not in state:
        raise ValueError(f"{src}: a checkpoint without its model config")
    cfg = config_from_dict(state["model_config"])
    check_identity(state["config"], cfg, src)
    return cfg, state["model"]


def main(argv=None) -> int:
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(
        prog="tpufw_torch.tools.merge_lora",
        description="LoRA checkpoint -> merged base-model bare params")
    ap.add_argument("src", help="checkpoint step dir or bare-params dir")
    ap.add_argument("--out", required=True, help="merged bare-params dir")
    ap.add_argument("--rank", type=int, default=None,
                    help="the model's lora_rank (default: read from the "
                         "adapters; if given it is checked)")
    ap.add_argument("--alpha", type=float, required=True,
                    help="the model's lora_alpha; required: unlike the rank "
                         "it is not recoverable from the adapters, and a "
                         "wrong value mis-scales every weight")
    args = ap.parse_args(argv)

    from tpufw_torch.models.lora import merge_lora
    from tpufw_torch.train.checkpoint import save_params

    cfg, state = read_lora_state(os.path.abspath(args.src))
    merged = merge_lora(state, rank=args.rank, alpha=args.alpha)
    save_params(os.path.abspath(args.out), merged,
                dataclasses.replace(cfg, lora_rank=0))
    n = sum(t.numel() for t in merged.values())
    print(json.dumps({"out": args.out, "n_params": int(n)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
