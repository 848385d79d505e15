"""CLI: held-out perplexity of weights over a packed corpus (port of
``tpufw.tools.eval_ppl``)::

    python -m tpufw_torch.tools.eval_ppl --model llama3_8b \\
        --params base/ --data corpus \\
        --batch-size 8 --seq-len 2048 --batches 64

``--model``: a preset name, or a run-config YAML (``.yaml``/``.yml``,
``configs.loader``: its preset with the file's model overrides).
``--params``: bare params (``tools.import_hf``'s output); ``--checkpoint``
instead: a training checkpoint directory (its latest step's model
tensors, without the optimizer state). ``--data``: a
``tools.pack_corpus`` prefix, read in order, one epoch. Prints ONE JSON
line with the token-weighted numbers the trainer reports in its loop (the
same ``run_evaluation``). ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import json


def model_config(model: str):
    """``--model``'s config: a run-config YAML's (with its overrides) or a
    preset's, as ``tpufw``'s CLI resolves it."""
    if model.endswith((".yaml", ".yml")):
        from tpufw_torch.configs.loader import load_run_config

        return load_run_config(model).model_cfg
    from tpufw_torch.configs.loader import resolve_model_preset

    return resolve_model_preset(model)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpufw_torch.tools.eval_ppl",
        description="weights + packed corpus -> token-weighted ppl",
    )
    ap.add_argument("--model", required=True,
                    help="model preset or run-config YAML path")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--params", help="bare-params dir")
    src.add_argument("--checkpoint",
                     help="training checkpoint dir (latest step)")
    ap.add_argument("--data", required=True,
                    help="pack_corpus output prefix (.bin/.idx)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=64,
                    help="number of eval batches (0 = whole corpus)")
    ap.add_argument("--loss-chunk-size", type=int, default=512,
                    help="chunked-vocab CE chunk (0 = full logits)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpufw_torch.train import TokenCorpus, Trainer, TrainerConfig
    from tpufw_torch.train.checkpoint import checkpoint_model_state

    model_cfg = model_config(args.model)
    trainer = Trainer(
        model_cfg,
        TrainerConfig(
            batch_size=args.batch_size,
            seq_len=args.seq_len,
            loss_chunk_size=args.loss_chunk_size or None,
        ),
        device=args.device,
    )
    # Forward-only: the model's tensors alone, no optimizer state.
    if args.params:
        state = trainer.restore_params(args.params)
    else:
        state = checkpoint_model_state(args.checkpoint, model_cfg,
                                       trainer.device)
    trainer.assign_model(state)

    data = iter(TokenCorpus(args.data, args.batch_size, args.seq_len,
                            shuffle=False, epochs=1))
    result = trainer.evaluate(data, args.batches or None)
    result["model_params"] = model_cfg.n_params()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
