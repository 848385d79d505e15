"""Command-line tools of the port: corpus packing, HF import and export,
held-out perplexity."""
