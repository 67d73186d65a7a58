"""Command-line tools: `python -m neptune_tpu_torch.tools.opt` (neptune-opt-torch)."""
